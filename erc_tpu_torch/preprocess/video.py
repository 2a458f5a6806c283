"""Video features on the card: the TSN ResNet-50 and the extractors.

Port of ``erc_tpu.preprocess.video`` (the reference's mmaction2 TSN-R50 /
X3D inference paths, preprocess/video/extractor.py:170-227):

- ``ResNet50``: the torchvision/mmaction ResNet-50 (2048-d pooled
  features), NCHW, its modules named as torchvision's (``conv1``, ``bn1``,
  ``layerN.i.convK``, ``downsample.0/.1``), so an mmaction ``state_dict``
  loads by stripping its ``backbone.`` prefix (``port_torch_resnet``).
  ``n_segment > 0`` shifts the residual branch's input of every block over
  the segment axis (TSM ``blockres``; the identity path is not shifted);
- ``TSNExtractor``: TSN segment sampling, the backbone, average consensus
  (mmaction's recognizer2d with ``feature_extraction=True``);
  ``extract_batch`` takes uint8 clips, which cross to the card as uint8 and
  are normalised there; ``X3DExtractor`` the same over ``x3d.X3D``;
- ``crop_speaker_half``: the IEMOCAP half-frame speaker crop.

BatchNorm runs from its running statistics (eval mode), ``MaxPool2d(3, 2,
1)`` pads with -inf as flax's ``max_pool`` does, and every extractor call
runs under ``full_fp32()``.  Random weights come from a ``torch.Generator``
(``init_weights``: flax's initialisers, lecun-normal convolutions and
dense kernels, zero biases, unit BN scales).  Decoding is not here: any
[T, H, W, 3] uint8 array works; ``preprocess_frames`` resizes with ``cv2``
where it imports, else centre-crops and strides, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from erc_tpu_torch.core.device import DeviceSpec, resolve_device
from erc_tpu_torch.ops.init import lecun_normal_
from erc_tpu_torch.preprocess import full_fp32

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def temporal_shift(x: torch.Tensor, n_segment: int, n_div: int = 8) -> torch.Tensor:
    """TSM's zero-padded channel-fold shift over the segment axis
    (reference preprocess/video/tsm_model.py:42-59): the first C/n_div
    channels move one segment earlier, the next C/n_div one segment later,
    the rest stay.  x: [N·T, C, H, W] (NCHW), T = n_segment."""
    nt, c, h, w = x.shape
    x = x.reshape(nt // n_segment, n_segment, c, h, w)
    fold = c // n_div
    zeros = x.new_zeros((x.shape[0], 1, fold, h, w))
    left = torch.cat([x[:, 1:, :fold], zeros], 1)
    right = torch.cat([zeros, x[:, :-1, fold: 2 * fold]], 1)
    return torch.cat([left, right, x[:, :, 2 * fold:]], 2).reshape(nt, c, h, w)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (stride on conv2); ``n_segment > 0`` shifts
    the residual branch's input (TSM blockres, tsm_model.py:135-147)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 n_segment: int = 0, n_div: int = 8):
        super().__init__()
        self.n_segment, self.n_div = n_segment, n_div
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                                         nn.BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = temporal_shift(x, self.n_segment, self.n_div) if self.n_segment else x
        out = self.relu(self.bn1(self.conv1(h)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


class ResNet50(nn.Module):
    """torchvision/mmaction-layout ResNet-50 feature extractor: [N, 3, H, W]
    → [N, 2048].  ``n_segment > 0`` inserts the TSM shift at every block
    (make_temporal_shift place='blockres', n_round=1 for R50 since layer3
    has 6 < 23 blocks; tsm_model.py:112-155)."""

    STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))

    def __init__(self, n_segment: int = 0, n_div: int = 8):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for li, (planes, blocks, stride) in enumerate(self.STAGES, start=1):
            layer = [Bottleneck(inplanes, planes, stride, True, n_segment, n_div)]
            inplanes = planes * 4
            layer += [Bottleneck(inplanes, planes, 1, False, n_segment, n_div) for _ in range(1, blocks)]
            setattr(self, f"layer{li}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))  # global average pool


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisers, drawn from ``generator`` in module order:
    convolutions and linear kernels lecun-normal over their fan-in, biases 0,
    BatchNorm scale 1, shift 0, running mean 0, running variance 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                lecun_normal_(m.weight, math.prod(m.weight.shape[1:]), generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
    return model


def load_backbone(model: nn.Module, state_dict: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``model``'s state dict from a checkpoint's ``state_dict`` whose keys
    carry ``prefix`` (mmaction: ``backbone.``); other keys (the head) are left
    out, a missing ``num_batches_tracked`` is 0, any other missing key
    raises ``KeyError``."""
    out = {}
    for k, v in model.state_dict().items():
        src = state_dict.get(prefix + k)
        if src is None:
            if k.endswith("num_batches_tracked"):
                out[k] = torch.zeros((), dtype=torch.long)
                continue
            raise KeyError(f"checkpoint has no {prefix + k!r} (keys: {sorted(state_dict)[:5]}…)")
        out[k] = torch.as_tensor(np.asarray(src.detach().cpu() if hasattr(src, "detach") else src)).to(v.dtype)
    return out


def port_torch_resnet(state_dict: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A torchvision/mmaction ResNet-50 ``state_dict`` (torchvision names,
    ``downsample.0/.1``, with an optional prefix, mmaction's ``backbone.``)
    → the state dict of the port's ``ResNet50``."""
    with torch.device("meta"):
        model = ResNet50()
    return load_backbone(model, state_dict, prefix)


def _weights(model: nn.Module, state_dict, seed: int, device: torch.device) -> nn.Module:
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(int(seed)))
    else:
        model.load_state_dict(state_dict)
    return model.to(device).eval().requires_grad_(False)


def _load_checkpoint(path: str) -> Mapping:
    sd = torch.load(path, map_location="cpu")
    return sd.get("state_dict", sd)


def resize_normalize(frames: np.ndarray, crop_size: int) -> np.ndarray:
    """[T, H, W, 3] uint8 → resized, normalised [T, S, S, 3] float32:
    ``cv2.resize`` where cv2 imports, else a centre crop and a stride (the
    JAX package's two branches)."""
    try:
        import cv2

        frames = np.stack([cv2.resize(f, (crop_size, crop_size)) for f in frames])
    except ImportError:
        h, w = frames.shape[1:3]
        s = min(h, w)
        y0, x0 = (h - s) // 2, (w - s) // 2
        frames = frames[:, y0: y0 + s, x0: x0 + s]
        step = max(s // crop_size, 1)
        frames = frames[:, ::step, ::step][:, :crop_size, :crop_size]
    return (frames.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


class _Extractor:
    """What TSN and X3D share: the model on its device and the uint8 batch
    normalised there."""

    def _setup(self, model: nn.Module, state_dict, seed: int, device: DeviceSpec) -> None:
        self.device = resolve_device(device)
        self.model = _weights(model, state_dict, seed, self.device)
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)

    def _normalised(self, clips: np.ndarray) -> torch.Tensor:
        """[B, T, S, S, 3] uint8 → float32 on the card, normalised there
        (the host link carries uint8: a quarter of float32's bytes)."""
        x = torch.from_numpy(np.ascontiguousarray(clips, np.uint8)).to(self.device)
        return (x.float() - self._mean) / self._std

    def preprocess_frames(self, frames: np.ndarray) -> np.ndarray:
        """[T, H, W, 3] uint8 → resized, normalised [T, S, S, 3] float32."""
        return resize_normalize(frames, self.crop_size)


class TSNExtractor(_Extractor):
    """TSN feature extraction: sample segments, the ResNet-50, average
    consensus (mmaction recognizer2d with feature_extraction=True).
    ``state_dict`` is the port's ``ResNet50``'s; without it the weights are
    drawn from ``torch.Generator().manual_seed(seed)``."""

    def __init__(self, state_dict=None, n_segments: int = 8, crop_size: int = 224, device: DeviceSpec = None,
                 seed: int = 0):
        self.n_segments = n_segments
        self.crop_size = crop_size
        self._setup(ResNet50(), state_dict, seed, device)

    @classmethod
    def from_torch_checkpoint(cls, path: str, prefix: str = "backbone.", **kw) -> "TSNExtractor":
        """An mmaction TSN-R50 checkpoint (``state_dict`` under the file's
        ``state_dict`` key, or the file itself), its ``prefix`` stripped."""
        return cls(port_torch_resnet(_load_checkpoint(path), prefix), **kw)

    def extract_batch(self, clips: np.ndarray) -> np.ndarray:
        """[B, T, S, S, 3] uint8 (already segment-sampled and resized) →
        [B, 2048] TSN consensus features, normalised on the card."""
        b, t = clips.shape[:2]
        with torch.inference_mode(), full_fp32():
            x = self._normalised(clips).permute(0, 1, 4, 2, 3).reshape(b * t, 3, *clips.shape[2:4])
            return self.model(x).reshape(b, t, -1).mean(1).cpu().numpy()

    def sample_segments(self, n_frames: int) -> np.ndarray:
        """TSN uniform segment centres (test mode)."""
        seg = max(n_frames // self.n_segments, 1)
        idx = np.arange(self.n_segments) * seg + seg // 2
        return np.minimum(idx, n_frames - 1)

    def extract(self, frames: np.ndarray) -> np.ndarray:
        """[T, H, W, 3] uint8 clip → [2048] TSN consensus feature."""
        x = self.preprocess_frames(frames[self.sample_segments(len(frames))])
        with torch.inference_mode(), full_fp32():
            x = torch.from_numpy(x).to(self.device).permute(0, 3, 1, 2)
            return self.model(x).mean(0).cpu().numpy()


class X3DExtractor(_Extractor):
    """X3D clip features (mmaction recognizer3d feature_extraction path):
    uniform temporal sampling → backbone → pooled [feat_dim].  ``model`` is
    an ``x3d.X3D`` (X3D-M by default)."""

    def __init__(self, state_dict=None, n_frames: int = 16, crop_size: int = 224, model=None,
                 device: DeviceSpec = None, seed: int = 0):
        from erc_tpu_torch.preprocess.x3d import X3D

        self.n_frames = n_frames
        self.crop_size = crop_size
        self._setup(model if model is not None else X3D(), state_dict, seed, device)

    @classmethod
    def from_torch_checkpoint(cls, path: str, prefix: str = "backbone.", model=None, **kw) -> "X3DExtractor":
        from erc_tpu_torch.preprocess.x3d import X3D, port_torch_x3d

        model = model if model is not None else X3D()
        return cls(port_torch_x3d(_load_checkpoint(path), prefix, model), model=model, **kw)

    def extract_batch(self, clips: np.ndarray) -> np.ndarray:
        """[B, T, S, S, 3] uint8 (sampled and resized) → [B, feat_dim],
        normalised on the card (uint8 host link, like TSN's batch path)."""
        with torch.inference_mode(), full_fp32():
            return self.model(self._normalised(clips).permute(0, 4, 1, 2, 3)).cpu().numpy()

    def extract(self, frames: np.ndarray) -> np.ndarray:
        """[T, H, W, 3] uint8 clip → [feat_dim] feature."""
        idx = np.linspace(0, len(frames) - 1, self.n_frames).round().astype(int)
        clip = self.preprocess_frames(frames[idx])
        with torch.inference_mode(), full_fp32():
            x = torch.from_numpy(clip).to(self.device).permute(3, 0, 1, 2)[None]
            return self.model(x)[0].cpu().numpy()


def crop_speaker_half(frame: np.ndarray, speaker: str) -> np.ndarray:
    """IEMOCAP half-frame speaker crop (extractor.py:196-208):
    rows 120:365; left half for 'M', right half for 'F'."""
    h, w = frame.shape[:2]
    top, bottom = min(120, h), min(365, h)
    if speaker == "M":
        return frame[top:bottom, : w // 2]
    return frame[top:bottom, w // 2:]
