"""The X3D video backbone (reference: mmaction/models/backbones/x3d.py).

Port of ``erc_tpu.preprocess.x3d``, NCDHW: a (1, 3, 3) spatial stem and a
(5, 1, 1) channelwise temporal stem (``groups`` = the base width), four
stages of X3D bottlenecks — 1×1×1 expand, 3×3×3 *channelwise* convolution
(``groups`` = planes), squeeze-excitation on even-indexed blocks
(``se_style="half"``; its two 1×1×1 convolutions have biases), swish, 1×1×1
project, residual — then a 1×1×1 ``conv5`` and a pool over T, H and W.  The
default expansion is X3D-M's (γ_w = 1, γ_b = 2.25, γ_d = 2.2 → stages [3,
5, 11, 7], feature 432), as the checkpoints the reference extracts with.

Modules carry mmaction's names (``conv1_s.conv``, ``conv1_t.conv/.bn``,
``layerN.i.conv1.conv/.bn``, ``se_module.fc1``, ``downsample.conv/.bn``,
``conv5.conv/.bn``), so ``port_torch_x3d`` loads an mmaction ``state_dict``
by stripping its ``backbone.`` prefix.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import torch
from torch import nn

from erc_tpu_torch.preprocess.video import load_backbone


def _round_width(width, multiplier, min_width=8, divisor=8):
    if not multiplier:
        return int(width)
    width *= multiplier
    min_width = min_width or divisor
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


def _round_repeats(repeats, multiplier):
    if not multiplier:
        return int(repeats)
    return int(math.ceil(multiplier * repeats))


class ConvBN(nn.Module):
    """mmaction's ConvModule: ``conv`` and, unless ``norm`` is off, ``bn``."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0, groups: int = 1, norm: bool = True):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel, stride, padding, groups=groups, bias=False)
        self.bn = nn.BatchNorm3d(cout) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return x if self.bn is None else self.bn(x)


class SEModule(nn.Module):
    def __init__(self, channels: int, reduction: float):
        super().__init__()
        bottleneck = _round_width(channels, reduction)
        self.fc1 = nn.Conv3d(channels, bottleneck, 1)
        self.fc2 = nn.Conv3d(bottleneck, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class BlockX3D(nn.Module):
    def __init__(self, inplanes: int, planes: int, outplanes: int, spatial_stride: int = 1, use_se: bool = False,
                 se_ratio: float = 1 / 16):
        super().__init__()
        s = spatial_stride
        self.conv1 = ConvBN(inplanes, planes, 1)
        self.conv2 = ConvBN(planes, planes, 3, (1, s, s), 1, groups=planes)
        self.se_module = SEModule(planes, se_ratio) if use_se else None
        self.conv3 = ConvBN(planes, outplanes, 1)
        self.downsample = (ConvBN(inplanes, outplanes, 1, (1, s, s)) if s != 1 or inplanes != outplanes
                           else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.conv1(x))
        out = self.conv2(out)
        if self.se_module is not None:
            out = self.se_module(out)
        out = self.conv3(swish(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class X3D(nn.Module):
    """[B, 3, T, H, W] → pooled feature [B, feat_dim]."""

    def __init__(self, gamma_w: float = 1.0, gamma_b: float = 2.25, gamma_d: float = 2.2, base_channels: int = 24,
                 stage_blocks: Sequence[int] = (1, 2, 5, 3), spatial_strides: Sequence[int] = (2, 2, 2, 2),
                 se_style: str = "half", se_ratio: float = 1 / 16):
        super().__init__()
        self.gamma_w, self.gamma_b, self.gamma_d = gamma_w, gamma_b, gamma_d
        self.base_channels, self.stage_blocks = base_channels, tuple(stage_blocks)
        base = _round_width(base_channels, gamma_w)
        self.conv1_s = ConvBN(3, base, (1, 3, 3), (1, 2, 2), (0, 1, 1), norm=False)
        self.conv1_t = ConvBN(base, base, (5, 1, 1), 1, (2, 0, 0), groups=base)
        layer_inplanes = base
        for i, nb in enumerate(self.blocks):
            inplanes = base * 2 ** i
            planes = int(inplanes * gamma_b)
            setattr(self, f"layer{i + 1}", nn.Sequential(*[
                BlockX3D(layer_inplanes if b == 0 else inplanes, planes, inplanes,
                         spatial_stride=spatial_strides[i] if b == 0 else 1,
                         use_se=se_style == "all" or b % 2 == 0, se_ratio=se_ratio)
                for b in range(nb)]))
            layer_inplanes = inplanes
        self.conv5 = ConvBN(layer_inplanes, self.feat_dim, 1)

    @property
    def blocks(self) -> list:
        return [_round_repeats(b, self.gamma_d) for b in self.stage_blocks]

    @property
    def feat_dim(self) -> int:
        base = _round_width(self.base_channels, self.gamma_w)
        return int(base * 2 ** (len(self.stage_blocks) - 1) * self.gamma_b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv1_t(self.conv1_s(x)))
        for i in range(len(self.stage_blocks)):
            x = getattr(self, f"layer{i + 1}")(x)
        return torch.relu(self.conv5(x)).mean(dim=(2, 3, 4))  # global spatio-temporal pool


def port_torch_x3d(state_dict: Mapping, prefix: str = "backbone.", model: X3D = None) -> Dict[str, torch.Tensor]:
    """An mmaction X3D ``state_dict`` → the state dict of the port's ``X3D``
    (``model``'s configuration, X3D-M by default)."""
    if model is None:
        with torch.device("meta"):
            model = X3D()
    return load_backbone(model, state_dict, prefix)
