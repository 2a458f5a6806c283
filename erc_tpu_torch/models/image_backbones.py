"""Image backbones for the legacy semi-supervised CIFAR/STL track.

Port of ``erc_tpu.models.image_backbones`` (reference models/wideresnet.py:
18-154 and models/resnet_cifar.py:10-141): ``WideResnet`` with pre-activation
blocks, the CIFAR-stem ``ResNetCifar`` with ``BasicBlock`` / ``Bottleneck``,
and ``resnet18``, ``resnet50`` and ``wideresnet_28_2``.  Features are
returned after global average pooling (the heads live in the strategies).

Layout and names are torch's: NCHW images, OIHW kernels, each stage an
``nn.Sequential`` (``layer1.0.conv1`` for the flax ``layer1_0/conv1``);
``convert.wideresnet_state`` / ``resnet_cifar_state`` carry the flax trees.

The batch norms follow flax's ``BatchNorm``, not ``nn.BatchNorm2d``: a train
step normalises by the biased batch variance (flax's fast form,
max(E[x²] − E[x]², 0)) and the running variance tracks that same biased
variance, with ``running = m·running + (1 − m)·batch`` for m = 1 −
``torch_momentum``.  Kernels are drawn from flax's ``kaiming_normal`` (a
truncated normal, fan-in, scale 2) from an explicit generator.  Dropout
(``WideResnet``'s ``drop_rate``) draws from ``ops.dropout``'s generator.
On the card every convolution runs in full float32, forward and backward,
whatever cuDNN's TF32 flag says (``ops.rnn.cudnn_full_fp32``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.init import kaiming_normal_
from erc_tpu_torch.ops.rnn import _backward_in_full_fp32, cudnn_full_fp32


class Conv2d(nn.Conv2d):
    """A bias-free ``k × k`` convolution with 'same' padding k // 2, flax's
    ``kaiming_normal`` kernel, and cuDNN in full float32 on the card (the
    forward within its block, the backward through hooks on its node)."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1, *, generator=None, device=None):
        super().__init__(c_in, c_out, k, stride=stride, padding=k // 2, bias=False, device=device)
        with torch.no_grad():
            kaiming_normal_(self.weight, fan_in=c_in * k * k, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return super().forward(x)
        conv = torch.backends.cudnn.conv
        with cudnn_full_fp32(conv):
            y = super().forward(x)
        if y.requires_grad:
            _backward_in_full_fp32(y, conv, "ConvolutionBackward")
        return y


class BatchNorm2d(nn.Module):
    """flax ``BatchNorm`` over NCHW channels with torch's ``momentum`` meaning:
    the batch's biased statistics normalise in training and update the
    running mean and (biased) variance; eval normalises by the running ones."""

    def __init__(self, features: int, torch_momentum: float = 0.1, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.torch_momentum, self.eps = torch_momentum, eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean((0, 2, 3))
            var = torch.clamp_min((x * x).mean((0, 2, 3)) - mean * mean, 0.0)
            m = 1.0 - self.torch_momentum  # flax's momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * inv[:, None, None] + self.bias[:, None, None]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class BasicBlockPreAct(nn.Module):
    """Pre-activation wide-resnet block (wideresnet.py:18-51): bn→lrelu→
    conv→bn→lrelu→[dropout]→conv, the shortcut taken from the pre-activation
    ``act1`` when ``pre_res_act`` (the first block of stage 1), through a 1×1
    ``downsample`` where the width or the stride changes."""

    def __init__(self, in_chan: int, out_chan: int, stride: int = 1, drop_rate: float = 0.0,
                 pre_res_act: bool = False, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.pre_res_act = pre_res_act
        self.bn1 = BatchNorm2d(in_chan, 0.001, device=device)
        self.conv1 = Conv2d(in_chan, out_chan, 3, stride, **kw)
        self.bn2 = BatchNorm2d(out_chan, 0.001, device=device)
        self.dropout = Dropout(drop_rate) if drop_rate > 0 else None
        self.conv2 = Conv2d(out_chan, out_chan, 3, 1, **kw)
        self.downsample = Conv2d(in_chan, out_chan, 1, stride, **kw) if in_chan != out_chan or stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act1 = _lrelu(self.bn1(x))
        r = _lrelu(self.bn2(self.conv1(act1)))
        if self.dropout is not None:
            r = self.dropout(r)
        r = self.conv2(r)
        shortcut = act1 if self.pre_res_act else x
        if self.downsample is not None:
            shortcut = self.downsample(shortcut)
        return shortcut + r


class WideResnet(nn.Module):
    """WRN-n-k (wideresnet.py:67-154): conv → 3 stages of (n−4)/6 pre-act
    blocks at widths 16k/32k/64k → bn → lrelu → global avg pool.
    feature_dim = 64·k."""

    def __init__(self, k: int = 2, n: int = 28, drop_rate: float = 0.0, *, generator=None, device=None):
        super().__init__()
        if (n - 4) % 6:
            raise ValueError(f"WRN depth n={n}: n - 4 must divide by 6")
        kw = dict(generator=generator, device=device)
        self.k = k
        bnum = (n - 4) // 6
        widths = [16] + [k * 16 * (2 ** i) for i in range(3)]
        self.conv1 = Conv2d(3, widths[0], 3, 1, **kw)
        c_in = widths[0]
        for stage, (w, stride) in enumerate(zip(widths[1:], (1, 2, 2))):
            blocks = []
            for b in range(bnum):
                blocks.append(BasicBlockPreAct(c_in, w, stride if b == 0 else 1, drop_rate,
                                               pre_res_act=(stage == 0 and b == 0), **kw))
                c_in = w
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.bn_last = BatchNorm2d(c_in, 0.001, device=device)

    @property
    def feature_dim(self) -> int:
        return 64 * self.k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] → features [B, 64·k]."""
        h = self.layer3(self.layer2(self.layer1(self.conv1(x))))
        return _lrelu(self.bn_last(h)).mean((2, 3))


class BasicBlock(nn.Module):
    """Post-activation CIFAR block (resnet_cifar.py:10-40)."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = Conv2d(in_planes, planes, 3, stride, **kw)
        self.bn1 = BatchNorm2d(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, 1, **kw)
        self.bn2 = BatchNorm2d(planes, device=device)
        self.conv_sc = self.bn_sc = None
        if stride != 1 or in_planes != planes:
            self.conv_sc = Conv2d(in_planes, planes, 1, stride, **kw)
            self.bn_sc = BatchNorm2d(planes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        sc = x if self.conv_sc is None else self.bn_sc(self.conv_sc(x))
        return F.relu(out + sc)


class Bottleneck(nn.Module):
    """Bottleneck block, expansion 4 (resnet_cifar.py:43-76)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = Conv2d(in_planes, planes, 1, 1, **kw)
        self.bn1 = BatchNorm2d(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, stride, **kw)
        self.bn2 = BatchNorm2d(planes, device=device)
        self.conv3 = Conv2d(planes, 4 * planes, 1, 1, **kw)
        self.bn3 = BatchNorm2d(4 * planes, device=device)
        self.conv_sc = self.bn_sc = None
        if stride != 1 or in_planes != 4 * planes:
            self.conv_sc = Conv2d(in_planes, 4 * planes, 1, stride, **kw)
            self.bn_sc = BatchNorm2d(4 * planes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = x if self.conv_sc is None else self.bn_sc(self.conv_sc(x))
        return F.relu(out + sc)


class ResNetCifar(nn.Module):
    """CIFAR-stem ResNet (3×3 stem, no maxpool; resnet_cifar.py:79-141)."""

    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2), bottleneck: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.bottleneck = bottleneck
        self.conv1 = Conv2d(3, 64, 3, 1, **kw)
        self.bn1 = BatchNorm2d(64, device=device)
        block = Bottleneck if bottleneck else BasicBlock
        c_in = 64
        for stage, (planes, nb) in enumerate(zip((64, 128, 256, 512), num_blocks)):
            blocks = []
            for b in range(nb):
                blocks.append(block(c_in, planes, 1 if stage == 0 or b > 0 else 2, **kw))
                c_in = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(num_blocks)

    @property
    def feature_dim(self) -> int:
        return 2048 if self.bottleneck else 512

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] → features [B, 512] (2048 with bottlenecks)."""
        h = F.relu(self.bn1(self.conv1(x)))
        for stage in range(self.n_stages):
            h = getattr(self, f"layer{stage + 1}")(h)
        return h.mean((2, 3))


def resnet18(**kw) -> ResNetCifar:
    return ResNetCifar((2, 2, 2, 2), bottleneck=False, **kw)


def resnet50(**kw) -> ResNetCifar:
    return ResNetCifar((3, 4, 6, 3), bottleneck=True, **kw)


def wideresnet_28_2(**kw) -> WideResnet:
    return WideResnet(k=2, n=28, **kw)
