"""Parameter initialisers with the JAX package's conventions, drawn from an
explicit ``torch.Generator``.

Fan-in and fan-out follow flax's ``variance_scaling``: the last axis is the
output, the one before it the input, and any leading axes multiply both.
Values are drawn on the CPU and copied to the parameter's device, so one
seed gives the same weights on every device.
"""

from __future__ import annotations

import math

import torch

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _fans(shape):
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def _fill(t: torch.Tensor, draw) -> torch.Tensor:
    cpu = torch.empty(t.shape, dtype=t.dtype)
    draw(cpu)
    return t.copy_(cpu)


def xavier_uniform_(t: torch.Tensor, generator=None) -> torch.Tensor:
    fan_in, fan_out = _fans(tuple(t.shape))
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return _fill(t, lambda c: torch.nn.init.uniform_(c, -bound, bound, generator=generator))


def uniform_(t: torch.Tensor, scale: float, generator=None) -> torch.Tensor:
    """U(-scale, scale): the JAX package's ``ops.rnn._uniform_init(scale)``."""
    return _fill(t, lambda c: torch.nn.init.uniform_(c, -scale, scale, generator=generator))


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    return _fill(
        t, lambda c: torch.nn.init.trunc_normal_(c, 0.0, std, -2 * std, 2 * std, generator=generator)
    )
