"""Dropout whose mask comes from a generator the caller owns.

flax's ``nn.Dropout`` semantics: in training, keep each element with
probability 1 − p and scale the kept ones by 1 / (1 − p).  The mask is drawn
from ``generator`` when one is set (the trainer sets a device generator
seeded from ``--seed``, ``core.seed.RngPool.torch_generator``), else from
torch's global RNG.  Its stream is not JAX's, so parity tests run at p = 0.
"""

from __future__ import annotations

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.generator)
        return x * keep / (1.0 - self.p)

    def masks(self, shape, like: torch.Tensor):
        """Masks for ``shape`` drawn ahead of their use: keep / (1 − p) where
        an element is kept, else 0, in ``like``'s dtype and on its device; None
        where dropout is off.  A checkpointed region takes its masks as inputs,
        since its recompute would draw new ones from ``generator``
        (``torch.utils.checkpoint`` restores only the default generators)."""
        if not self.training or self.p == 0.0:
            return None
        keep = torch.empty(shape, dtype=like.dtype, device=like.device)
        return keep.bernoulli_(1.0 - self.p, generator=self.generator) / (1.0 - self.p)

    def extra_repr(self) -> str:
        return f"p={self.p}"
