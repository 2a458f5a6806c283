"""Masked batch normalisation.

Port of ``erc_tpu.ops.norm.MaskedBatchNorm``: a batch norm whose statistics
are taken over valid positions only (the reference normalises the flat
list of valid nodes).  Biased variance normalises the batch; the running
variance tracks the *unbiased* one, as torch's BatchNorm does.  The output
is re-masked.  ``self.training`` selects batch statistics.

Under a process group the statistics are the global batch's, as in the JAX
package, whose one program sees every row: the count, Σx and Σ(x − mean)²
are summed over ranks (``parallel.mesh.global_sum``, whose backward sums over
ranks too, so the gradient is the global batch's), and the running
statistics come out the same on every rank.
"""

from __future__ import annotations

import torch
from torch import nn

from erc_tpu_torch.parallel import mesh


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: [B, L, F]; mask: [B, L] (1 = valid)."""
        m = mask[..., None].to(x.dtype)
        if self.training:
            n = mesh.global_sum(m.sum()).clamp(min=1.0)
            mean = mesh.global_sum((x * m).sum((0, 1))) / n
            var = mesh.global_sum((((x - mean) ** 2) * m).sum((0, 1))) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
        return y * m
