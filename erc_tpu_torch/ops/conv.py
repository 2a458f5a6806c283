"""Convolutions over words as matrix products.

``conv1d_gemm(x, convs)`` computes the VALID, stride-1 ``nn.Conv1d`` layers
of the TextCNNs (DialogueGCN v2's token track, MMIN's text encoder) over
x [N, W, C]: one matrix product of x with every tap of every filter side by
side, then for each convolution the sum of its K tap planes shifted by
0 .. K − 1 words, and the bias.  On the card that is cuBLAS, which gives the
same sums on every call, eager or replayed in a CUDA graph: cuDNN's
convolution took another backward plan when captured than when run
eagerly, and its default backward algorithms add with atomics.  The layers
keep their ``nn.Conv1d`` parameters ([F, C, K]), so checkpoints and the
converters from JAX stay as they are.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn


def conv1d_gemm(x: torch.Tensor, convs: Sequence[nn.Conv1d]) -> List[torch.Tensor]:
    """x [N, W, C] → for each convolution (VALID, stride 1, K ≤ W) its output
    [N, W − K + 1, F]."""
    taps = torch.cat([c.weight.permute(1, 2, 0).reshape(c.in_channels, -1) for c in convs], 1)  # [C, Σ K·F]
    y = x @ taps  # [N, W, Σ K·F]: tap k of filter f of a convolution at column off + k·F + f
    W, outs, off = x.shape[1], [], 0
    for c in convs:
        F, K = c.out_channels, c.kernel_size[0]
        Wo = W - K + 1
        out = y[:, :Wo, off:off + F]
        for k in range(1, K):
            out = out + y[:, k:k + Wo, off + k * F:off + (k + 1) * F]
        outs.append(out + c.bias)
        off += K * F
    return outs
