"""torch-math GRU cells.

Port of ``erc_tpu.ops.rnn.gru_cell, gru_cell_proj``: gates are stacked r, z,
n along the last axis, with separate input and hidden biases, as
``torch.nn.GRUCell`` has them.  The recurrent layers' initialiser
(``_uniform_init``) is ``ops.init.uniform_``.
"""

from __future__ import annotations

import torch


def gru_cell_proj(x_proj: torch.Tensor, h_proj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """GRU step with both projections precomputed: x_proj = x·W_ihᵀ + b_ih and
    h_proj = h·W_hhᵀ + b_hh, each [..., 3H]."""
    xr, xz, xn = x_proj.chunk(3, -1)
    hr, hz, hn = h_proj.chunk(3, -1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_cell(x_proj: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """One GRU step; x_proj = x·W_ihᵀ + b_ih, [..., 3H]."""
    return gru_cell_proj(x_proj, h @ w_hh.T + b_hh, h)
