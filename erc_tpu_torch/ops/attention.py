"""Masked softmax, masked multi-head attention and the post-LN transformer
encoder.

Port of ``erc_tpu.ops.attention``.  The attention is written out with
matmuls and a softmax, masking keys with ``where(mask, scores, NEG_INF)``:
a dialogue that is all padding (the engine pads every request to its batch
size) then gets a uniform softmax and finite outputs, as in the JAX module.
``nn.MultiheadAttention``'s key-padding path would return NaN there.
Dropout draws from the generator the trainer sets (``ops.dropout``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.init import lecun_normal_, xavier_uniform_

NEG_INF = -1e30


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dim: int = -1,
                   mode: str = "subtract") -> torch.Tensor:
    """Softmax over ``dim`` with the entries where ``mask`` is 0 left out.

    mode='subtract' adds ``(1 - mask) · NEG_INF`` to the scores, as the
    reference does; mode='where' replaces them with float32-min / 2 and
    zeroes them after, and a row with no valid entry (an all-padding
    dialogue) gives zeros.
    """
    if mode == "subtract":
        return torch.softmax(scores + (1.0 - mask) * NEG_INF, dim=dim)
    if mode != "where":
        raise ValueError(f"unknown masked_softmax mode {mode!r}")
    valid = mask > 0
    big_neg = torch.finfo(scores.dtype).min / 2
    out = torch.softmax(torch.where(valid, scores, torch.full_like(scores, big_neg)), dim=dim)
    any_valid = valid.any(dim=dim, keepdim=True)
    return torch.where(valid & any_valid, out, torch.zeros_like(out))


class Linear(nn.Linear):
    """nn.Linear with the JAX package's Dense init (lecun-normal kernel,
    zero bias) drawn from an explicit generator."""

    def __init__(self, in_features, out_features, *, generator=None, device=None):
        super().__init__(in_features, out_features, device=device)
        with torch.no_grad():
            lecun_normal_(self.weight, fan_in=in_features, generator=generator)
            self.bias.zero_()


class MultiheadAttention(nn.Module):
    """torch-layout packed in_proj [3E, E] and out_proj [E, E]."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, *,
                 generator=None, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by num_heads {num_heads}")
        E = embed_dim
        self.embed_dim, self.num_heads = E, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * E, E, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * E, device=device))
        self.out_proj_weight = nn.Parameter(torch.empty(E, E, device=device))
        self.out_proj_bias = nn.Parameter(torch.zeros(E, device=device))
        with torch.no_grad():
            xavier_uniform_(self.in_proj_weight, generator=generator)
            xavier_uniform_(self.out_proj_weight, generator=generator)
        self.dropout = Dropout(dropout)

    def forward(self, q, k, v, key_padding_mask: Optional[torch.Tensor] = None):
        """q: [B, Lq, E]; k, v: [B, Lk, E]; key_padding_mask: [B, Lk], 1 = valid."""
        E, H = self.embed_dim, self.num_heads
        Dh = E // H
        wq, wk, wv = self.in_proj_weight.chunk(3, 0)
        bq, bk, bv = self.in_proj_bias.chunk(3, 0)
        B, Lq, _ = q.shape
        Lk = k.shape[1]

        def heads(x, w, b, L):
            return F.linear(x, w, b).reshape(B, L, H, Dh).transpose(1, 2)

        qh = heads(q, wq, bq, Lq) / math.sqrt(Dh)
        kh = heads(k, wk, bk, Lk)
        vh = heads(v, wv, bv, Lk)
        scores = qh @ kh.transpose(-1, -2)  # [B, H, Lq, Lk]
        if key_padding_mask is not None:
            valid = key_padding_mask[:, None, None, :] > 0
            scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
        attn = self.dropout(torch.softmax(scores, -1))
        out = (attn @ vh).transpose(1, 2).reshape(B, Lq, E)
        return F.linear(out, self.out_proj_weight, self.out_proj_bias)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with a relu feed-forward (torch defaults)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.self_attn = MultiheadAttention(d_model, nhead, dropout, **kw)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.dropout = Dropout(dropout)

    def forward(self, x, key_padding_mask=None):
        sa = self.self_attn(x, x, x, key_padding_mask)
        x = self.norm1(x + self.dropout(sa))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(x))))
        return self.norm2(x + self.dropout(ff))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, *, generator=None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                                    generator=generator, device=device)
            for _ in range(num_layers)
        )

    def forward(self, x, key_padding_mask=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask)
        return x
