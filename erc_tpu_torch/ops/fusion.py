"""Attention/fusion modules from the MMGCN family
(reference: track_mm/mmgcn_models.py:42-161,164-179).

Port of ``erc_tpu.ops.fusion``: ``SimpleAttention``, ``MatchingAttention``
(dot/general/general2/concat) and the ``MMGatedAttention`` tri-modal gated
fusion, as ``nn.Module``s with torch-layout ``Linear`` weights
(``convert.simple_attention_state``, ``matching_attention_state`` and
``mm_gated_attention_state`` carry the flax trees).  MMGCN constructs these
but its executed forward does not call them; DialogueGCN v2's nodal
attention keeps its own copy (``models/dgcnv2.py``).  Kernels are drawn
lecun-normal from an explicit generator, biases zero (flax's ``Dense``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.init import lecun_normal_


def _dense(n_in: int, n_out: int, bias: bool, generator=None, device=None) -> nn.Linear:
    lin = nn.Linear(n_in, n_out, bias=bias, device=device)
    with torch.no_grad():
        lecun_normal_(lin.weight, fan_in=n_in, generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


class SimpleAttention(nn.Module):
    """Scalar-scored attention over memory [B, L, D] (mmgcn_models.py:164-179);
    masked scores take the finite float32-min / 2."""

    def __init__(self, input_dim: int, *, generator=None, device=None):
        super().__init__()
        self.scalar = _dense(input_dim, 1, False, generator, device)

    def forward(self, M: torch.Tensor, mask: Optional[torch.Tensor] = None):
        scale = self.scalar(M)[..., 0]  # [B, L]
        if mask is not None:
            scale = torch.where(mask > 0, scale, torch.finfo(scale.dtype).min / 2)
        alpha = torch.softmax(scale, -1)
        return torch.einsum("bl,bld->bd", alpha, M), alpha


class MatchingAttention(nn.Module):
    """Query-conditioned pooling over memory (mmgcn_models.py:42-95).

    att_type: 'dot' | 'general' | 'general2' | 'concat'.
    M: [B, L, D_mem]; x: [B, D_cand]; mask: [B, L] (used by 'general2').
    """

    def __init__(self, mem_dim: int, cand_dim: int, alpha_dim: Optional[int] = None, att_type: str = "general", *,
                 generator=None, device=None):
        super().__init__()
        self.att_type = att_type
        if att_type in ("general", "general2"):
            self.transform = _dense(cand_dim, mem_dim, att_type == "general2", generator, device)
        elif att_type == "concat":
            width = alpha_dim or mem_dim
            self.transform = _dense(mem_dim + cand_dim, width, False, generator, device)
            self.vector_prod = _dense(width, 1, False, generator, device)
        elif att_type != "dot":
            raise ValueError(att_type)

    def forward(self, M: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if mask is None:
            mask = torch.ones(M.shape[:2], dtype=M.dtype, device=M.device)
        if self.att_type == "dot":
            alpha = torch.softmax(torch.einsum("bd,bld->bl", x, M), -1)
        elif self.att_type == "general":
            alpha = torch.softmax(torch.einsum("bd,bld->bl", self.transform(x), M), -1)
        elif self.att_type == "general2":
            Mm = M * mask[..., None]
            a = torch.tanh(torch.einsum("bd,bld->bl", self.transform(x), Mm) * mask)
            a = torch.softmax(a, -1) * mask
            alpha = a / torch.clamp_min(a.sum(-1, keepdim=True), 1e-10)
        else:
            xx = x[:, None, :].expand(-1, M.shape[1], -1)
            mx = torch.tanh(self.transform(torch.cat([M, xx], -1)))
            alpha = torch.softmax(self.vector_prod(mx)[..., 0], -1)
        return torch.einsum("bl,bld->bd", alpha, M), alpha


class MMGatedAttention(nn.Module):
    """Tri-modal gated fusion (mmgcn_models.py:98-161, att_type='general').

    ``modals`` (a subset of 'atv': audio, text, visual) decides which layers
    exist, as the flax module's first call does; ``forward`` takes the same
    subset.  In training each present input takes dropout (``generator``-
    driven, ``ops.dropout``); the transforms are tanh(Linear) of the present
    modalities, each pair is gated by sigmoid(Linear([x, y, x·y])), and a
    two-modality subset returns its one gated tensor, 'atv' the three
    concatenated."""

    def __init__(self, mem_dim: int, cand_dim: int, dropout: float = 0.5, modals: str = "atv", *,
                 generator=None, device=None):
        super().__init__()
        self.modals = modals
        self.drop_a, self.drop_v, self.drop_l = (Dropout(dropout) for _ in range(3))
        for m, name in (("a", "a"), ("v", "v"), ("t", "l")):
            if m in modals:
                setattr(self, f"transform_{name}", _dense(mem_dim, cand_dim, True, generator, device))
        for pair, name in (("av", "av"), ("at", "al"), ("vt", "vl")):
            if all(m in modals for m in pair):
                setattr(self, f"transform_{name}", _dense(3 * mem_dim, 1, True, generator, device))

    def forward(self, a, v, l, modals: Optional[str] = None):
        modals = self.modals if modals is None else modals
        a = self.drop_a(a) if a is not None else a
        v = self.drop_v(v) if v is not None else v
        l = self.drop_l(l) if l is not None else l  # noqa: E741 (the reference's name)
        ha = torch.tanh(self.transform_a(a)) if "a" in modals else a
        hv = torch.tanh(self.transform_v(v)) if "v" in modals else v
        hl = torch.tanh(self.transform_l(l)) if "t" in modals else l

        outs = []
        if "a" in modals and "v" in modals:
            z = torch.sigmoid(self.transform_av(torch.cat([a, v, a * v], -1)))
            h_av = z * ha + (1 - z) * hv
            if "t" not in modals:
                return h_av
            outs.append(h_av)
        if "a" in modals and "t" in modals:
            z = torch.sigmoid(self.transform_al(torch.cat([a, l, a * l], -1)))
            h_al = z * ha + (1 - z) * hl
            if "v" not in modals:
                return h_al
            outs.append(h_al)
        if "v" in modals and "t" in modals:
            z = torch.sigmoid(self.transform_vl(torch.cat([v, l, v * l], -1)))
            h_vl = z * hv + (1 - z) * hl
            if "a" not in modals:
                return h_vl
            outs.append(h_vl)
        return torch.cat(outs, -1)
