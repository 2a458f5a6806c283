"""Banded (window-exact) graph layers built on the band kernels K1/K2.

Port of ``erc_tpu.ops.gnn_banded``.  Equal to the dense layers of
``ops.gnn`` on windowed graphs, but message passing touches only the
K = wp+wf+1 diagonal band: a speaker-factored weight transform (one dense
product) and 2S banded gather-sums.  The relation factorisation
rel(u,v) = 2·(spk_u·S + spk_v) + 1[u≥v] reduces the per-edge weight select
to a per-(source speaker, direction) transform gathered by target speaker.

``BandedRGCN``, ``BandedTransformerConv`` and ``BandedGraphConv`` subclass
their dense counterparts: same parameters, same state-dict keys, banded
``forward``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from erc_tpu_torch.ops.gnn import DenseGraphConv, DenseRGCN, DenseTransformerConv
from erc_tpu_torch.ops.kernels.banded import band_offsets, banded_dot, banded_gather_sum


def _tap_valid(mask: torch.Tensor, offsets) -> torch.Tensor:
    """valid[b, v, k] = target v valid AND source v+off_k valid.

    One window of the zero-padded mask per target (a view), so a band of
    consecutive offsets costs a pad and a product whatever its width; other
    offsets add one stack of the window's columns."""
    B, L = mask.shape
    lo, hi = min(offsets), max(offsets)
    pad_l = max(0, -lo)
    padded = F.pad(mask, (pad_l, max(0, hi)))  # source u at column u + pad_l
    win = padded[:, lo + pad_l:].unfold(1, hi - lo + 1, 1)[:, :L]  # [B, L, ·]: sources v + lo .. v + hi
    if tuple(offsets) != tuple(range(lo, hi + 1)):
        win = torch.stack([win[..., o - lo] for o in offsets], -1)
    return win * mask[..., None]


def banded_relational_messages(x, speakers, mask, weights, wp: int, wf: int, n_speakers: int,
                               aggr: str = "mean", edge_norm_band=None):
    """Banded equivalent of ops.gnn.relational_message_passing on the
    windowed graph.  edge_norm_band: optional [B, L, K] per-tap weights
    (k-th tap of target v = edge (v+off_k) → v).
    """
    B, L, D = x.shape
    S = n_speakers
    Dout = weights.shape[-1]
    offsets = band_offsets(wp, wf)
    # offsets ascend, so the backward taps (o < 0) come first
    n_neg = sum(1 for o in offsets if o < 0)
    speakers = speakers.long()

    # Ysel[b, u, s, t, :] = x_u @ W_{2(spk_u·S + s) + t}
    W = weights.reshape(S, S, 2, D, Dout)  # [src_spk, tgt_spk, dir, D, Dout]
    onehot = F.one_hot(speakers, S).to(x.dtype)  # [B, L, S]
    Xs = x[:, :, None, :] * onehot[..., None]  # [B, L, S(src), D]
    Ysel = torch.einsum("blpd,pstde->blste", Xs, W)  # [B, L, S(tgt), 2, Dout]

    tap = _tap_valid(mask, offsets)  # [B, L, K]
    coef = tap * edge_norm_band if edge_norm_band is not None else tap

    if aggr == "mean":
        # N[b,v,k] = #taps k' at v with the same relation (src spk AND dir)
        spk_tap = torch.stack([torch.roll(speakers, -off, dims=1) for off in offsets], -1)
        # built on the device: a tensor from a host list costs a blocking copy
        dir_tap = torch.arange(len(offsets), device=x.device) >= n_neg
        same_rel = (
            (spk_tap[:, :, :, None] == spk_tap[:, :, None, :])
            & (dir_tap[None, None, :, None] == dir_tap[None, None, None, :])
        ).to(x.dtype)
        N = torch.einsum("blkj,blj->blk", same_rel, tap)
        coef = coef / N.clamp(min=1.0)

    out = torch.zeros(B, L, Dout, dtype=x.dtype, device=x.device)
    for t, ks in ((0, slice(0, n_neg)), (1, slice(n_neg, len(offsets)))):
        offs = offsets[ks]
        if not offs:
            continue
        c_t = coef[:, :, ks]
        for s in range(S):
            # a strided view of Ysel: the kernel reads it in place
            src = Ysel[:, :, s, t, :]
            out = out + banded_gather_sum(c_t * onehot[:, :, s : s + 1], src, offs)
    return out


class BandedRGCN(DenseRGCN):
    """DenseRGCN on windowed graphs through the band kernels."""

    def __init__(self, in_features: int, out_features: int, num_relations: int, n_speakers: int,
                 wp: int, wf: int, num_bases=None, aggr: str = "mean", *, generator=None,
                 device=None):
        super().__init__(in_features, out_features, num_relations, num_bases, aggr,
                         generator=generator, device=device)
        self.n_speakers, self.wp, self.wf = n_speakers, wp, wf

    def forward(self, x, speakers, mask, edge_norm_band=None):
        out = banded_relational_messages(
            x, speakers, mask, self.relation_weights(), self.wp, self.wf, self.n_speakers,
            self.aggr, edge_norm_band,
        )
        return out + x @ self.root + self.bias


class BandedTransformerConv(DenseTransformerConv):
    """DenseTransformerConv (one head) on windowed graphs: banded scores
    (K2) and banded aggregation (K1)."""

    def __init__(self, in_features: int, out_features: int, wp: int, wf: int, *,
                 generator=None, device=None):
        super().__init__(in_features, out_features, 1, generator=generator, device=device)
        self.wp, self.wf = wp, wf

    def forward(self, x, mask):
        d = self.out_features
        q, k, v = self.lin_query(x), self.lin_key(x), self.lin_value(x)
        skip = self.lin_skip(x)
        offsets = band_offsets(self.wp, self.wf)
        scores = banded_dot(q, k, offsets) / math.sqrt(d)  # [B, L, K]
        tap = _tap_valid(mask, offsets) > 0
        big_neg = torch.finfo(scores.dtype).min / 2
        alpha = torch.softmax(torch.where(tap, scores, torch.full_like(scores, big_neg)), dim=-1)
        alpha = torch.where(tap, alpha, torch.zeros_like(alpha))
        return banded_gather_sum(alpha, v, offsets) + skip


class BandedGraphConv(DenseGraphConv):
    """DenseGraphConv on windowed graphs: the sum over each target's window
    is one K1 over the full band with the tap mask as coefficients."""

    def __init__(self, in_features: int, out_features: int, wp: int, wf: int, *, generator=None,
                 device=None):
        super().__init__(in_features, out_features, generator=generator, device=device)
        self.wp, self.wf = wp, wf

    def forward(self, x, mask):
        offsets = band_offsets(self.wp, self.wf)
        agg = banded_gather_sum(_tap_valid(mask, offsets), x, offsets)
        return self.lin_rel(agg) + self.lin_root(x)
