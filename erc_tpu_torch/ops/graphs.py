"""Dialogue-graph construction over padded [B, L] tensors.

Port of ``erc_tpu.ops.graphs`` (length_mask, window_adjacency,
relation_ids, same_speaker_mask, dag_adjacency, and MMGCN's adjacency in
its dense and structured forms).  Conventions:
    adjacency A[b, u, v] = 1  ⟺  edge u → v  (v aggregates from u)
    masks are float32 {0, 1}.
"""

from __future__ import annotations

import math

import torch


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, L] validity mask from per-dialogue lengths."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(torch.float32)


def window_adjacency(lengths: torch.Tensor, max_len: int, wp: int, wf: int) -> torch.Tensor:
    """Windowed edge mask: (u, v) for every v ∈ [u-wp, u+wf] inside the
    dialogue; wp/wf = -1 means unbounded.  Returns A[b, u, v] ∈ {0, 1}."""
    idx = torch.arange(max_len, device=lengths.device)
    diff = idx[None, :] - idx[:, None]  # diff[u, v] = v - u
    band = torch.ones((max_len, max_len), dtype=torch.bool, device=lengths.device)
    if wp != -1:
        band &= diff >= -wp
    if wf != -1:
        band &= diff <= wf
    valid = length_mask(lengths, max_len)
    pair_valid = valid[:, :, None] * valid[:, None, :]
    return band[None].to(torch.float32) * pair_valid


def relation_ids(speakers: torch.Tensor, n_speakers: int) -> torch.Tensor:
    """rel(u→v) = 2·(spk_u·S + spk_v) + (0 if u < v else 1), as int32
    [B, L, L]; num_relations = 2·S²."""
    L = speakers.shape[-1]
    su = speakers[:, :, None].to(torch.int32)
    sv = speakers[:, None, :].to(torch.int32)
    idx = torch.arange(L, device=speakers.device)
    direction = (idx[:, None] >= idx[None, :]).to(torch.int32)  # u >= v → 1
    return 2 * (su * n_speakers + sv) + direction[None]


def same_speaker_mask(speakers: torch.Tensor) -> torch.Tensor:
    """s_mask[b, i, j] = 1 iff spk_i == spk_j."""
    return (speakers[:, :, None] == speakers[:, None, :]).to(torch.float32)


def dag_adjacency(speakers: torch.Tensor, lengths: torch.Tensor, max_len: int,
                  windowp: int = 1) -> torch.Tensor:
    """DAG-ERC predecessor mask: a[b, i, j] = 1 iff j < i, both inside the
    dialogue, and fewer than ``windowp`` turns of i's speaker lie strictly
    between j and i (every predecessor down to and including the
    windowp-th earlier turn of the same speaker)."""
    same = (speakers[:, :, None] == speakers[:, None, :]).to(torch.int32)  # [B, i, k]
    S = same.cumsum(-1)  # S[b, i, j] = #{k <= j : spk_k == spk_i}
    idx = torch.arange(max_len, device=speakers.device)
    # S[b, i, i-1]: the same-speaker count before i (0 at i == 0)
    before = S.gather(-1, (idx - 1).clamp_min(0)[None, :, None].expand(S.shape[0], max_len, 1))
    before = torch.where(idx[None, :, None] > 0, before, torch.zeros_like(before))
    between = before - S  # same-speaker turns in (j, i-1]
    adj = (idx[None, None, :] < idx[None, :, None]) & (between < windowp)
    valid = length_mask(lengths, max_len)
    return adj.to(torch.float32) * (valid[:, :, None] * valid[:, None, :])


# ------------------------------------------------------------------ MMGCN
# MMGCN's adjacency is built in float32 whatever the compute dtype: the
# arccos near ±1 magnifies rounding of the cosines (its slope at the clip is
# about 224).

_CLIP = 0.99999
# 0-d CPU tensors: an operand of a CUDA op as a scalar, with no copy to the card
_LO, _HI = torch.tensor(-_CLIP), torch.tensor(_CLIP)


def _clip(x: torch.Tensor) -> torch.Tensor:
    """Clip to [-0.99999, 0.99999] as ``jnp.clip`` does, gradient included:
    at a tie min/max pass half the gradient, where ``torch.clamp`` passes
    all of it (a self-cosine of 1.0 · 0.99999 lands exactly on the bound)."""
    return torch.minimum(torch.maximum(x, _LO), _HI)


def _unit(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # sqrt of the clamped sum: sqrt(0) on padded rows has an infinite
    # gradient, and 0 · inf = NaN would poison the backward pass
    return x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(eps * eps))


def _angle_sim(cos: torch.Tensor) -> torch.Tensor:
    """1 − arccos(clip(0.99999 · cos)) / π: clipped strictly inside ±1, where
    arccos' slope is finite."""
    return 1.0 - torch.arccos(_clip(cos * _CLIP)) / math.pi


def _rsqrt_or_0(d: torch.Tensor) -> torch.Tensor:
    """1 / √d, 0 where d = 0.  The double ``where``: ``where(d > 0,
    rsqrt(d), 0)`` alone still takes rsqrt(0) in the backward pass and
    poisons the gradients with NaN."""
    pos = d > 0
    return torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, d, 1.0)), 0.0)


def degree_normalize_sym(adj: torch.Tensor) -> torch.Tensor:
    """D^{-1/2} A D^{-1/2}, 0 on rows of degree 0."""
    dinv = _rsqrt_or_0(adj.sum(-1))
    return adj * dinv[..., :, None] * dinv[..., None, :]


def _intra(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return _angle_sim(torch.einsum("bld,bmd->blm", u, u)) * (valid[:, :, None] * valid[:, None, :])


def _cross(u: torch.Tensor, w: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return _angle_sim((u * w).sum(-1)) * valid


def angular_similarity(x: torch.Tensor, valid: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Pairwise 1 − arccos(0.99999 · cos(x_l, x_m)) / π within a dialogue:
    x [B, L, D], valid [B, L] → [B, L, L], 0 where either node is padding."""
    return _intra(_unit(x, eps), valid)


def cross_modal_diag_similarity(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                                eps: float = 1e-12) -> torch.Tensor:
    """Per utterance 1 − arccos(0.99999 · cos(x_l, y_l)) / π → [B, L]."""
    return _cross(_unit(x, eps), _unit(y, eps), valid)


def _mmgcn_blocks(feats: list, valid: torch.Tensor):
    """(intra: M blocks [B, L, L], cross: {(m, n): [B, L]} for m ≠ n), the
    raw similarities.  Each modality is normalised once and each pair's
    similarity computed once: (u·w) and (w·u) are the same floats."""
    units = [_unit(f) for f in feats]
    cross = {}
    for m in range(len(units)):
        for n in range(m + 1, len(units)):
            cross[m, n] = cross[n, m] = _cross(units[m], units[n], valid)
    return [_intra(u, valid) for u in units], cross


def mmgcn_big_adjacency(feats: list, valid: torch.Tensor) -> torch.Tensor:
    """MMGCN's (M·L)² adjacency in padded batch form [B, M·L, M·L]: dense
    angular-similarity blocks within a modality, diagonal blocks across
    modalities, symmetrically degree-normalised over the whole graph.  The
    reference joins all dialogues into one block-diagonal graph; blocks never
    interact, so the batch form is the same per dialogue."""
    intra, cross = _mmgcn_blocks(feats, valid)
    M = len(feats)
    rows = [torch.cat([intra[m] if m == n else torch.diag_embed(cross[m, n]) for n in range(M)], -1)
            for m in range(M)]
    return degree_normalize_sym(torch.cat(rows, -2))


def mmgcn_structured_adjacency(feats: list, valid: torch.Tensor):
    """The same adjacency in its block-sparse form: (intra [M, B, L, L],
    cross [M, M, B, L]) with cross[m][m] = 0, normalised by the degrees of
    the whole M·L row, so A @ x is M dense products and M(M − 1)
    elementwise ones (``structured_adj_matmul``)."""
    blocks, pairs = _mmgcn_blocks(feats, valid)
    M = len(feats)
    zero = torch.zeros_like(valid)
    intra = torch.stack(blocks)
    cross = torch.stack([torch.stack([pairs[m, n] if m != n else zero for n in range(M)]) for m in range(M)])
    dinv = _rsqrt_or_0(intra.sum(-1) + cross.sum(1))  # degrees over the whole M·L row: [M, B, L]
    return intra * dinv[:, :, :, None] * dinv[:, :, None, :], cross * dinv[:, None] * dinv[None, :]


def structured_adj_matmul(intra: torch.Tensor, cross: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x for the structured adjacency; x [B, M, L, D] → [B, M, L, D]:
    out[m] = intra[m] @ x[m] + Σ_{n≠m} diag(cross[m, n]) · x[n]."""
    dense = torch.matmul(intra.transpose(0, 1), x)
    return dense + torch.einsum("mnbl,bnld->bmld", cross, x)
