"""Dialogue-graph construction over padded [B, L] tensors.

Port of ``erc_tpu.ops.graphs`` (length_mask, window_adjacency,
relation_ids, same_speaker_mask, dag_adjacency).  Conventions:
    adjacency A[b, u, v] = 1  ⟺  edge u → v  (v aggregates from u)
    masks are float32 {0, 1}.
"""

from __future__ import annotations

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
