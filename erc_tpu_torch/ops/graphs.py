"""Dialogue-graph construction over padded [B, L] tensors.

Port of ``erc_tpu.ops.graphs`` (length_mask, window_adjacency,
relation_ids).  Conventions:
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
