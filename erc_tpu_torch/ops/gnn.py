"""Dense masked graph layers.

Port of ``erc_tpu.ops.gnn`` (relational_message_passing, DenseRGCN,
DenseTransformerConv, DenseGraphConv): batched [B, L, L] message passing over the
adjacency convention of ``ops.graphs`` (A[b, u, v] = edge u → v).  The
dense path is COGMEN's and DialogueGCN's default at L ≤ 256 and the in-port
oracle that the banded path must equal.  Weights keep the JAX layout: RGCN ``weight`` is
[R, D, Dout] and ``root`` is [D, Dout].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from erc_tpu_torch.ops.attention import Linear
from erc_tpu_torch.ops.init import xavier_uniform_


def relational_message_passing(x, adj, rel, weights, edge_norm=None, aggr: str = "mean"):
    """out[v] = Σ_r agg_{u∈N_r(v)} (x_u @ W_r).

    x: [B, L, D]; adj: [B, L, L] (u→v); rel: [B, L, L] int; weights: [R, D, D'].
    aggr='mean' normalises per (target, relation); aggr='add' sums,
    optionally scaled by per-edge ``edge_norm`` [B, L, L].
    """
    R = weights.shape[0]
    B, L, _ = x.shape
    out = torch.zeros(B, L, weights.shape[-1], dtype=x.dtype, device=x.device)
    for r in range(R):
        a_r = adj * (rel == r)
        if edge_norm is not None:
            a_r = a_r * edge_norm
        if aggr == "mean":
            cnt = a_r.sum(dim=1)  # [B, v]: in-degree of v under relation r
            a_r = a_r / cnt.clamp(min=1.0)[:, None, :]
        out = out + torch.einsum("buv,bue->bve", a_r, x @ weights[r])
    return out


class DenseRGCN(nn.Module):
    """Relational GCN with root weight and bias, optional ``num_bases``
    basis decomposition; 'mean' (COGMEN) or 'add' aggregation."""

    def __init__(self, in_features: int, out_features: int, num_relations: int,
                 num_bases: Optional[int] = None, aggr: str = "mean", *,
                 generator=None, device=None):
        super().__init__()
        D, Dout, R = in_features, out_features, num_relations
        self.num_bases, self.aggr = num_bases, aggr
        if num_bases is not None:
            scale = 1.0 / math.sqrt(num_bases * D)
            self.basis = nn.Parameter(torch.empty(num_bases, D, Dout, device=device))
            self.att = nn.Parameter(torch.empty(R, num_bases, device=device))
            self.root = nn.Parameter(torch.empty(D, Dout, device=device))
            self.bias = nn.Parameter(torch.empty(Dout, device=device))
            with torch.no_grad():
                for t in (self.basis, self.att, self.root, self.bias):
                    cpu = torch.empty(t.shape).uniform_(-scale, scale, generator=generator)
                    t.copy_(cpu)
        else:
            self.weight = nn.Parameter(torch.empty(R, D, Dout, device=device))
            self.root = nn.Parameter(torch.empty(D, Dout, device=device))
            self.bias = nn.Parameter(torch.zeros(Dout, device=device))
            with torch.no_grad():
                xavier_uniform_(self.weight, generator=generator)
                xavier_uniform_(self.root, generator=generator)

    def relation_weights(self) -> torch.Tensor:
        if self.num_bases is not None:
            return torch.einsum("rb,bde->rde", self.att, self.basis)
        return self.weight

    def forward(self, x, adj, rel, edge_norm=None):
        out = relational_message_passing(x, adj, rel, self.relation_weights(), edge_norm, self.aggr)
        return out + x @ self.root + self.bias


class DenseTransformerConv(nn.Module):
    """PyG TransformerConv (concat heads) on a dense adjacency:
    out_v = W_skip x_v + Σ_{u∈N(v)} α_uv · W_val x_u, with α a softmax over
    the incoming edges of v of (W_q x_v)ᵀ(W_k x_u) / √d."""

    def __init__(self, in_features: int, out_features: int, heads: int = 1, *,
                 generator=None, device=None):
        super().__init__()
        self.out_features, self.heads = out_features, heads
        kw = dict(generator=generator, device=device)
        self.lin_query = Linear(in_features, out_features * heads, **kw)
        self.lin_key = Linear(in_features, out_features * heads, **kw)
        self.lin_value = Linear(in_features, out_features * heads, **kw)
        self.lin_skip = Linear(in_features, out_features * heads, **kw)

    def forward(self, x, adj):
        d, H = self.out_features, self.heads
        B, L, _ = x.shape
        qh = self.lin_query(x).reshape(B, L, H, d)
        kh = self.lin_key(x).reshape(B, L, H, d)
        vh = self.lin_value(x).reshape(B, L, H, d)
        skip = self.lin_skip(x)
        # scores[b, h, u, v] for edge u→v: q of target v, k of source u
        scores = torch.einsum("bvhd,buhd->bhuv", qh, kh) / math.sqrt(d)
        big_neg = torch.finfo(scores.dtype).min / 2
        edge = adj[:, None] > 0
        scores = torch.where(edge, scores, torch.full_like(scores, big_neg))
        alpha = torch.softmax(scores, dim=2)  # over sources u
        alpha = torch.where(edge, alpha, torch.zeros_like(alpha))
        out = torch.einsum("bhuv,buhd->bvhd", alpha, vh).reshape(B, L, H * d)
        return out + skip


class DenseGraphConv(nn.Module):
    """PyG GraphConv (aggr='add'): out_v = W_rel Σ_{u∈N(v)} x_u + W_root x_v."""

    def __init__(self, in_features: int, out_features: int, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.lin_rel = Linear(in_features, out_features, **kw)
        self.lin_root = Linear(in_features, out_features, **kw)

    def forward(self, x, adj):
        return self.lin_rel(torch.einsum("buv,bud->bvd", adj, x)) + self.lin_root(x)
