"""Dense masked graph layers.

Port of ``erc_tpu.ops.gnn`` (relational_message_passing, DenseRGCN,
DenseTransformerConv, DenseGraphConv, and MMGCN's GCNIIStack and
GCNIIStackStructured): batched [B, L, L] message passing over the
adjacency convention of ``ops.graphs`` (A[b, u, v] = edge u → v).  The
dense path is COGMEN's and DialogueGCN's default at L ≤ 256 and the in-port
oracle that the banded path must equal.  Weights keep the JAX layout: RGCN ``weight`` is
[R, D, Dout] and ``root`` is [D, Dout].
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from erc_tpu_torch.ops.attention import Linear
from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.graphs import structured_adj_matmul
from erc_tpu_torch.ops.init import uniform_, xavier_uniform_


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


def _chunk_of(n: int, want: int) -> int:
    """The largest divisor of ``n`` that is ≤ ``want``: layers a trip."""
    c = max(1, min(want, n))
    while n % c:
        c -= 1
    return c


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat='dots'``: keep the matrix
    products' outputs, recompute the elementwise chain (JAX's
    ``dots_saveable``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(trip, mode):
    """``trip`` run as ``mode`` says: 'off' (or False) as is, 'full' (or
    True) under ``torch.utils.checkpoint``, 'dots' under a checkpoint that
    saves the products.  The checkpoint does not save and restore the RNG
    state (reading the card's generator state cannot be captured in a CUDA
    graph): a trip draws nothing, its dropout masks come in as inputs
    (``Dropout.masks``)."""
    if not mode or mode == "off":
        return trip
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if mode in (True, "full"):
        return lambda *a: checkpoint(trip, *a, use_reentrant=False, preserve_rng_state=False)
    if mode == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_products)
        return lambda *a: checkpoint(trip, *a, use_reentrant=False, preserve_rng_state=False,
                                     context_fn=context_fn)
    raise ValueError(f"unknown remat mode {mode!r}")


class GCNIIStack(nn.Module):
    """Deep GCNII (variant) over a dense adjacency [B, N, N].  Layer l
    (1-indexed), with dropout before each:
        θ_l = log(λ / l + 1),  hi = Aᵀ h
        out = relu(θ_l · ([hi, h0] @ W_l) + (1 − θ_l) · ((1 − α) hi + α h0))
    ``convs`` is the JAX layout [nlayers, 2·nh, nh].  [hi, h0] @ W is split
    as hi @ W[:nh] + h0 @ W[nh:], and h0 is the same in every layer, so its
    half is one [B·N, nh] × [nh, C·nh] product a trip of C layers
    (``_chunk_of(nlayers, chunk)``).  ``remat`` (``_remat``) checkpoints each
    trip; its dropout masks are drawn before the trip and passed in."""

    def __init__(self, nlayers: int, nhidden: int, lamda: float = 0.5, alpha: float = 0.1, dropout: float = 0.0,
                 remat="off", chunk: int = 8, *, generator=None, device=None):
        super().__init__()
        self.nlayers, self.nhidden, self.alpha, self.remat = nlayers, nhidden, alpha, remat
        self.chunk = _chunk_of(nlayers, chunk)
        self.convs = nn.Parameter(torch.empty(nlayers, 2 * nhidden, nhidden, device=device))
        with torch.no_grad():
            uniform_(self.convs, 1.0 / math.sqrt(nhidden), generator=generator)
        # (θ_l, 1 − θ_l) computed in float32, as the JAX stack computes them
        thetas = np.log(np.float32(lamda) / np.arange(1, nlayers + 1, dtype=np.float32) + np.float32(1.0))
        self.thetas = [(float(t), float(np.float32(1.0) - t)) for t in thetas]
        self.dropout = Dropout(dropout)

    def aggregate(self, adj, h):
        return torch.bmm(adj.transpose(1, 2), h)

    def forward(self, x, *adj):
        """x [..., nh] (h0); ``adj``: what ``aggregate`` takes."""
        nh, C, a = self.nhidden, self.chunk, self.alpha
        h0 = x
        ah0 = a * h0
        rows = h0.reshape(-1, nh)
        trip = _remat(self._trip, self.remat if torch.is_grad_enabled() else "off")
        h = h0
        for s in range(0, self.nlayers, C):
            Wc = self.convs[s : s + C]
            # h0's half of the support for the trip's C layers: [B·N, C·nh]
            b2c = rows @ Wc[:, nh:].transpose(0, 1).reshape(nh, C * nh)
            masks = self.dropout.masks((C, *h.shape), h)
            h = trip(h, Wc[:, :nh], b2c, ah0, masks, s, *adj)
        return h

    def _trip(self, h, W1c, b2c, ah0, masks, s, *adj):
        nh = self.nhidden
        for t in range(W1c.shape[0]):
            if masks is not None:
                h = h * masks[t]
            hi = self.aggregate(*adj, h)
            support = torch.addmm(b2c[:, t * nh : (t + 1) * nh], hi.reshape(-1, nh), W1c[t]).view_as(hi)
            theta, rest = self.thetas[s + t]
            r = torch.add(ah0, hi, alpha=1.0 - self.alpha)
            h = torch.relu(torch.add(theta * support, r, alpha=rest))
        return h


class GCNIIStackStructured(GCNIIStack):
    """GCNIIStack over MMGCN's structured adjacency (``ops.graphs.
    mmgcn_structured_adjacency``): x [B, M, L, nh], ``forward(x, intra,
    cross)``; about 3× fewer aggregation operations than the dense (M·L)²
    form, the same function."""

    def aggregate(self, intra, cross, h):
        return structured_adj_matmul(intra, cross, h)
