"""DAG-ERC: Directed Acyclic Graph network for conversational emotion.

Port of ``erc_tpu.models.dagerc``: a DAG over past context (predecessors
back to the ``windowp``-th earlier turn of the same speaker) with, per
layer, a GAT gather over already-computed outputs and a dual GRU (node GRU
plus proxy GRU) recurrence over the utterances.

- ``DAGLayer`` runs the recurrence one position at a time: the oracle.
- ``DAGStack`` runs every layer in blockwise-prefix form: per block of
  ``chunk`` positions, the attention against earlier blocks is two batched
  products, and the block's sequential tail runs either in the kernels
  (``ops.kernels.dag_block``: K3 forward, K4 backward) or as K3's plain
  version, a loop of torch ops that autograd differentiates (the eager
  form).  ``dag_impl`` picks the tail: ``auto`` takes the kernel for the
  eval forward (``model.eval()``) and the eager form for training, as the
  JAX package's ``resolve_dag_impl`` does; ``kernel`` takes the kernels for
  both; ``eager`` the eager form for both.  ``dag_remat`` recomputes each
  block in the backward instead of keeping its activations.

``DAGERCTrainer`` and ``main`` train the model (``python -m
erc_tpu_torch.train --module=dagerc``): AdamW, grad clip 5.0 and
ReduceLROnPlateau(min), as ``erc_tpu.models.dagerc``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from erc_tpu_torch.core.params import Params
from erc_tpu_torch.models.base import MMBaseParams
from erc_tpu_torch.ops import graphs
from erc_tpu_torch.ops.attention import Linear
from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.init import uniform_
from erc_tpu_torch.ops.kernels.dag_block import dag_block, dag_block_reference
from erc_tpu_torch.ops.rnn import gru_cell
from erc_tpu_torch.train import optim as optim_factory
from erc_tpu_torch.train.trainer import Trainer, refuse_compute_dtype


class DAGERCParams(MMBaseParams):
    def __init__(self):
        super().__init__()
        self.train.batch_size = 8
        self.test.batch_size = 8
        self.gnn_layers = 4
        self.dropout = 0.0
        self.dataset = "iemocap-cogmen-6"
        self.epoch = 30
        self.optim = Params(name="AdamW", lr=1e-3, weight_decay=0.0)
        self.speaker_onehot = True
        self.windowp = 1
        self.hidden_dim = 300
        # positions per block of the blockwise-prefix form; recompute each
        # block in the backward (the JAX default); the block's tail
        self.dag_chunk = 16
        self.dag_remat = True
        self.dag_impl = self.choice("auto", "kernel", "eager")
        # final nodal attention over the stacked features ("" = identity)
        self.nodal_att_type = self.choice("", "global", "past")

    def iparams(self):
        super().iparams()
        if self.reimplement:
            if "iemocap" in self.dataset:
                self.dropout = 0.2
                self.epoch = 55
                self.train.batch_size = 16
                self.optim.lr = 0.0005
                self.gnn_layers = 4
            elif "meld" in self.dataset:
                self.optim.lr = 0.00001
                self.train.batch_size = 64
                self.epoch = 70
                self.dropout = 0.1
            elif "emorynlp" in self.dataset:
                self.optim.lr = 0.00005
                self.train.batch_size = 32
                self.epoch = 100
                self.dropout = 0.3
            elif "dailydialog" in self.dataset:
                self.gnn_layers = 3
                self.optim.lr = 0.00002
                self.train.batch_size = 64
                self.epoch = 50
                self.dropout = 0.3


ParamsType = DAGERCParams


def resolve_dag_impl(dag_impl: str) -> Tuple[str, str]:
    """--dag_impl → (training form, eval form) on one device.  ``auto`` is
    the JAX package's choice on one chip: the eager form in training, the
    kernel in eval; ``kernel`` (JAX's ``pallas``) and ``eager`` force one."""
    if dag_impl == "auto":
        return "eager", "kernel"
    if dag_impl not in ("kernel", "eager"):
        raise ValueError(f"unknown dag_impl {dag_impl!r}")
    return dag_impl, dag_impl


def _layer_params(module: nn.Module, prefix: str, D: int, generator, device) -> None:
    """Register one layer's parameters (GAT_dialoggcn_v1 attention, output
    transforms, node and proxy GRU cells) with the JAX module's names and
    uniform initialisation."""
    att, s = 1.0 / math.sqrt(2 * D), 1.0 / math.sqrt(D)
    specs = {"att_w": ((2 * D, 1), att), "att_b": ((1,), att), "Wr0": ((D, D), s), "Wr1": ((D, D), s)}
    for cell in ("c", "p"):
        for name, shape in (("w_ih", (3 * D, D)), ("w_hh", (3 * D, D)), ("b_ih", (3 * D,)), ("b_hh", (3 * D,))):
            specs[f"gru_{cell}_{name}"] = (shape, s)
    for name, (shape, scale) in specs.items():
        p = nn.Parameter(torch.empty(shape, device=device))
        with torch.no_grad():
            uniform_(p, scale, generator=generator)
        module.register_parameter(prefix + name, p)


class DAGLayer(nn.Module):
    """One DAG layer, one position at a time (GAT_dialoggcn_v1 gather + dual
    GRUCell): the per-step form the blockwise one is held against."""

    def __init__(self, hidden_dim: int, *, generator=None, device=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        _layer_params(self, "", hidden_dim, generator, device)

    def forward(self, H: torch.Tensor, adj: torch.Tensor, s_mask: torch.Tensor) -> torch.Tensor:
        D = self.hidden_dim
        B, L, _ = H.shape
        wq, wk = self.att_w[:D, 0], self.att_w[D:, 0]
        xproj_c = H @ self.gru_c_w_ih.T + self.gru_c_b_ih
        q_att = H @ wq
        H1 = H.new_zeros(B, L, D)
        V0 = H.new_zeros(B, L, D)
        V1 = H.new_zeros(B, L, D)
        Kp = H.new_zeros(B, L)
        for i in range(L):
            alpha = q_att[:, i, None] + Kp + self.att_b[0]
            alpha = alpha - (1.0 - adj[:, i]) * 1e30
            attn = torch.softmax(alpha, -1)
            sm = s_mask[:, i, :, None]
            M = torch.einsum("bl,bld->bd", attn, V0 * sm + V1 * (1.0 - sm))
            if i == 0:
                M = torch.zeros_like(M)
            C = gru_cell(xproj_c[:, i], M, self.gru_c_w_hh, self.gru_c_b_hh)
            P = gru_cell(M @ self.gru_p_w_ih.T + self.gru_p_b_ih, H[:, i], self.gru_p_w_hh,
                         self.gru_p_b_hh)
            h1 = C + P
            H1 = H1.select_scatter(h1, 1, i)
            V0 = V0.select_scatter(h1 @ self.Wr0.T, 1, i)
            V1 = V1.select_scatter(h1 @ self.Wr1.T, 1, i)
            Kp = Kp.select_scatter(h1 @ wk, 1, i)
        return H1


class DAGStack(nn.Module):
    """All DAG layers in blockwise-prefix form; the same function as chaining
    DAGLayer.

    Each layer's queries and input projections depend only on its input, so
    they are computed for every position at once.  The positions then go in
    blocks of ``chunk``: the block's attention against all *earlier* blocks
    (and the still-zero later ones) is two batched products into softmax
    statistics (max ``mp``, sum ``den_p``, weighted values ``num01``); the
    block's tail, position by position, attends within the block and merges
    the two halves by the running-max rescale.  Masks are additive (-1e30):
    a row whose predecessor set is empty falls back to the softmax of the raw
    logits over every column, as the per-step form does; columns past the
    dialogue batch carry float32 min so they drop out even then.

    ``impl`` is the training form, ``impl_eval`` (empty: as ``impl``) the
    eval form; 'kernel' runs the tail in K3 (with grad: K3 forward, K4
    backward), 'eager' as K3's plain version.  Without grad the kernel form
    writes K3's outputs in place into the layer's buffers; with grad it
    updates them out of place, since autograd keeps the buffers that the
    earlier blocks' prefix products read.  ``remat`` (with grad) recomputes
    each block in the backward: K3 then runs twice per block and step.
    """

    def __init__(self, hidden_dim: int, n_layers: int, chunk: int = 16, impl: str = "eager",
                 impl_eval: str = "", remat: bool = False, *, generator=None, device=None):
        super().__init__()
        for name in (impl, impl_eval or impl):
            if name not in ("kernel", "eager"):
                raise ValueError(f"unknown DAGStack impl {name!r}")
        self.hidden_dim, self.n_layers, self.chunk = hidden_dim, n_layers, chunk
        self.impl, self.impl_eval, self.remat = impl, impl_eval, remat
        for l in range(n_layers):
            _layer_params(self, f"layer_{l}_", hidden_dim, generator, device)

    def forward(self, H0: torch.Tensor, adj: torch.Tensor, s_mask: torch.Tensor) -> List[torch.Tensor]:
        B, L, _ = H0.shape
        C = max(1, min(self.chunk, L))
        Lp = -(-L // C) * C
        pad = Lp - L
        if pad:
            adj = F.pad(adj, (0, pad, 0, pad))
            s_mask = F.pad(s_mask, (0, pad, 0, pad))
            H0 = F.pad(H0, (0, 0, 0, pad))
        fmin = torch.finfo(H0.dtype).min
        colpad = torch.where(torch.arange(Lp, device=H0.device) < L, 0.0, fmin).to(H0.dtype)
        addmask = -(1.0 - adj) * 1e30 + colpad  # [B, Lp, Lp]
        impl = self.impl if self.training else (self.impl_eval or self.impl)
        outs = []
        h = H0
        for l in range(self.n_layers):
            h = self._layer(l, h, addmask, s_mask, C, impl == "kernel")
            outs.append(h[:, :L])
        return outs

    def _layer(self, l: int, h_in, addmask, s_mask, C: int, use_kernel: bool) -> torch.Tensor:
        """One DAG layer over all positions; h_in [B, Lp, D]."""
        D = self.hidden_dim
        B, Lp, _ = h_in.shape
        # a bfloat16 step's first layer runs in bfloat16; its float32 masks make
        # the layer's output float32, and the layers after it run in float32
        # on the bfloat16 weights, as JAX's promotion has it
        dt = torch.promote_types(h_in.dtype, getattr(self, f"layer_{l}_att_w").dtype)
        p = lambda name: getattr(self, f"layer_{l}_{name}").to(dt)  # noqa: E731
        h_in = h_in.to(dt)
        wq, wk, bias = p("att_w")[:D, 0], p("att_w")[D:, 0], p("att_b")[0]
        q = h_in @ wq  # [B, Lp]
        xc = h_in @ p("gru_c_w_ih").T + p("gru_c_b_ih")  # node GRU input projection
        hpp = h_in @ p("gru_p_w_hh").T + p("gru_p_b_hh")  # proxy GRU hidden projection (h = h_in)
        NEG = torch.finfo(h_in.dtype).min / 2
        cols = torch.arange(Lp, device=h_in.device)
        # the block tail's weights as [k, d] rows, built once per layer; K4
        # reads the registered (torch-layout) ones
        Whc = p("gru_c_w_hh").reshape(3, D, D).transpose(1, 2).contiguous()
        Wip = p("gru_p_w_ih").reshape(3, D, D).transpose(1, 2).contiguous()
        bhc, bip = p("gru_c_b_hh").reshape(3, D), p("gru_p_b_ih").reshape(3, D)
        Wr0T, Wr1T = p("Wr0").T.contiguous(), p("Wr1").T.contiguous()
        native = tuple(p(n).detach() for n in ("gru_c_w_hh", "gru_p_w_ih", "Wr0", "Wr1"))
        qb_all = q + bias
        xc4, hpp4 = xc.reshape(B, Lp, 3, D), hpp.reshape(B, Lp, 3, D)
        inplace = use_kernel and not torch.is_grad_enabled()
        out = h_in.new_empty(B, Lp, D) if inplace else None

        def block(t: int, V0, V1, K) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
            s, e = t * C, t * C + C
            # prefix: the block's queries against every column outside it
            pre = ((cols < s) | (cols >= e)).to(h_in.dtype)
            lpre = q[:, s:e, None] + K[:, None, :] + bias + addmask[:, s:e]  # [B, C, Lp]
            lpre = torch.where(pre > 0, lpre, NEG)
            mp = lpre.amax(-1)  # [B, C], >= NEG
            ep = torch.exp(lpre - mp[..., None]) * pre
            den_p = ep.sum(-1)
            e0 = ep * s_mask[:, s:e]
            num01 = torch.bmm(e0, V0.to(e0.dtype)) + torch.bmm(ep - e0, V1.to(e0.dtype))
            args = (t == 0, qb_all[:, s:e], xc4[:, s:e], hpp4[:, s:e], h_in[:, s:e], num01, den_p,
                    mp, addmask[:, s:e, s:e], s_mask[:, s:e, s:e], Whc, bhc, Wip, bip, Wr0T, Wr1T,
                    wk[:, None])
            if inplace:
                dag_block(*args, out=(out[:, s:e], V0[:, s:e], V1[:, s:e], K[:, s:e]))
                return V0, V1, K, None
            if use_kernel:
                h1b, V0w, V1w, Kw = dag_block(*args, native=native)
            else:
                h1b, V0w, V1w, Kw = dag_block_reference(*args)
            # out of place: autograd keeps the buffers the earlier prefixes read
            return (V0.slice_scatter(V0w, 1, s, e), V1.slice_scatter(V1w, 1, s, e),
                    K.slice_scatter(Kw, 1, s, e), h1b)

        V0 = h_in.new_zeros(B, Lp, D)
        V1 = h_in.new_zeros(B, Lp, D)
        K = h_in.new_zeros(B, Lp)
        remat = self.remat and torch.is_grad_enabled()
        blocks = []
        for t in range(Lp // C):
            if remat:  # no dropout inside a block, so no RNG state to replay
                V0, V1, K, h1b = checkpoint(block, t, V0, V1, K, use_reentrant=False,
                                            preserve_rng_state=False)
            else:
                V0, V1, K, h1b = block(t, V0, V1, K)
            blocks.append(h1b)
        return out if inplace else torch.cat(blocks, 1)


class AttentiveNodeFeatures(nn.Module):
    """Final nodal attention over the stacked features:
    alpha = softmax(tanh(transform(H)·Hᵀ)), masked to valid (and, for 'past',
    earlier) positions, then renormalised."""

    def __init__(self, dim: int, *, generator=None, device=None):
        super().__init__()
        self.transform = Linear(dim, dim, generator=generator, device=device)

    def forward(self, features, mask, nodal_att_type: str):
        m = mask[:, None, :].to(features.dtype)  # [B, 1, N]
        if nodal_att_type == "past":
            N = features.shape[1]
            m = m * torch.ones(N, N, dtype=features.dtype, device=features.device).tril()[None]
        scores = torch.einsum("bnv,bmv->bnm", self.transform(features), features)
        alpha = torch.softmax(torch.tanh(scores), -1) * m
        alpha = alpha / alpha.sum(-1, keepdim=True).clamp_min(1e-20)
        return torch.einsum("bnm,bmv->bnv", alpha, features)


class DAGERCModule(nn.Module):
    """fc1 → DAG layers → concat(inputs and every layer) → [nodal attention]
    → 3-layer MLP.  ``fused=True`` runs DAGStack, ``fused=False`` chains
    DAGLayer (the oracle)."""

    def __init__(self, emb_dim: int, n_classes: int, gnn_layers: int = 4, hidden_dim: int = 300,
                 windowp: int = 1, drop_rate: float = 0.2, fused: bool = True, chunk: int = 16,
                 impl: str = "eager", impl_eval: str = "", nodal_att_type: str = "",
                 remat: bool = False, *, generator=None, device=None):
        super().__init__()
        if nodal_att_type not in ("", "global", "past"):
            raise ValueError(f"unknown nodal_att_type {nodal_att_type!r}")
        kw = dict(generator=generator, device=device)
        self.windowp, self.fused, self.nodal_att_type = windowp, fused, nodal_att_type
        self.fc1 = Linear(emb_dim, hidden_dim, **kw)
        if fused:
            self.stack = DAGStack(hidden_dim, gnn_layers, chunk, impl, impl_eval, remat, **kw)
        else:
            self.layers = nn.ModuleList(DAGLayer(hidden_dim, **kw) for _ in range(gnn_layers))
        feat = hidden_dim * (gnn_layers + 1) + emb_dim
        if nodal_att_type:
            self.nodal_att = AttentiveNodeFeatures(feat, **kw)
        self.out_0 = Linear(feat, hidden_dim, **kw)
        self.out_1 = Linear(hidden_dim, hidden_dim, **kw)
        self.out_2 = Linear(hidden_dim, n_classes, **kw)
        self.dropout = Dropout(drop_rate)

    def forward(self, batch) -> torch.Tensor:
        x = batch["input_tensor"]
        L = x.shape[1]
        speakers = batch["speaker_ids"]
        adj = graphs.dag_adjacency(speakers, batch["text_length"], L, self.windowp)
        s_mask = graphs.same_speaker_mask(speakers)
        H0 = torch.relu(self.fc1(x))
        if self.fused:
            Hs = [H0, *self.stack(H0, adj, s_mask)]
        else:
            Hs = [H0]
            for layer in self.layers:
                Hs.append(layer(Hs[-1], adj, s_mask))
        H = torch.cat([*Hs, x], -1)
        if self.nodal_att_type:
            H = self.nodal_att(H, batch["attention_mask"], self.nodal_att_type)
        h = torch.relu(self.out_0(H))
        h = self.dropout(torch.relu(self.out_1(h)))
        return self.out_2(h)


def build(p: DAGERCParams, *, generator=None, device=None) -> DAGERCModule:
    """The module that ``p`` describes (``p.iparams()`` already applied)."""
    impl, impl_eval = resolve_dag_impl(str(p.get("dag_impl", "auto")))
    return DAGERCModule(
        emb_dim=p.hidden_all, n_classes=p.n_classes, gnn_layers=int(p.gnn_layers),
        hidden_dim=int(p.hidden_dim), windowp=int(p.windowp), drop_rate=float(p.dropout),
        chunk=int(p.get("dag_chunk", 16)), impl=impl, impl_eval=impl_eval,
        nodal_att_type=str(p.get("nodal_att_type", "") or ""), remat=bool(p.get("dag_remat", True)),
        generator=generator, device=device,
    )


class DAGERCTrainer(Trainer):
    """AdamW with grad clip 5.0 and ReduceLROnPlateau(min), as the JAX
    ``DAGERCTrainer`` (dagerc.py:512-533)."""

    flax_module = "dagerc"

    def check_compute_dtype(self, params) -> None:
        """bfloat16 trains the eager form only (``auto`` trains it too, and
        evaluates through K3 in float32): with ``dag_impl=kernel`` the JAX
        step fails in the Pallas kernel's stores."""
        if self.compute_dtype != torch.float32 and str(params.get("dag_impl", "auto")) == "kernel":
            refuse_compute_dtype("--dag_impl=kernel", "erc_tpu/ops/pallas/dag_block.py:320, the fused block kernel: "
                                 "Invalid dtype for swap, a float32 value into a bfloat16 ref")

    def imodels(self, params: DAGERCParams):
        generator = torch.Generator().manual_seed(int(params.seed))
        self.model = build(params, generator=generator, device=self.device)
        self.optimizer = optim_factory.build_optim(params.optim, self.model.named_parameters(), self.device)
        self.grad_clip_norm = 5.0
        self.lr_sche = torch.optim.lr_scheduler.ReduceLROnPlateau(self.optimizer, "min")


def main(argv: Optional[list] = None) -> DAGERCTrainer:
    """``python -m erc_tpu_torch.train --module=dagerc [--dataset=...] ...``"""
    params = DAGERCParams()
    params.finalize(argv)
    trainer = DAGERCTrainer(params)
    trainer.train()
    trainer.save_model()
    return trainer
