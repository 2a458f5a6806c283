"""DialogueGCN (v1, "dgcn"): biLSTM context → windowed graph with learned
edge weights → RGCN (num_bases=30, 'add') + GraphConv → concat classifier.

Port of ``erc_tpu.models.dgcn``.

- ``graph_impl='banded'`` runs the band kernels: ``BandedEdgeAtt`` scores
  each node's window with K2 and ``BandedRGCN`` (4 K1 launches at two
  speakers) and ``BandedGraphConv`` (1 K1) aggregate; ``'dense'`` runs the
  [B, L, L] masked layers, the oracle; ``'auto'`` picks banded only for
  L > 256, as the JAX module does.  All three share one set of weights.
- The context encoder is a 2-layer bidirectional LSTM (``ops.rnn.BiRNN``)
  over each dialogue's valid prefix (the masked form), run by cuDNN in full
  float32 on the card.

``DGCNTrainer`` trains it as the JAX ``DGCNTrainer`` does: Adam (lr 3e-4,
no weight decay), no clip, no plateau controller, and the IEMOCAP-6 class
weights in the loss when the dataset has 6 classes::

    python -m erc_tpu_torch.train --module=dgcn --dataset=synthetic-cogmen-6 \
        --graph_impl=banded [--epoch=N] [--device=cpu]
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from erc_tpu_torch.core.params import Params
from erc_tpu_torch.models.base import MMBaseParams
from erc_tpu_torch.ops import graphs
from erc_tpu_torch.ops.attention import Linear, masked_softmax
from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.gnn import DenseGraphConv, DenseRGCN
from erc_tpu_torch.ops.gnn_banded import BandedGraphConv, BandedRGCN, _tap_valid
from erc_tpu_torch.ops.init import normal_
from erc_tpu_torch.ops.kernels.banded import banded_dot
from erc_tpu_torch.ops.rnn import BiRNN
from erc_tpu_torch.train import optim as optim_factory
from erc_tpu_torch.train.trainer import Trainer, main as train_main, refuse_banded_compute_dtype

# IEMOCAP-6 inverse class frequencies (the reference's dgcn.py:109-111)
IEMOCAP6_LOSS_WEIGHTS = [
    1 / 0.086747, 1 / 0.144406, 1 / 0.227883, 1 / 0.160585, 1 / 0.127711, 1 / 0.252668,
]


class DGCNParams(MMBaseParams):
    def __init__(self):
        super().__init__()
        self.train.batch_size = 32
        self.test.batch_size = 32
        self.loss_weights = True
        self.dataset = "iemocap-cogmen-6"
        self.epoch = 55
        self.optim = Params(name="Adam", lr=0.0003, weight_decay=0.0)
        self.wp = 10
        self.wf = 10
        self.hidden_size = 200
        self.drop_rate = 0.4
        self.graph_impl = self.choice("auto", "dense", "banded")


ParamsType = DGCNParams


class EdgeAtt(nn.Module):
    """α[b, u, v] = softmax over v in window(u) of x_u · (W x_v), as one
    [B, L, L] masked softmax (the reference loops over nodes)."""

    def __init__(self, dim: int, wp: int, wf: int, *, generator=None, device=None):
        super().__init__()
        self.wp, self.wf = wp, wf
        self.weight = nn.Parameter(torch.empty(dim, dim, device=device))
        with torch.no_grad():
            # the reference's normal(0, 2 / (dim0 + dim1))
            normal_(self.weight, 1.0 / dim, generator=generator)

    def forward(self, x, lengths):
        scores = torch.einsum("bud,bvd->buv", x, x @ self.weight.T)
        win = graphs.window_adjacency(lengths, x.shape[1], self.wp, self.wf)
        return masked_softmax(scores, win, dim=-1, mode="where")


class BandedEdgeAtt(EdgeAtt):
    """EdgeAtt in band space: K2 scores each node's own window (the source
    band, offsets −wp..wf), and the weights are returned in the target band
    [B, L, K] that ``BandedRGCN`` takes (tap k of target v = edge
    (v + o_k) → v, o_k ∈ −wf..wp)."""

    def forward(self, x, mask):
        wp, wf = self.wp, self.wf
        src_offsets = tuple(range(-wp, wf + 1))
        scores = banded_dot(x, x @ self.weight.T, src_offsets)  # [B, L(u), K]
        alpha = masked_softmax(scores, _tap_valid(mask, src_offsets), dim=-1, mode="where")
        # target tap k (o_k = k − wf) is the source tap of offset −o_k, index
        # K − 1 − k, read at row v + o_k (0 out of range): the JAX module's
        # roll per tap, as one gather from the tap-reversed weights padded by
        # wf rows before and wp after, at row v + k
        B, L, K = alpha.shape
        padded = nn.functional.pad(alpha.flip(-1), (0, 0, wf, wp))  # [B, L + K − 1, K]
        rows = torch.arange(L, device=x.device)[:, None] + torch.arange(K, device=x.device)[None, :]
        return padded.gather(1, rows.expand(B, L, K))


class DGCNModule(nn.Module):
    def __init__(self, input_size: int, hidden_size: int = 200, n_speakers: int = 2, wp: int = 10,
                 wf: int = 10, n_classes: int = 4, drop_rate: float = 0.4, graph_impl: str = "banded", *,
                 generator=None, device=None):
        super().__init__()
        if graph_impl not in ("auto", "dense", "banded"):
            raise ValueError(f"unknown graph_impl {graph_impl!r}")
        self.n_speakers, self.wp, self.wf, self.graph_impl = n_speakers, wp, wf, graph_impl
        kw = dict(generator=generator, device=device)
        h1_dim = h2_dim = hc_dim = 100
        g_dim = 2 * (hidden_size // 2)
        R = 2 * n_speakers**2
        self.rnn = BiRNN(input_size, hidden_size // 2, num_layers=2, dropout=drop_rate, **kw)
        # the banded layers subclass the dense ones, so one module serves
        # both paths under 'auto'
        if graph_impl == "dense":
            self.edge_att = EdgeAtt(g_dim, wp, wf, **kw)
            self.conv1 = DenseRGCN(g_dim, h1_dim, R, num_bases=30, aggr="add", **kw)
            self.conv2 = DenseGraphConv(h1_dim, h2_dim, **kw)
        else:
            self.edge_att = BandedEdgeAtt(g_dim, wp, wf, **kw)
            self.conv1 = BandedRGCN(g_dim, h1_dim, R, n_speakers, wp, wf, num_bases=30, aggr="add", **kw)
            self.conv2 = BandedGraphConv(h1_dim, h2_dim, wp, wf, **kw)
        self.clf_lin1 = Linear(g_dim + h2_dim, hc_dim, **kw)
        self.clf_lin2 = Linear(hc_dim, n_classes, **kw)
        self.dropout = Dropout(drop_rate)

    def forward(self, batch) -> torch.Tensor:
        x = batch["input_tensor"]
        mask = batch["attention_mask"]
        speakers = batch["speaker_ids"]
        lengths = batch["text_length"]
        L = x.shape[1]
        feats = self.rnn(x, mask)
        impl = self.graph_impl
        if impl == "auto":
            impl = "banded" if L > 256 else "dense"
        if impl == "banded":
            enorm_band = self.edge_att(feats, mask)
            g = self.conv1(feats, speakers, mask, edge_norm_band=enorm_band)
            g = self.conv2(g, mask)
        else:
            edge_norm = EdgeAtt.forward(self.edge_att, feats, lengths)
            adj = graphs.window_adjacency(lengths, L, self.wp, self.wf)
            rel = graphs.relation_ids(speakers, self.n_speakers)
            g = DenseRGCN.forward(self.conv1, feats, adj, rel, edge_norm=edge_norm)
            g = DenseGraphConv.forward(self.conv2, g, adj)
        h = self.dropout(torch.relu(self.clf_lin1(torch.cat([feats, g], -1))))
        return self.clf_lin2(h)


def build(p: DGCNParams, *, generator=None, device=None) -> DGCNModule:
    """The module that ``p`` describes (``p.iparams()`` already applied)."""
    return DGCNModule(
        input_size=p.hidden_all, hidden_size=p.hidden_size, n_speakers=p.n_speakers, wp=p.wp, wf=p.wf,
        n_classes=p.n_classes, drop_rate=p.drop_rate, graph_impl=p.graph_impl, generator=generator,
        device=device,
    )


class DGCNTrainer(Trainer):
    """Adam from the config, no clip and no plateau controller, and the
    IEMOCAP-6 class weights for 6 classes, as the JAX ``DGCNTrainer``
    (dgcn.py:185-200)."""

    check_compute_dtype = refuse_banded_compute_dtype

    flax_module = "dgcn"

    def imodels(self, params: DGCNParams):
        generator = torch.Generator().manual_seed(int(params.seed))
        self.model = build(params, generator=generator, device=self.device)
        self.optimizer = optim_factory.build_optim(params.optim, self.model.named_parameters(), self.device)
        if params.get("loss_weights", True) and params.n_classes == 6:
            self.class_weights = torch.tensor(IEMOCAP6_LOSS_WEIGHTS, dtype=torch.float32, device=self.device)


def main(argv: Optional[list] = None) -> DGCNTrainer:
    """``python -m erc_tpu_torch.train --module=dgcn [--dataset=...] ...``:
    train, then save the model (``model.last.ckpt`` under ``--save_dir``)."""
    return train_main(DGCNTrainer, DGCNParams, argv)
