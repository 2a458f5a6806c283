"""COGMEN: COntextualized GNN based Multimodal Emotion recognitioN.

Port of ``erc_tpu.models.cogmen``: transformer context encoder → windowed
speaker-relation graph → RGCN + graph-transformer conv → BN → MLP head.

- ``encoder_mode='reference'`` (default) reproduces the reference's encoder
  loop, which applies each module to the *original* input, so node features
  are Linear(input); ``'chained'`` runs transformer → linear.
- ``graph_impl='banded'`` runs the band kernels (ops.gnn_banded), ``'dense'``
  the [B, L, L] masked layers, and ``'auto'`` picks banded only for
  L > 256, as the JAX module does.  All three share one set of weights.

``COGMENTrainer`` trains it as the JAX ``COGMENTrainer`` does: Adam with the
L2 term folded into the gradient, no clip, no plateau controller.  With
``graph_impl='banded'`` the band kernels' autograd Functions carry the
gradient (``ops/kernels/banded.py``)::

    python -m erc_tpu_torch.train --module=cogmen --dataset=synthetic-cogmen-6 \
        --encoder_mode=chained --graph_impl=banded [--epoch=N] [--device=cpu]
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from erc_tpu_torch.models.base import MMBaseParams
from erc_tpu_torch.ops import graphs
from erc_tpu_torch.ops.attention import Linear, TransformerEncoder
from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.gnn import DenseRGCN, DenseTransformerConv
from erc_tpu_torch.ops.gnn_banded import BandedRGCN, BandedTransformerConv
from erc_tpu_torch.ops.norm import MaskedBatchNorm
from erc_tpu_torch.core.params import Params
from erc_tpu_torch.train import optim as optim_factory
from erc_tpu_torch.train.trainer import Trainer, main as train_main, refuse_banded_compute_dtype


class COGMENParams(MMBaseParams):
    def __init__(self):
        super().__init__()
        self.train.batch_size = 32
        self.val.batch_size = 32
        self.test.batch_size = 32

        self.num_heads = 17
        self.dataset = "iemocap-cogmen-6"
        self.epoch = 55
        self.optim = Params(name="Adam", lr=0.0001, weight_decay=1e-8)
        self.wp = 5
        self.wf = 5
        self.hidden_size = 100
        self.drop_rate = 0.5
        self.graph_impl = self.choice("auto", "dense", "banded")
        self.encoder_mode = self.choice("reference", "chained")


ParamsType = COGMENParams


def pick_num_heads(input_size: int, num_heads: int) -> int:
    """First h in [6, num_heads) dividing input_size."""
    for h in range(6, num_heads):
        if input_size % h == 0:
            return h
    raise ValueError(f"no valid head count for input_size={input_size}")


class GNN(nn.Module):
    """RGCNConv → TransformerConv → BN → LeakyReLU."""

    def __init__(self, g_dim: int, h1_dim: int, h2_dim: int, n_speakers: int = 2, wp: int = 5,
                 wf: int = 5, graph_impl: str = "banded", *, generator=None, device=None):
        super().__init__()
        if graph_impl not in ("auto", "dense", "banded"):
            raise ValueError(f"unknown graph_impl {graph_impl!r}")
        self.n_speakers, self.wp, self.wf, self.graph_impl = n_speakers, wp, wf, graph_impl
        kw = dict(generator=generator, device=device)
        R = 2 * n_speakers**2
        # the banded layers subclass the dense ones, so one module serves
        # both paths under 'auto'
        if graph_impl == "dense":
            self.conv1 = DenseRGCN(g_dim, h1_dim, R, aggr="mean", **kw)
            self.conv2 = DenseTransformerConv(h1_dim, h2_dim, **kw)
        else:
            self.conv1 = BandedRGCN(g_dim, h1_dim, R, n_speakers, wp, wf, aggr="mean", **kw)
            self.conv2 = BandedTransformerConv(h1_dim, h2_dim, wp, wf, **kw)
        self.bn = MaskedBatchNorm(h2_dim, device=device)

    def forward(self, x, speakers, lengths, mask):
        impl = self.graph_impl
        if impl == "auto":
            impl = "banded" if x.shape[1] > 256 else "dense"
        if impl == "banded":
            x = self.conv1(x, speakers, mask)
            x = self.conv2(x, mask)
        else:
            L = x.shape[1]
            adj = graphs.window_adjacency(lengths, L, self.wp, self.wf)
            rel = graphs.relation_ids(speakers, self.n_speakers)
            x = DenseRGCN.forward(self.conv1, x, adj, rel)
            x = DenseTransformerConv.forward(self.conv2, x, adj)
        return F.leaky_relu(self.bn(x, mask), negative_slope=0.01)


class COGMENModule(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, num_head: int, n_speakers: int,
                 n_classes: int, wp: int = 5, wf: int = 5, drop_rate: float = 0.5,
                 graph_impl: str = "banded", encoder_mode: str = "reference", *,
                 generator=None, device=None):
        super().__init__()
        if encoder_mode not in ("reference", "chained"):
            raise ValueError(f"unknown encoder_mode {encoder_mode!r}")
        kw = dict(generator=generator, device=device)
        self.encoder_mode = encoder_mode
        if encoder_mode == "chained":
            nhead = pick_num_heads(input_size, num_head)
            self.encoder = TransformerEncoder(input_size, nhead, num_layers=2, dropout=drop_rate, **kw)
        self.transformer_out = Linear(input_size, hidden_size, **kw)
        self.gcn = GNN(hidden_size, hidden_size, hidden_size, n_speakers, wp, wf, graph_impl, **kw)
        self.cls_0 = Linear(hidden_size, 100, **kw)
        self.cls_1 = Linear(100, n_classes, **kw)
        self.dropout = Dropout(drop_rate)

    def forward(self, batch) -> torch.Tensor:
        x = batch["input_tensor"]
        mask = batch["attention_mask"]
        if self.encoder_mode == "chained":
            h = self.encoder(x, key_padding_mask=mask)
        else:
            # the reference applies each encoder module to the ORIGINAL
            # input, so only the final Linear survives
            h = x
        h = self.transformer_out(h)
        g = self.gcn(h, batch["speaker_ids"], batch["text_length"], mask)
        out = self.dropout(torch.relu(self.cls_0(g)))
        return self.cls_1(out)


def build(p: COGMENParams, *, generator=None, device=None) -> COGMENModule:
    """The module that ``p`` describes (``p.iparams()`` already applied)."""
    return COGMENModule(
        input_size=p.hidden_all, hidden_size=p.hidden_size, num_head=p.num_heads,
        n_speakers=p.n_speakers, n_classes=p.n_classes, wp=p.wp, wf=p.wf,
        drop_rate=p.drop_rate, graph_impl=p.graph_impl,
        encoder_mode=p.get("encoder_mode", "reference"), generator=generator, device=device,
    )


class COGMENTrainer(Trainer):
    """Adam from the config, no clip and no plateau controller, as the JAX
    ``COGMENTrainer`` (cogmen.py:158-175)."""

    check_compute_dtype = refuse_banded_compute_dtype

    flax_module = "cogmen"

    def imodels(self, params: COGMENParams):
        generator = torch.Generator().manual_seed(int(params.seed))
        self.model = build(params, generator=generator, device=self.device)
        self.optimizer = optim_factory.build_optim(params.optim, self.model.named_parameters(), self.device)


def main(argv: Optional[list] = None) -> COGMENTrainer:
    """``python -m erc_tpu_torch.train --module=cogmen [--dataset=...] ...``:
    train, then save the model (``model.last.ckpt`` under ``--save_dir``)."""
    return train_main(COGMENTrainer, COGMENParams, argv)
