"""MMGCN: per-modality encoders → speaker embedding on the text nodes → the
(M·L)² angular-similarity graph over every modality's utterances → a deep
GCNII → per-utterance concat → linear head.

Port of ``erc_tpu.models.mmgcn``.

- Encoders: ``linear_a``, ``linear_v``, ``linear_l`` to 200, then on text
  a 2-layer bidirectional LSTM of 100 a direction (``ops.rnn.BiRNN``,
  cuDNN in full float32 on the card).  ``lstm_mode='packed'`` runs over each
  dialogue's valid prefix (the masked form, packed sequences' numbers);
  ``'unpacked'`` runs every padded step, as the reference's
  ``lstm_l`` does (its backward direction consumes the padding).
- ``adj_impl='dense'`` builds the [B, M·L, M·L] adjacency and runs
  ``GCNIIStack``; ``'structured'`` builds its block-sparse form (M dense
  blocks, diagonal cross-modal blocks) and runs ``GCNIIStackStructured``.
  Both give the same features in the same order, from one set of weights.
  The adjacency is built in float32 and cast to the features' dtype (bfloat16
  in a bfloat16 train step), as in JAX.  MMGCN launches none of the hand-written kernels:
  its graph products are ``torch.bmm`` / ``torch.matmul``.
- ``gcn_remat`` (``off``, ``full``, ``dots``) checkpoints each trip of
  ``gcn_chunk`` GCNII layers (``ops.gnn._remat``).

``MMGCNTrainer`` trains it as the JAX ``MMGCNTrainer`` does: Adam from the
config with the L2 term folded into the gradient (3e-4 and 3e-5; with
``--reimplement`` IEMOCAP's 3e-4 / 3e-5 or MELD's 1e-4 / 0), no clip, no
plateau controller, no class weights::

    python -m erc_tpu_torch.train --module=mmgcn --dataset=synthetic-cogmen-6 \\
        [--adj_impl=dense|structured] [--gcn_remat=full|off|dots] \\
        [--lstm_mode=packed|unpacked] [--epoch=N] [--device=cpu]
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from erc_tpu_torch.core.params import Params
from erc_tpu_torch.models.base import MMBaseParams
from erc_tpu_torch.ops import graphs
from erc_tpu_torch.ops.attention import Linear
from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.gnn import GCNIIStack, GCNIIStackStructured
from erc_tpu_torch.ops.init import normal_
from erc_tpu_torch.ops.rnn import BiRNN
from erc_tpu_torch.train import optim as optim_factory
from erc_tpu_torch.train.trainer import Trainer

LSTM_HIDDEN = 100  # a direction
N_DIM = 2 * LSTM_HIDDEN  # every modality's node width: the text biLSTM's output


class MMGCNParams(MMBaseParams):
    def __init__(self):
        super().__init__()
        self.epoch = 60
        self.train.batch_size = 16
        self.test.batch_size = 16
        self.dataset = "iemocap-cogmen-6"
        self.optim = Params(name="Adam", lr=0.0003, weight_decay=3e-5)
        self.speaker_onehot = True
        self.graph_hidden_size = 200
        self.gcn_layers = 64
        self.drop_rate = 0.4
        self.adj_impl = self.choice("dense", "structured")
        self.gcn_remat = self.choice("full", "off", "dots")
        self.gcn_chunk = 8  # GCNII layers a trip (= the checkpoint's granularity)
        self.lstm_mode = self.choice("packed", "unpacked")

    def iparams(self):
        super().iparams()
        if self.reimplement:
            if "iemocap" in self.dataset:
                self.optim.lr = 0.0003
                self.optim.weight_decay = 3e-5
            elif "meld" in self.dataset:
                self.optim.lr = 0.0001
                self.optim.weight_decay = 0


ParamsType = MMGCNParams


class MMGCNModule(nn.Module):
    def __init__(self, hidden_text: int = 100, hidden_audio: int = 100, hidden_visual: int = 512,
                 n_speakers: int = 2, n_classes: int = 7, modals: str = "atv", graph_hidden_size: int = 200,
                 gcn_layers: int = 64, drop_rate: float = 0.4, adj_impl: str = "dense", gcn_remat="full",
                 gcn_chunk: int = 8, lstm_mode: str = "packed", *, generator=None, device=None):
        super().__init__()
        if adj_impl not in ("dense", "structured"):
            raise ValueError(f"unknown adj_impl {adj_impl!r}")
        if lstm_mode not in ("packed", "unpacked"):
            raise ValueError(f"unknown lstm_mode {lstm_mode!r}")
        kw = dict(generator=generator, device=device)
        self.order = [m for m in "avt" if m in modals]  # the reference's [a, v, l]
        self.adj_impl, self.lstm_mode = adj_impl, lstm_mode
        if "a" in modals:
            self.linear_a = Linear(hidden_audio, N_DIM, **kw)
        if "v" in modals:
            self.linear_v = Linear(hidden_visual, N_DIM, **kw)
        if "t" in modals:
            self.linear_l = Linear(hidden_text, N_DIM, **kw)
            self.lstm_l = BiRNN(N_DIM, LSTM_HIDDEN, num_layers=2, dropout=drop_rate, **kw)
            self.speaker_embeddings = nn.Embedding(n_speakers, N_DIM, device=device)
            with torch.no_grad():
                normal_(self.speaker_embeddings.weight, 1.0, generator=generator)
        self.fc0 = Linear(N_DIM, graph_hidden_size, **kw)
        stack = GCNIIStackStructured if adj_impl == "structured" else GCNIIStack
        self.gcnii = stack(gcn_layers, graph_hidden_size, lamda=0.5, alpha=0.1, dropout=drop_rate,
                           remat=gcn_remat, chunk=gcn_chunk, **kw)
        self.smax_fc = Linear(len(self.order) * (N_DIM + graph_hidden_size), n_classes, **kw)
        self.dropout = Dropout(drop_rate)

    def _text(self, batch, mask):
        t = self.linear_l(batch["text_feature"])
        if self.lstm_mode == "packed":
            t = self.lstm_l(t, mask)  # padded steps masked
        else:
            t = self.lstm_l(t)  # every padded step, unpacked
        # the speaker embedding on the text nodes only, as the reference has it
        return t + self.speaker_embeddings(batch["speaker_ids"]) * mask[..., None]

    def forward(self, batch) -> torch.Tensor:
        mask = batch["attention_mask"]
        B, L = mask.shape
        encode = {"a": lambda: self.linear_a(batch["audio_feature"]),
                  "v": lambda: self.linear_v(batch["visual_feature"]),
                  "t": lambda: self._text(batch, mask)}
        feats = [encode[m]() for m in self.order]
        M = len(feats)
        # the adjacency is built in float32 (arccos near ±1 is sensitive to
        # rounding) and aggregates in the features' dtype, as in JAX
        feats32, cdtype = [f.float() for f in feats], feats[0].dtype
        if self.adj_impl == "structured":
            intra, cross = (a.to(cdtype) for a in graphs.mmgcn_structured_adjacency(feats32, mask))
            x = self.dropout(torch.stack(feats, 1))  # [B, M, L, 200]
            h = self.gcnii(torch.relu(self.fc0(x)), intra, cross)
            h = torch.cat([x, self.dropout(h)], -1)
            feat = h.transpose(1, 2).reshape(B, L, -1)
        else:
            adj = graphs.mmgcn_big_adjacency(feats32, mask).to(cdtype)
            x = self.dropout(torch.cat(feats, 1))  # [B, M·L, 200]
            h = self.gcnii(torch.relu(self.fc0(x)), adj)
            h = torch.cat([x, self.dropout(h)], -1)
            # each utterance's modal nodes side by side: [B, L, M·(200 + hidden)]
            feat = torch.cat(h.chunk(M, dim=1), -1)
        return self.smax_fc(torch.relu(self.dropout(feat)))


def build(p: MMGCNParams, *, generator=None, device=None) -> MMGCNModule:
    """The module that ``p`` describes (``p.iparams()`` already applied)."""
    return MMGCNModule(
        hidden_text=p.hidden_text, hidden_audio=p.hidden_audio, hidden_visual=p.hidden_visual,
        n_speakers=p.n_speakers, n_classes=p.n_classes, modals=p.modality,
        graph_hidden_size=p.graph_hidden_size, gcn_layers=p.gcn_layers, drop_rate=p.drop_rate,
        adj_impl=p.adj_impl, gcn_remat=p.get("gcn_remat", "full"), gcn_chunk=int(p.get("gcn_chunk", 8)),
        lstm_mode=p.get("lstm_mode", "packed"), generator=generator, device=device,
    )


class MMGCNTrainer(Trainer):
    """Adam from the config with L2 in the gradient, no clip, no plateau
    controller and no class weights, as the JAX ``MMGCNTrainer``
    (mmgcn.py:194-211)."""

    flax_module = "mmgcn"

    def imodels(self, params: MMGCNParams):
        generator = torch.Generator().manual_seed(int(params.seed))
        self.model = build(params, generator=generator, device=self.device)
        self.optimizer = optim_factory.build_optim(params.optim, self.model.named_parameters(), self.device)


def main(argv: Optional[list] = None) -> MMGCNTrainer:
    """``python -m erc_tpu_torch.train --module=mmgcn [--dataset=...] ...``:
    train, then save the model (``model.last.ckpt`` under ``--save_dir``)."""
    params = MMGCNParams()
    params.finalize(argv)
    trainer = MMGCNTrainer(params)
    trainer.train()
    trainer.save_model()
    return trainer
