"""DialogueGCN v2 ("dgcnv2"): a selectable base encoder (DialogueRNN, a
biLSTM, a biGRU or a linear layer) → windowed graph with MaskedEdgeAttention
weights → RGCN of 30 bases + GraphConv → nodal attention → MLP head; and its
DailyDialog token track ("dgcnv2_daily"), where a TextCNN encodes each
utterance's word ids first.

Port of ``erc_tpu.models.dgcnv2``.

- ``DialogueRNNScan`` is DialogueRNN's recurrence (global, party and emotion
  GRU cells with matching attention over the earlier global states) as a
  Python loop over the positions, forward and, through ``reverse_padded``,
  backward.  Like the JAX scan it runs every padded step, so padded
  positions carry emotions into the graph.  The input projections that do
  not depend on the recurrence are taken once for all positions; the
  history of global states grows by one ``torch.cat`` a step (an in-place
  write would break the backward of the earlier steps' attention).
- ``base_model='LSTM'`` / ``'GRU'``: ``ops.rnn.BiRNN`` (cuDNN in full float32
  on the card), over each dialogue's valid prefix (the masked form), or over
  every padded step with ``lstm_mode='unpacked'``.
- The graph is dense ([B, L, L], ``ops.gnn.DenseRGCN`` and
  ``DenseGraphConv``), as in the JAX module: this family launches none of
  the hand-written kernels.
- ``CNNFeatureExtractor``: embedding (no padding row: word padding runs
  through the convolutions, as flax's ``nn.Embed`` has it) → one ``Conv1d``
  per kernel size (all of them one matrix product, ``ops.conv.conv1d_gemm``)
  → relu → max over words → Linear → relu.

``DGCNV2Trainer`` trains the feature track as the JAX ``DGCNV2Trainer``
does: Adam 3e-4 with no weight decay, no clip, no plateau controller, and the
IEMOCAP-6 class weights at 6 classes.  ``DGCNV2DailyTrainer`` trains the
token track (no class weights) on ``DailyBatcher``'s static-length batches::

    python -m erc_tpu_torch.train --module=dgcnv2 --dataset=synthetic-cogmen-6 \\
        [--base_model=DialogRNN|LSTM|GRU|None] [--lstm_mode=packed|unpacked] [--device=cpu]
    python -m erc_tpu_torch.train --module=dgcnv2_daily --dataset=synthetic-daily-token-7 [--device=cpu]
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from erc_tpu_torch.core.params import Params
from erc_tpu_torch.data.loader import DialogueLoader
from erc_tpu_torch.data.registry import get_root, pick_datas
from erc_tpu_torch.data.synthetic import synthetic_daily
from erc_tpu_torch.models.base import MMBaseParams
from erc_tpu_torch.models.dgcn import IEMOCAP6_LOSS_WEIGHTS
from erc_tpu_torch.ops import graphs
from erc_tpu_torch.ops.attention import Linear, linear, masked_softmax
from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.gnn import DenseGraphConv, DenseRGCN
from erc_tpu_torch.ops.init import lecun_normal_, normal_, uniform_
from erc_tpu_torch.ops.conv import conv1d_gemm
from erc_tpu_torch.ops.rnn import BiRNN, gru_cell, reverse_padded
from erc_tpu_torch.parallel import mesh
from erc_tpu_torch.train import optim as optim_factory
from erc_tpu_torch.train.trainer import Trainer, main as train_main, refuse_compute_dtype

BASE_MODELS = ("LSTM", "DialogRNN", "GRU", "None")


class DGCNV2Params(MMBaseParams):
    def __init__(self):
        super().__init__()
        self.train.batch_size = 32
        self.test.batch_size = 32
        self.base_model = self.choice(*BASE_MODELS)
        self.dataset = "iemocap-cogmen-6"
        self.epoch = 55
        self.optim = Params(name="Adam", lr=0.0003, weight_decay=0.0)
        self.loss_weights = True
        self.speaker_onehot = True
        self.wp = 10
        self.wf = 10
        self.hidden_size = 100
        # LSTM/GRU base encoders only: 'packed' masks the recurrence like torch
        # packed sequences; 'unpacked' runs every padded step, as the
        # reference's pack-free biRNN does
        self.lstm_mode = self.choice("packed", "unpacked")


ParamsType = DGCNV2Params


def _gru_cell_params(mod: nn.Module, name: str, in_dim: int, hidden: int, *, generator=None, device=None):
    """The JAX ``_GRUCellParams``: torch-layout GRUCell weights ``{name}_w_ih``
    [3H, in], ``{name}_w_hh`` [3H, H], ``{name}_b_ih``, ``{name}_b_hh``
    registered on ``mod``, U(±1/√H)."""
    scale = 1.0 / math.sqrt(hidden)
    for kind, shape in (("w_ih", (3 * hidden, in_dim)), ("w_hh", (3 * hidden, hidden)),
                        ("b_ih", (3 * hidden,)), ("b_hh", (3 * hidden,))):
        t = nn.Parameter(torch.empty(shape, device=device))
        with torch.no_grad():
            uniform_(t, scale, generator=generator)
        mod.register_parameter(f"{name}_{kind}", t)


class DialogueRNNScan(nn.Module):
    """DialogueRNN (the reference's dgcnv2_models.py:235-347) over [B, L, D_m].

    Step t: the global GRU over [u_t, q_speaker]; the 'general' matching
    attention of u_t·att_transformᵀ over the global states of the strictly
    earlier steps (c = 0 at t = 0); the party GRU on every party's state
    with input [u_t, c], kept only for the speaker (one-hot gate); the
    emotion GRU over the speaker's new party state; dropout on g, the party
    states and e.  The speaker of a step is the argmax of its one-hot row,
    so a padded step (an all-zero row) updates party 0, as in the JAX scan.
    """

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int, dropout: float = 0.5, n_parties: int = 2, *,
                 generator=None, device=None):
        super().__init__()
        self.D_m, self.n_parties = D_m, n_parties
        kw = dict(generator=generator, device=device)
        _gru_cell_params(self, "g_cell", D_m + D_p, D_g, **kw)
        _gru_cell_params(self, "p_cell", D_m + D_g, D_p, **kw)
        _gru_cell_params(self, "e_cell", D_p, D_e, **kw)
        self.att_transform = nn.Parameter(torch.empty(D_g, D_m, device=device))
        with torch.no_grad():
            uniform_(self.att_transform, 1.0 / math.sqrt(D_m), generator=generator)
        self.dropout = Dropout(dropout)

    def forward(self, U: torch.Tensor, qmask: torch.Tensor) -> torch.Tensor:
        """U: [B, L, D_m]; qmask: [B, L, P] one-hot speakers (0 at padding).
        Returns the emotions [B, L, D_e] at every position, padding included."""
        B, L, _ = U.shape
        D_m, P = self.D_m, self.n_parties
        D_g, D_p, D_e = self.g_cell_w_hh.shape[1], self.p_cell_w_hh.shape[1], self.e_cell_w_hh.shape[1]
        # the projections of u_t, for every t at once; the rest of each input
        # projection is added in its step
        Ug = F.linear(U, self.g_cell_w_ih[:, :D_m], self.g_cell_b_ih)  # [B, L, 3 D_g]
        Up = F.linear(U, self.p_cell_w_ih[:, :D_m], self.p_cell_b_ih)  # [B, L, 3 D_p]
        xq = U @ self.att_transform.T  # [B, L, D_g]
        wg_q, wp_c = self.g_cell_w_ih[:, D_m:].T, self.p_cell_w_ih[:, D_m:].T
        sel = qmask.argmax(-1)[:, :, None, None].expand(B, L, 1, D_p)  # the speaker's party, 0 at padding
        gate = qmask[..., None]  # [B, L, P, 1]
        keep = 1.0 - gate
        # every step's dropout masks, drawn at once (None where dropout is off)
        mg, mq, me = (self.dropout.masks(shape, U) for shape in ((L, B, D_g), (L, B, P, D_p), (L, B, D_e)))

        g = U.new_zeros(B, D_g)
        q = U.new_zeros(B, P, D_p)
        e = U.new_zeros(B, D_e)
        hist = None  # [B, t, D_g]: the global states of steps 0 .. t-1
        es = []
        for t in range(L):
            q_sel = q.gather(1, sel[:, t])[:, 0]
            g = gru_cell(torch.addmm(Ug[:, t], q_sel, wg_q), g, self.g_cell_w_hh, self.g_cell_b_hh)
            if mg is not None:
                g = g * mg[t]
            if t == 0:
                x_p = Up[:, 0]
            else:
                # a softmax over the t earlier states only: the JAX scan's masked
                # softmax over all L gives the later ones weight exactly 0
                alpha = torch.softmax(torch.bmm(hist, xq[:, t, :, None]), 1)  # [B, t, 1]
                c = torch.bmm(alpha.transpose(1, 2), hist)[:, 0]
                x_p = torch.addmm(Up[:, t], c, wp_c)
            qs = gru_cell(x_p[:, None], q, self.p_cell_w_hh, self.p_cell_b_hh)  # [B, P, D_p]
            if mq is not None:
                qs = qs * mq[t]
            q = q * keep[:, t] + qs * gate[:, t]
            q_sel = q.gather(1, sel[:, t])[:, 0]
            e = gru_cell(F.linear(q_sel, self.e_cell_w_ih, self.e_cell_b_ih), e, self.e_cell_w_hh,
                         self.e_cell_b_hh)
            if me is not None:
                e = e * me[t]
            es.append(e)
            if t < L - 1:
                hist = g[:, None] if hist is None else torch.cat([hist, g[:, None]], 1)
        return torch.stack(es, 1)


class MaskedEdgeAttentionDense(nn.Module):
    """'attn1' edge weights (dgcnv2_models.py:541-562) in dense form:
    α[b, u, v] = softmax over v in window(u) of W[u]·x_v."""

    def __init__(self, input_dim: int, max_seq_len: int, wp: int, wf: int, *, generator=None, device=None):
        super().__init__()
        self.wp, self.wf = wp, wf
        self.scalar = nn.Parameter(torch.empty(max_seq_len, input_dim, device=device))
        with torch.no_grad():
            uniform_(self.scalar, 1.0 / math.sqrt(input_dim), generator=generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        L = x.shape[1]
        logits = torch.einsum("ud,bvd->buv", self.scalar[:L], x)
        win = graphs.window_adjacency(lengths, L, self.wp, self.wf)
        return masked_softmax(logits, win, dim=-1, mode="where")


class CNNFeatureExtractor(nn.Module):
    """Token-level TextCNN utterance encoder (the reference's
    dgcnv2_models.py:776-816): embedding → one ``Conv1d`` per kernel size
    over the words (VALID) → relu → max over words → concat → dropout →
    Linear → relu, masked.  Token ids [B, L, W] → [B, L, output_size].

    Weights as flax initialises them: the embedding N(0, 1) with no padding
    row, the convolutions and the Linear lecun-normal with zero bias.
    ``conv_{K}.weight`` is [F, E, K] (flax's kernel is [K, E, F]).  The
    convolutions run as one matrix product (``ops.conv.conv1d_gemm``)."""

    def __init__(self, vocab_size: int, embedding_dim: int = 300, output_size: int = 100, filters: int = 50,
                 kernel_sizes=(3, 4, 5), dropout: float = 0.5, *, generator=None, device=None):
        super().__init__()
        self.kernel_sizes = tuple(kernel_sizes)
        self.embedding = nn.Embedding(vocab_size, embedding_dim, device=device)
        with torch.no_grad():
            normal_(self.embedding.weight, 1.0, generator=generator)
        for K in self.kernel_sizes:
            conv = nn.Conv1d(embedding_dim, filters, K, device=device)
            with torch.no_grad():
                lecun_normal_(conv.weight, fan_in=K * embedding_dim, generator=generator)
                conv.bias.zero_()
            self.add_module(f"conv_{K}", conv)
        self.fc = Linear(len(self.kernel_sizes) * filters, output_size, generator=generator, device=device)
        self.dropout = Dropout(dropout)

    def forward(self, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, W = token_ids.shape
        emb = self.embedding(token_ids.reshape(B * L, W).long())  # [BL, W, E]
        convs = [getattr(self, f"conv_{K}") for K in self.kernel_sizes]
        pooled = [torch.relu(c).amax(1) for c in conv1d_gemm(emb, convs)]  # each [BL, W - K + 1, F] -> [BL, F]
        h = torch.relu(self.fc(self.dropout(torch.cat(pooled, -1))))
        return h.reshape(B, L, -1) * mask[..., None]


class DGCNV2Module(nn.Module):
    def __init__(self, base_model: str, input_size: int, hidden_size: int = 100, n_speakers: int = 2,
                 wp: int = 10, wf: int = 10, n_classes: int = 7, dropout_rec: float = 0.5, drop_rate: float = 0.4,
                 max_seq_len: int = 110, graph_hidden_size: int = 100, d_g: int = 150, d_p: int = 150,
                 vocab_size: int = 0, embedding_dim: int = 300, cnn_output_size: int = 100, cnn_filters: int = 50,
                 cnn_kernel_sizes=(3, 4, 5), cnn_dropout: float = 0.5, lstm_mode: str = "packed", *,
                 generator=None, device=None):
        super().__init__()
        if base_model not in BASE_MODELS:
            raise ValueError(f"unknown base_model {base_model!r}: use one of {BASE_MODELS}")
        if lstm_mode not in ("packed", "unpacked"):
            raise ValueError(f"unknown lstm_mode {lstm_mode!r}")
        kw = dict(generator=generator, device=device)
        self.base_model, self.lstm_mode = base_model, lstm_mode
        self.n_speakers, self.wp, self.wf = n_speakers, wp, wf
        H2 = 2 * hidden_size
        if vocab_size:
            self.cnn_feat_extractor = CNNFeatureExtractor(vocab_size, embedding_dim, cnn_output_size, cnn_filters,
                                                          cnn_kernel_sizes, cnn_dropout, **kw)
        if base_model == "DialogRNN":
            self.dialog_rnn_f = DialogueRNNScan(input_size, d_g, d_p, hidden_size, dropout_rec, n_speakers, **kw)
            self.dialog_rnn_r = DialogueRNNScan(input_size, d_g, d_p, hidden_size, dropout_rec, n_speakers, **kw)
        elif base_model in ("LSTM", "GRU"):
            self.rnn = BiRNN(input_size, hidden_size, num_layers=2, dropout=drop_rate, cell=base_model.lower(), **kw)
        else:
            self.base_linear = Linear(input_size, H2, **kw)
        self.att_model = MaskedEdgeAttentionDense(H2, max_seq_len, wp, wf, **kw)
        self.conv1 = DenseRGCN(H2, graph_hidden_size, 2 * n_speakers**2, num_bases=30, aggr="add", **kw)
        self.conv2 = DenseGraphConv(graph_hidden_size, graph_hidden_size, **kw)
        D = H2 + graph_hidden_size
        self.matchatt_w = nn.Parameter(torch.empty(D, D, device=device))
        self.matchatt_b = nn.Parameter(torch.empty(D, device=device))
        with torch.no_grad():
            for t in (self.matchatt_w, self.matchatt_b):
                uniform_(t, 1.0 / math.sqrt(D), generator=generator)
        self.linear = Linear(D, graph_hidden_size, **kw)
        self.smax_fc = Linear(graph_hidden_size, n_classes, **kw)
        # the head's dropout is 0.5 whatever drop_rate is, and only where drop_rate > 0
        self.dropout = Dropout(0.5 if drop_rate > 0 else 0.0)

    def _encode(self, x, batch, mask):
        if self.base_model == "DialogRNN":
            qmask = F.one_hot(batch["speaker_ids"].long(), self.n_speakers).to(x.dtype) * mask[..., None]
            f = self.dialog_rnn_f(x, qmask)
            b = self.dialog_rnn_r(reverse_padded(x, mask), reverse_padded(qmask, mask))
            return torch.cat([f, reverse_padded(b, mask)], -1)
        if self.base_model in ("LSTM", "GRU"):
            if self.lstm_mode == "packed":
                return self.rnn(x, mask)  # padded steps masked
            return self.rnn(x)  # every padded step, unpacked
        return self.base_linear(x)

    def forward(self, batch) -> torch.Tensor:
        mask = batch["attention_mask"]
        if hasattr(self, "cnn_feat_extractor"):
            x = self.cnn_feat_extractor(batch["token_ids"], mask)
        else:
            x = batch["input_tensor"]
        lengths = batch["text_length"]
        L = x.shape[1]
        emotions = self._encode(x, batch, mask)
        edge_norm = self.att_model(emotions, lengths)
        adj = graphs.window_adjacency(lengths, L, self.wp, self.wf)
        rel = graphs.relation_ids(batch["speaker_ids"], self.n_speakers)
        g = self.conv2(self.conv1(emotions, adj, rel, edge_norm=edge_norm), adj)
        em = torch.cat([emotions, g], -1)
        # nodal attention (MatchingAttention 'general2' over every valid node):
        # tanh scores with the keys masked, a softmax over every key, then
        # masked and renormalised
        xq = linear(em, self.matchatt_w, self.matchatt_b)  # em is float32 in a bfloat16 step: the GraphConv's sum
        scores = torch.tanh(torch.einsum("bqd,bkd->bqk", xq, em * mask[:, :, None]) * mask[:, None, :])
        alpha = torch.softmax(scores, -1) * mask[:, None, :]
        alpha = alpha / alpha.sum(-1, keepdim=True).clamp_min(1e-10)
        h = torch.relu(self.linear(torch.einsum("bqk,bkd->bqd", alpha, em)))
        return self.smax_fc(self.dropout(h))


def build(p, *, generator=None, device=None) -> DGCNV2Module:
    """The module that ``p`` describes (``p.iparams()`` already applied): the
    feature track from ``DGCNV2Params``, the token track from
    ``DGCNV2DailyParams`` (its ``vocab_size``; the TextCNN's 100 outputs feed
    the base encoder)."""
    vocab_size = int(p.get("vocab_size", 0) or 0)
    return DGCNV2Module(
        base_model=p.base_model, input_size=100 if vocab_size else p.hidden_all, hidden_size=p.hidden_size,
        n_speakers=p.n_speakers, wp=p.wp, wf=p.wf, n_classes=p.n_classes, max_seq_len=int(p.max_seq_len),
        d_g=int(p.get("d_g", 150)), d_p=int(p.get("d_p", 150)), vocab_size=vocab_size,
        embedding_dim=int(p.get("embedding_dim", 300)), lstm_mode=p.get("lstm_mode", "packed"),
        generator=generator, device=device,
    )


class DailyBatcher:
    """Token-dialogue batcher for the DailyDialog track: pads to
    [B, max_len, n_words] int32 token ids plus the mask, speaker, length and
    label keys; ``input_tensor`` is None.  The length is static (``max_len``)."""

    def __init__(self, n_words: int = 50, max_len: int = 110, pad_batch_to=None):
        self.n_words = n_words
        self.max_len = max_len
        self.pad_batch_to = pad_batch_to

    def __call__(self, samples):
        return self._collate(samples, self.pad_batch_to or len(samples))

    def shard(self, samples, rank: int, world: int):
        """Rank ``rank``'s rows ``rank, rank + world, ...`` of the batch of
        ``samples``, padded to ⌈Bp / world⌉ rows (the length is static)."""
        return self._collate(samples[rank::world], -(-(self.pad_batch_to or len(samples)) // world))

    def _collate(self, samples, Bp: int):
        lens = np.array([min(len(s["label"]), self.max_len) for s in samples], np.int32)
        L, W = self.max_len, self.n_words
        tok = np.zeros((Bp, L, W), np.int32)
        spk = np.zeros((Bp, L), np.int32)
        label = np.full((Bp, L), -1, np.int32)
        mask = np.zeros((Bp, L), np.float32)
        for i, s in enumerate(samples):
            ln = lens[i]
            for j in range(ln):
                row = np.asarray(s["tokens"][j], np.int32)[:W]
                tok[i, j, : len(row)] = row
            spk[i, :ln] = np.asarray(s["speakers"], np.int32)[:ln]
            label[i, :ln] = np.asarray(s["label"], np.int32)[:ln]
            mask[i, :ln] = 1.0
        lens_p = np.zeros(Bp, np.int32)
        lens_p[: len(lens)] = lens
        return {
            "token_ids": tok,
            "attention_mask": mask,
            "speaker_ids": spk,
            "speaker_tensor": spk,
            "text_length": lens_p,
            "label": label,
            "input_tensor": None,
        }


class DGCNV2Trainer(Trainer):
    """Adam from the config, no clip and no plateau controller, and the
    IEMOCAP-6 class weights for 6 classes, as the JAX ``DGCNV2Trainer``
    (dgcnv2.py:374-391)."""

    flax_module = "dgcnv2"

    def check_compute_dtype(self, params) -> None:
        """bfloat16 trains the biRNN and linear bases: DialogueRNN's JAX scan
        turns its party and emotion states float32 in a bfloat16 step."""
        if self.compute_dtype != torch.float32 and params.base_model == "DialogRNN":
            refuse_compute_dtype("--base_model=DialogRNN", "erc_tpu/models/dgcnv2.py:156, DialogueRNNScan's "
                                 "lax.scan: carry input bfloat16, carry output float32")

    def imodels(self, params):
        generator = torch.Generator().manual_seed(int(params.seed))
        self.model = build(params, generator=generator, device=self.device)
        self.optimizer = optim_factory.build_optim(params.optim, self.model.named_parameters(), self.device)
        if params.get("loss_weights", True) and params.n_classes == 6:
            self.class_weights = torch.tensor(IEMOCAP6_LOSS_WEIGHTS, dtype=torch.float32, device=self.device)


def main(argv: Optional[list] = None) -> DGCNV2Trainer:
    """``python -m erc_tpu_torch.train --module=dgcnv2 [--dataset=...] ...``:
    train, then save the model (``model.last.ckpt`` under ``--save_dir``)."""
    return train_main(DGCNV2Trainer, DGCNV2Params, argv)


class DGCNV2DailyParams(DGCNV2Params):
    def __init__(self):
        super().__init__()
        # the real corpus is dailydialog-token-7 (data/dailydialog.py);
        # synthetic-daily-token-7 generates token dialogues in memory
        self.dataset = "dailydialog-token-7"
        self.vocab_size = 20000
        self.n_words = 50
        self.embedding_dim = 300


class DGCNV2DailyTrainer(DGCNV2Trainer):
    """The DailyDialog track: ``CNNFeatureExtractor`` over token ids feeding
    the dgcnv2 pipeline (the reference's DialogueGCN_DailyModel), Adam from
    the config and no class weights, as the JAX ``DGCNV2DailyTrainer``."""

    flax_module = "dgcnv2_daily"

    def imodels(self, params):
        super().imodels(params)
        self.class_weights = None

    def _daily_batcher(self, batch_size: int) -> DailyBatcher:
        return DailyBatcher(n_words=int(self.params.n_words), max_len=int(self.params.get("max_seq_len", 110)),
                            pad_batch_to=int(batch_size))

    def make_loader(self, split: str) -> DialogueLoader:
        """The split through the registry (a real dump raises where it is
        absent; only synthetic names take ``n_train``), shuffled for training,
        not sorted by length, each batch padded to the batch size."""
        p = self.params
        root = p.get("data_root") or get_root(p.dataset)
        kw = {"vocab_size": int(p.vocab_size)}
        if p.dataset.startswith("synthetic-"):
            kw["n_train"] = int(p.get("synthetic_n_train", 24))
        samples = pick_datas(root, p.dataset, split=split, **kw)
        bs = int(p.train.batch_size if split == "train" else p.test.batch_size)
        bc = p.get("batch_count")
        return DialogueLoader(samples, self._daily_batcher(bs), batch_size=bs, shuffle=(split == "train"),
                              seed=p.seed, batch_count=(int(bc) if bc and split == "train" else None),
                              rank=mesh.process_index(), world=mesh.process_count())

    def example_batch(self, L: int = 12, B: int = 2):
        samples = synthetic_daily(self.params.n_classes, "train", n_train=B, min_len=L, max_len=L,
                                  vocab=int(self.params.vocab_size))
        return self._daily_batcher(B)(samples)


def daily_main(argv: Optional[list] = None) -> DGCNV2DailyTrainer:
    """``python -m erc_tpu_torch.train --module=dgcnv2_daily [--dataset=...] ...``:
    train, then save the model."""
    return train_main(DGCNV2DailyTrainer, DGCNV2DailyParams, argv)
