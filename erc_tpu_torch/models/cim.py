"""CIM: contextual inter-modal attention with two heads.

Port of ``erc_tpu.models.cim``: a one-layer biGRU per modality (audio,
visual, text; ``ops.rnn.BiRNN``, one cuDNN call each on the card, in full
float32, packed in the training steps and masked elsewhere) → dropout → an
adapter ``Linear(2H → 100)`` + ReLU → dropout → the six pairwise cross-modal
attentions (``softmax(x·yᵀ + mask)·y ⊙ x``) → their concatenation with the
three adapted modalities (9 × 100) → a sentiment head ``cls2`` and a 7-way
multi-label emotion head ``cls7``.  The forward returns ``(logits2, logits7)``.

- The attention's mask is additive, ``(1 − mask) · −10000`` over the keys,
  as the reference writes it: a dialogue of padding only gets a uniform
  softmax, and padded positions get nonzero logits (their adapted features
  are ``relu(bias)``).  The JAX module computes the same, and the tests
  compare every position.
- ``fused_rnn`` is accepted (``resolve_fused_rnn``): in the JAX package it
  runs the three biGRUs as one scan, with the same parameters and the same
  math.  The three inputs differ in width, so one cuDNN call cannot take
  them, and the port runs three calls whatever the flag says.
- No hand-written kernel runs: the attentions are ``torch.bmm``, as the JAX
  module's are ``einsum``s.

``CIMTrainer`` trains as the JAX ``CIMTrainer``: Adam 1e-3, batch 16, no
clip and no plateau controller; the loss is the masked cross-entropy of
``cls2`` (``apply_bin``) plus, on MOSEI batches that carry ``emo_label``,
the masked BCE of ``cls7`` (``apply_multi``).  On MOSEI at 2 classes its
test stage adds the multilabel block (``train.metrics.mosei_multilabel_summary``)
under ``"multilabel"``::

    python -m erc_tpu_torch.train --module=cim --dataset=synthetic-mosei-2 [--select_on=val] [--device=cpu]
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from erc_tpu_torch.core.params import Params
from erc_tpu_torch.models.base import MMBaseParams
from erc_tpu_torch.ops.attention import Linear
from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.rnn import BiRNN
from erc_tpu_torch.train import optim as optim_factory
from erc_tpu_torch.train.metrics import mosei_multilabel_summary
from erc_tpu_torch.train.trainer import Trainer, masked_accuracy, masked_cross_entropy

MODALITIES = (("a", "audio_feature"), ("v", "visual_feature"), ("t", "text_feature"))
ADAPTER = 100


class CIMParams(MMBaseParams):
    def __init__(self):
        super().__init__()
        self.train.batch_size = 16
        self.val.batch_size = 32
        self.test.batch_size = 32
        self.num_heads = 17
        self.dataset = "iemocap-cogmen-6"
        self.epoch = 55
        self.optim = Params(name="Adam", lr=0.001, weight_decay=0.0)
        self.apply_multi = True
        self.apply_bin = True
        self.metric = "multiemo"
        self.hidden_size = 200
        # the JAX package's one scan for the three biGRUs: 'auto' fuses where
        # every stage's batch is at most 32; the port runs three calls either way
        self.fused_rnn = "auto"

    def iparams(self):
        super().iparams()
        if "mosei" not in self.dataset:
            self.apply_multi = False
        if self.n_classes != 2:
            self.mosei_metric = ""


ParamsType = CIMParams


def resolve_fused_rnn(params) -> bool:
    """``--fused_rnn=auto|on|off`` → bool, as the JAX package resolves it:
    ``auto`` is on where the train, val and test batches are all ≤ 32."""
    v = params.get("fused_rnn", "auto")
    if isinstance(v, bool):
        return v
    f = str(v).lower()
    if f == "auto":
        return max(int(params.train.batch_size), int(params.val.batch_size), int(params.test.batch_size)) <= 32
    return f in ("on", "true", "1", "yes")


class CIMModule(nn.Module):
    def __init__(self, text_dim: int, audio_dim: int, visual_dim: int, hidden_size: int, n_classes: int,
                 drop0: float = 0.3, drop1: float = 0.3, fused_rnn: bool = True, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.fused_rnn = fused_rnn  # the same parameters and math either way (module docstring)
        dims = {"a": audio_dim, "v": visual_dim, "t": text_dim}
        for m, _ in MODALITIES:
            setattr(self, f"rnn_{m}", BiRNN(dims[m], hidden_size, num_layers=1, cell="gru", **kw))
        for m, _ in MODALITIES:
            setattr(self, f"adapter_{m}", Linear(2 * hidden_size, ADAPTER, **kw))
        self.cls2 = Linear(9 * ADAPTER, n_classes, **kw)
        self.cls7 = Linear(9 * ADAPTER, 7, **kw)
        self.drop0 = Dropout(drop0)
        self.drop1 = Dropout(drop1)

    def forward(self, batch):
        mask = batch["attention_mask"]
        dense = {}
        for m, key in MODALITIES:
            h = self.drop0(getattr(self, f"rnn_{m}")(batch[key], mask))
            dense[m] = self.drop1(torch.relu(getattr(self, f"adapter_{m}")(h)))
        key_mask = (1.0 - mask[:, None, :]) * -10000.0

        def attention(x, y):
            scores = torch.bmm(x, y.transpose(1, 2)) + key_mask
            return torch.bmm(torch.softmax(scores, -1), y) * x

        a, v, t = dense["a"], dense["v"], dense["t"]
        merged = torch.cat([attention(a, v), attention(v, a), attention(t, a), attention(t, v), attention(a, t),
                            attention(v, t), a, v, t], -1)
        return self.cls2(merged), self.cls7(merged)


def build(p: CIMParams, *, generator=None, device=None) -> CIMModule:
    """The module that ``p`` describes (``p.iparams()`` already applied)."""
    return CIMModule(text_dim=p.hidden_text, audio_dim=p.hidden_audio, visual_dim=p.hidden_visual,
                     hidden_size=p.hidden_size, n_classes=p.n_classes, fused_rnn=resolve_fused_rnn(p),
                     generator=generator, device=device)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits in float32, through logsigmoid of both signs."""
    logits = logits.float()
    return -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))


def masked_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """BCE with logits averaged over the valid positions × classes."""
    m = mask.float()[..., None]
    return (sigmoid_bce(logits, targets) * m).sum() / (m.sum() * logits.shape[-1]).clamp_min(1.0)


class CIMTrainer(Trainer):
    """Adam from the config (1e-3), no clip and no plateau controller, as the
    JAX ``CIMTrainer`` (cim.py:173-251)."""

    flax_module = "cim"

    def imodels(self, params: CIMParams):
        generator = torch.Generator().manual_seed(int(params.seed))
        self.model = build(params, generator=generator, device=self.device)
        self.optimizer = optim_factory.build_optim(params.optim, self.model.named_parameters(), self.device)

    def loss_and_metrics(self, batch: Dict[str, torch.Tensor]):
        p = self.params
        logits2, logits7 = self.model(batch)
        mask = batch["attention_mask"]
        Lce = masked_cross_entropy(logits2, batch["label"], mask)
        terms, mets = [], {}
        if p.get("apply_bin", True):
            terms.append(Lce)
        if p.get("apply_multi", False) and "emo_label" in batch:
            Lmulti = masked_bce_with_logits(logits7, batch["emo_label"].float(), mask)
            terms.append(Lmulti)
            mets["Lmulti"] = Lmulti.detach()
        Lall = sum(terms[1:], terms[0]) if terms else 0.0 * Lce
        mets.update(Lall=Lall.detach(), Lce=Lce.detach(), Acc=masked_accuracy(logits2.detach(), batch["label"], mask))
        return Lall, mets

    def test_step_collect(self, batch: Dict[str, np.ndarray], logits) -> None:
        """``logits2`` into the classification summary; on MOSEI with
        ``mosei_metric == "multiemo"`` the masked ``emo_label`` rows and
        ``sigmoid(logits7)`` (float64) into the multilabel collectors."""
        logits2, logits7 = logits
        super().test_step_collect(batch, logits2)
        if "emo_label" in batch and self.params.get("mosei_metric") == "multiemo":
            mask = np.asarray(batch["attention_mask"]) > 0
            prob = 1.0 / (1.0 + np.exp(-np.asarray(logits7, np.float64)))
            self._true_multi.extend(np.asarray(batch["emo_label"])[mask].tolist())
            self._pred_multi.extend(prob[mask].tolist())

    def on_test_begin(self) -> None:
        self._true_multi, self._pred_multi = [], []

    def on_eval_begin(self) -> None:  # the val stage shares the multilabel collectors
        self.on_test_begin()

    def on_test_end(self, res: Dict[str, Any]) -> None:
        if self._true_multi:
            summary = mosei_multilabel_summary(np.array(self._true_multi), np.array(self._pred_multi))
            self.log("mosei multilabel: " + ", ".join(f"{k}={v:.4f}" for k, v in summary.items()
                                                      if isinstance(v, float)))
            res["multilabel"] = summary


def main(argv: Optional[list] = None) -> CIMTrainer:
    """``python -m erc_tpu_torch.train --module=cim [--dataset=...] ...``:
    train, then save the model (``model.last.ckpt`` under ``--save_dir``)."""
    params = CIMParams()
    params.finalize(argv)
    trainer = CIMTrainer(params)
    trainer.train()
    trainer.save_model()
    return trainer
