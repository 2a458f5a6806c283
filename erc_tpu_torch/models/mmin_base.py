"""MMIN base: an utterance-level tri-modal classifier with an EMA shadow.

Port of ``erc_tpu.models.mmin_base``: ``MMINBaseModule`` (TextCNN and two
LSTM encoders → classifier, ``models/mmin_models.py``) trained with Adam
2e-4 and no decay, batch 32, 55 epochs; ``ReduceLROnPlateau("min")`` on the
val loss (``plateau_source = "val"``: MMIN's folds have a real val split).

- Data: ``data/mmin.py``'s utterances, batched by ``MMINBatcher`` (audio
  cut or padded to ``--max_audio_len``, 128) in the loader's shuffled order
  with no length sort, every batch padded to the batch size; the loss and
  accuracy are masked by ``sample_mask``.  Trainers whose ``has_miss()``
  holds (``mmin_miss``, ``mmin_miss2``) draw the Missing patterns of their
  train batches from ``numpy_rng("missing")``, the JAX trainer's generator,
  so the port's batches equal the JAX package's.
- EMA (``--ema``, on by default; ``--ema_alpha``, 0.999): the shadow is a
  second module (``ema_model``) that starts as a copy of the weights; after
  every optimizer step each of its parameters becomes ``α·e + (1 − α)·p``
  in float32 on the device (``torch._foreach_*``, no host sync), over every
  parameter of the model, both nets of ``mmin_miss2``.  Eval returns the raw
  and the EMA logits: loss, F1 and the summary come from the raw ones, and
  ``Acc2`` (the EMA argmax's hits over the valid rows) goes into the test
  result and, through ``on_eval_end``, the val row.  The shadow rides in
  checkpoints (``state_tree``'s ``"ema"``), so ``--resume`` restores it.
- ``--pretrain_path`` names a finished ``mmin_base`` run's model file, of
  either package's Saver (``train.checkpoint.load_model_state``):
  ``mmin_miss`` loads it into its frozen encoder, ``mmin_miss2`` into
  ``netB``.

MMIN classifies single utterances and has no serving path, in either
package::

    python -m erc_tpu_torch.train --module=mmin_base --dataset=synthetic-mmin-4 [--ema=False] [--device=cpu]
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from erc_tpu_torch.core.params import Params
from erc_tpu_torch.data.loader import DialogueLoader
from erc_tpu_torch.data.mmin import MMINBatcher
from erc_tpu_torch.data.registry import get_root, pick_datas
from erc_tpu_torch.models.base import MMBaseParams
from erc_tpu_torch.models.mmin_models import MMINBaseModule
from erc_tpu_torch.parallel import mesh
from erc_tpu_torch.train import optim as optim_factory
from erc_tpu_torch.train.trainer import Trainer, main as train_main, masked_accuracy, masked_cross_entropy


class MMINBaseParams(MMBaseParams):
    def __init__(self):
        super().__init__()
        self.train.batch_size = 32
        self.val.batch_size = 32
        self.test.batch_size = 32
        self.dataset = "iemocap-mmin-4"
        self.epoch = 55
        self.optim = Params(name="Adam", lr=0.0002, weight_decay=0.0)
        self.ema = True
        self.ema_alpha = 0.999
        self.max_audio_len = 128

    def iparams(self):
        super().iparams()
        # MMIN's feature widths (data/mmin.py), whatever the name's corpus gives
        self.hidden_audio, self.hidden_visual, self.hidden_text = 130, 342, 1024
        self.hidden_all = self.hidden_audio + self.hidden_visual + self.hidden_text


ParamsType = MMINBaseParams
SERVED = False  # MMIN classifies single utterances ([T, D] feature sequences), not dialogues: training only


def build(p, *, generator=None, device=None) -> MMINBaseModule:
    """The module that ``p`` describes (``p.iparams()`` already applied)."""
    return MMINBaseModule(p.n_classes, p.hidden_audio, p.hidden_visual, p.hidden_text, generator=generator,
                          device=device)


class MMINBaseTrainer(Trainer):
    plateau_source = "val"  # the reference steps on the val loss, not the test loss
    build_module = staticmethod(build)

    flax_module = "mmin_base"

    def imodels(self, params: MMINBaseParams):
        self.model = self.build_module(params, generator=torch.Generator().manual_seed(int(params.seed)),
                                       device=self.device)
        self.optimizer = optim_factory.build_optim(params.optim, self.model.named_parameters(), self.device)
        self.lr_sche = torch.optim.lr_scheduler.ReduceLROnPlateau(self.optimizer, "min")

    def initialize(self) -> None:
        if self.model is not None:
            return
        super().initialize()
        self.ema_model: Optional[torch.nn.Module] = None
        if self.params.get("ema", True):
            # its own weights are overwritten at once: a throwaway generator keeps torch's global one untouched
            self.ema_model = self.build_module(self.params, generator=torch.Generator(), device=self.device)
            self.ema_model.requires_grad_(False).eval()
            self.sync_ema()

    # -- EMA ----------------------------------------------------------------------
    @torch.no_grad()
    def sync_ema(self) -> None:
        """The shadow := a copy of the current weights."""
        torch._foreach_copy_(list(self.ema_model.parameters()), list(self.model.parameters()))

    @torch.no_grad()
    def update_ema(self) -> None:
        """e ← α·e + (1 − α)·p, in the JAX trainer's order of operations."""
        alpha = float(self.params.get("ema_alpha", 0.999))
        ema = list(self.ema_model.parameters())
        new = torch._foreach_mul(list(self.model.parameters()), 1 - alpha)
        torch._foreach_mul_(ema, alpha)
        torch._foreach_add_(ema, new)

    def after_step(self) -> None:
        if self.ema_model is not None:
            self.update_ema()

    def state_tree(self) -> Dict[str, Any]:
        tree = super().state_tree()
        if self.ema_model is not None:
            tree["ema"] = self.ema_model.state_dict()
        return tree

    def load_state_tree(self, tree: Dict[str, Any], whole: bool = True) -> None:
        super().load_state_tree(tree, whole)
        if self.ema_model is not None and "ema" in tree:
            self.ema_model.load_state_dict(tree["ema"])

    # -- utterance-level data ----------------------------------------------------
    def has_miss(self) -> bool:
        return False

    def make_loader(self, split: str) -> DialogueLoader:
        p = self.params
        root = p.get("data_root") or (None if p.dataset.startswith("synthetic-") else get_root(p.dataset))
        bs = int(p.train.batch_size if split == "train" else p.test.batch_size)
        batcher = MMINBatcher(max_audio_len=int(p.get("max_audio_len", 128)),
                              has_miss=(split == "train" and self.has_miss()), pad_batch_to=bs,
                              rng=self.rng.numpy_rng("missing"))
        bc = p.get("batch_count")
        return DialogueLoader(pick_datas(root, p.dataset, split=split), batcher, batch_size=bs,
                              shuffle=(split == "train"), seed=p.seed, sort_by_length=False,
                              batch_count=(int(bc) if bc and split == "train" else None),
                              rank=mesh.process_index(), world=mesh.process_count())

    # -- loss and eval -------------------------------------------------------------
    def loss_and_metrics(self, batch: Dict[str, torch.Tensor]):
        logits, _ = self.model(batch)
        mask = batch["sample_mask"]
        loss = masked_cross_entropy(logits, batch["label"], mask)
        return loss, {"Lall": loss.detach(), "Acc": masked_accuracy(logits.detach(), batch["label"], mask)}

    def to_logits(self, batch: Dict[str, torch.Tensor]):
        """The raw logits, and the EMA shadow's beside them where there is one
        (``mmin_miss2``: ``net``'s alone, its forward without ``with_reverse``)."""
        logits = self.model(batch)[0]
        if self.ema_model is None:
            return logits
        return logits, self.ema_model(batch)[0]

    def test_step_collect(self, batch: Dict[str, np.ndarray], logits) -> None:
        ema_logits = None
        if isinstance(logits, tuple):
            logits, ema_logits = logits
        labels = np.asarray(batch["label"])
        sel = (np.asarray(batch["sample_mask"]) > 0) & (labels >= 0)
        self._true.extend(labels[sel].tolist())
        self._pred.extend(logits.argmax(-1)[sel].tolist())
        self._collect_nll(logits, labels, sel)
        if ema_logits is not None:
            self._ema_hits += int(((ema_logits.argmax(-1) == labels) & sel).sum())
            self._ema_n += int(sel.sum())

    def on_test_begin(self) -> None:
        self._ema_hits, self._ema_n = 0, 0

    def on_test_end(self, res: Dict[str, Any]) -> None:
        hits, n = mesh.allsum(self._ema_hits, self._ema_n)  # every rank's: every rank reports the same Acc2
        self._ema_hits, self._ema_n = int(hits), int(n)
        if self._ema_n:
            res["Acc2"] = self._ema_hits / self._ema_n
            self.log(f"EMA Acc2: {res['Acc2']:.5f}")

    # the val stage shares the test stage's EMA collectors and puts Acc2 into the val row
    def on_eval_begin(self) -> None:
        self.on_test_begin()

    def on_eval_end(self, res: Dict[str, Any]) -> None:
        self.on_test_end(res)


def main(argv: Optional[list] = None) -> MMINBaseTrainer:
    """``python -m erc_tpu_torch.train --module=mmin_base [--dataset=...] ...``"""
    return train_main(MMINBaseTrainer, MMINBaseParams, argv)
