"""mmin_miss2: twin base nets trained together on the Missing augmentation.

Port of ``erc_tpu.models.mmin_miss2``: no imagination AE and no frozen
encoder.  ``MMINMiss2Module`` holds two ``MMINBaseModule``s under one
optimizer: ``net`` classifies the Missing-masked features, ``netB`` the
complementary (``*_reverse``) ones, and on train batches that carry them::

    Lall = Lce(logits) + 4·Lmse(reverse_features, fusion) + Lrce(reverse_logits)

pulls ``net``'s penultimate feature toward ``netB``'s with gradients into
both nets (no detach anywhere).  Eval classifies with ``net`` alone, and so
does the EMA's ``Acc2``; the shadow covers both nets.  ``--pretrain_path``
(a finished ``mmin_base`` run's model file, of either package's Saver)
warm-starts ``netB`` only, which keeps training, and re-syncs the EMA
shadow to the loaded weights::

    python -m erc_tpu_torch.train --module=mmin_miss2 --dataset=synthetic-mmin-4 [--pretrain_path=FILE] [--device=cpu]
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from erc_tpu_torch.models.mmin_base import MMINBaseParams, MMINBaseTrainer
from erc_tpu_torch.models.mmin_miss import masked_mse
from erc_tpu_torch.models.mmin_models import MMINMiss2Module
from erc_tpu_torch.train.checkpoint import load_model_state
from erc_tpu_torch.train.trainer import main as train_main, masked_accuracy, masked_cross_entropy


class MMINMiss2Params(MMINBaseParams):
    def __init__(self):
        super().__init__()
        self.pretrain_path = None  # None: netB starts random (and trains)


ParamsType = MMINMiss2Params
SERVED = False  # training only, as mmin_base


def build(p, *, generator=None, device=None) -> MMINMiss2Module:
    return MMINMiss2Module(p.n_classes, p.hidden_audio, p.hidden_visual, p.hidden_text, generator=generator,
                           device=device)


class MMINMiss2Trainer(MMINBaseTrainer):
    build_module = staticmethod(build)

    flax_module = "mmin_miss2"

    def has_miss(self) -> bool:
        return True

    def initialize(self) -> None:
        if self.model is not None:
            return
        super().initialize()
        path = self.params.get("pretrain_path")
        if path:
            self.model.netB.load_state_dict(load_model_state(path, "mmin_base"))
            if self.ema_model is not None:
                self.sync_ema()  # the shadow starts from the loaded weights
            self.log(f"warm-started netB from {path}")

    def loss_and_metrics(self, batch: Dict[str, torch.Tensor]):
        mask, labels = batch["sample_mask"], batch["label"]
        if self.model.training and "audio_feature_reverse" in batch:
            logits, fusion, rlogits, rfeat = self.model(batch, with_reverse=True)
            Lce = masked_cross_entropy(logits, labels, mask)
            Lrce = masked_cross_entropy(rlogits, labels, mask)
            Lmse = masked_mse(rfeat, fusion, mask)
            Lall = Lce + Lmse * 4 + Lrce
            mets = {"Lce": Lce.detach(), "Lrce": Lrce.detach(), "Lmse": Lmse.detach()}
        else:
            logits, _ = self.model(batch)
            Lall = masked_cross_entropy(logits, labels, mask)
            mets = {}
        mets.update(Lall=Lall.detach(), Acc=masked_accuracy(logits.detach(), labels, mask))
        return Lall, mets


def main(argv: Optional[list] = None) -> MMINMiss2Trainer:
    """``python -m erc_tpu_torch.train --module=mmin_miss2 [--dataset=...] ...``"""
    return train_main(MMINMiss2Trainer, MMINMiss2Params, argv)
