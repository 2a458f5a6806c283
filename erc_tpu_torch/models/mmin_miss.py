"""MMIN's missing-modality imagination training.

Port of ``erc_tpu.models.mmin_miss``: the ``Missing`` transform keeps one
of six modality patterns per training utterance (``data/mmin.py``);
``MMINMissModule`` imagines the missing encoding through a ``ResidualAE``
whose latents feed the classifier; a frozen, pretrained ``MMINBaseModule``
encodes the dropped (``*_reverse``) features as the target.  The loss, on
train batches that carry ``*_reverse``::

    Lall = Lce + 4·Lmse(reverse_features, fusion) + 2·Lcycle(features, fusion_cycle)

The frozen encoder is held on the trainer (``pretrained_model``), not in
``model``: it is outside the optimizer, the EMA, checkpoints and the
parameter count.  It runs in eval mode under ``no_grad``.  Its weights come
from its own generator (the JAX trainer's ``pretrain_init`` stream, seeded
from ``--seed``), or from ``--pretrain_path``, a finished ``mmin_base`` run's
model file of either package's Saver::

    python -m erc_tpu_torch.train --module=mmin_miss --dataset=synthetic-mmin-4 [--pretrain_path=FILE] [--device=cpu]
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from erc_tpu_torch.core.precision import cast_floats
from erc_tpu_torch.models.mmin_base import MMINBaseParams, MMINBaseTrainer, build as build_base
from erc_tpu_torch.models.mmin_models import MODALITIES, MMINMissModule
from erc_tpu_torch.parallel import mesh
from erc_tpu_torch.train.checkpoint import load_model_state
from erc_tpu_torch.train.trainer import main as train_main, masked_accuracy, masked_cross_entropy


class MMINMissParams(MMINBaseParams):
    def __init__(self):
        super().__init__()
        self.pretrain_path = None  # None: a random frozen encoder


ParamsType = MMINMissParams
SERVED = False  # training only, as mmin_base


def build(p, *, generator=None, device=None) -> MMINMissModule:
    return MMINMissModule(p.n_classes, p.hidden_audio, p.hidden_visual, p.hidden_text, generator=generator,
                          device=device)


def masked_mse(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the features of (a − b)², averaged over the valid rows (of the
    global batch under a process group: this rank's share), in float32."""
    per = ((a.float() - b.float()) ** 2).mean(-1)
    mask = mask.float()
    return (per * mask).sum() / mesh.global_sum(mask.sum()).clamp_min(1.0)


def reverse_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The dropped features under the keys the encoders read."""
    return {key: batch[f"{key}_reverse"] for _, key in MODALITIES}


class MMINMissTrainer(MMINBaseTrainer):
    build_module = staticmethod(build)

    flax_module = "mmin_miss"

    def has_miss(self) -> bool:
        return True

    def initialize(self) -> None:
        if self.model is not None:
            return
        super().initialize()
        seed = int(self.rng.numpy_rng("pretrain_init").integers(0, 2**63 - 1))
        self.pretrained_model = build_base(self.params, generator=torch.Generator().manual_seed(seed),
                                           device=self.device)
        path = self.params.get("pretrain_path")
        if path:
            self.pretrained_model.load_state_dict(load_model_state(path, "mmin_base"))
            self.log(f"loaded pretrained encoder from {path}")
        self.pretrained_model.requires_grad_(False).eval()

    def loss_and_metrics(self, batch: Dict[str, torch.Tensor]):
        logits, fusion, fusion_cycle, features = self.model(batch)
        mask, labels = batch["sample_mask"], batch["label"]
        Lce = masked_cross_entropy(logits, labels, mask)
        mets = {"Lce": Lce.detach(), "Acc": masked_accuracy(logits.detach(), labels, mask)}
        Lall = Lce
        if self.model.training and "audio_feature_reverse" in batch:
            with torch.no_grad():
                # the frozen encoder's weights are float32, not cast with the model's: as in
                # JAX, they promote a bfloat16 step's batch to float32
                reverse_features = self.pretrained_model.encode(cast_floats(reverse_batch(batch), torch.float32))
            Lmse = masked_mse(reverse_features, fusion, mask)
            Lcycle = masked_mse(features, fusion_cycle, mask)
            Lall = Lce + Lmse * 4 + Lcycle * 2
            mets.update(Lmse=Lmse.detach(), Lcycle=Lcycle.detach())
        mets["Lall"] = Lall.detach()
        return Lall, mets


def main(argv: Optional[list] = None) -> MMINMissTrainer:
    """``python -m erc_tpu_torch.train --module=mmin_miss [--dataset=...] ...``"""
    return train_main(MMINMissTrainer, MMINMissParams, argv)
