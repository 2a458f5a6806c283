"""cogmen_mosei: COGMEN pointed at MOSEI (port of
``erc_tpu.models.cogmen_mosei``, an alias kept for the command line)::

    python -m erc_tpu_torch.train --module=cogmen_mosei --dataset=mosei-emo-sbert-6
    python -m erc_tpu_torch.train --module=cogmen_mosei --dataset=synthetic-mosei-6 --device=cpu

COGMEN's module, trainer and engine, with params whose default dataset is
``mosei-emo-sbert-6`` and whose dialogues have one speaker.
"""

from __future__ import annotations

from typing import Optional

from erc_tpu_torch.models.cogmen import COGMENParams, COGMENTrainer, build  # noqa: F401


class COGMENMoseiParams(COGMENParams):
    def __init__(self):
        super().__init__()
        self.dataset = "mosei-emo-sbert-6"
        self.n_speakers = 1


ParamsType = COGMENMoseiParams


def main(argv: Optional[list] = None) -> COGMENTrainer:
    """Train, then save the model (``model.last.ckpt`` under ``--save_dir``)."""
    params = COGMENMoseiParams()
    params.finalize(argv)
    trainer = COGMENTrainer(params)
    trainer.train()
    trainer.save_model()
    return trainer
