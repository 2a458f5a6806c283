"""dgcnv2_daily: the DailyDialog token track of DialogueGCN v2 as a module of
its own (port of ``erc_tpu.models.dgcnv2_daily``)::

    python -m erc_tpu_torch.train --module=dgcnv2_daily --dataset=dailydialog-token-7

A TextCNN over each utterance's word ids feeds the dgcnv2 pipeline; the
model, batcher and trainer are in ``models/dgcnv2.py``.  There is no serving
engine for the token track, as in the JAX package.
"""

from erc_tpu_torch.models.dgcnv2 import (  # noqa: F401
    DGCNV2DailyParams,
    DGCNV2DailyTrainer,
    daily_main as main,
)

ParamsType = DGCNV2DailyParams
SERVED = False  # the token track's batches are of word ids, not the features the engine packs
