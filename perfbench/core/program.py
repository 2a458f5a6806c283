"""The system under test, built as a configuration file says: the port's
trainer with its own loader pipeline.  The only
module of the benchmark that imports the port (``erc_tpu_torch``).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch


def trainer(cfg: Dict, seed: int, device: str):
    """The configuration's trainer (``erc_tpu_torch.models.<module>``), its
    flags as on the command line, then ``after_flags`` (values that the
    family's ``--reimplement`` settings would overwrite), initialised."""
    mod = importlib.import_module(f"erc_tpu_torch.models.{cfg['module']}")
    p = mod.ParamsType()
    p.finalize([*cfg["flags"], f"--device={device}", f"--seed={seed}"])
    for k, v in cfg.get("after_flags", {}).items():
        p[k] = v
    t = getattr(mod, cfg["trainer"])(p)
    t.initialize()
    return t


def train_loader(t, dialogues: List[dict]):
    """The loader that ``Trainer.make_loader('train')`` builds, over the
    benchmark's dialogues, in the trainer's pipeline (``_pipeline_train``:
    grouping, prefetch)."""
    from erc_tpu_torch.data.loader import DialogueLoader

    p = t.params
    bs = int(p.train.batch_size)
    bc = p.get("batch_count")
    loader = DialogueLoader(dialogues, t.batcher(bs), batch_size=bs, shuffle=True, seed=p.seed,
                            sort_by_length=bool(p.get("sort_by_length", True)), sort_chunk=int(p.get("sort_chunk", 8)),
                            batch_count=int(bc) if bc else None, rank=0, world=1)
    return t._pipeline_train(loader)


def step_state(t) -> List[torch.Tensor]:
    """What the captured step reads and writes in place (parameters, their
    gradients, buffers, optimizer state, the LR)."""
    return t._step_tensors()


def real_rows(host_batch: Dict[str, np.ndarray]) -> np.ndarray:
    """The rows of a packed batch that hold a dialogue."""
    return np.flatnonzero(np.asarray(host_batch["text_length"]) > 0)
