"""Train entry point, command-line compatible with the JAX package's
``train_mm.py``::

    python -m erc_tpu_torch.train --module=cogmen --dataset=synthetic-cogmen-6 \
        --encoder_mode=chained --graph_impl=banded [--epoch=N] [--save_dir=DIR]
    python -m erc_tpu_torch.train --module=dagerc --dataset=synthetic-iemocap-6 \
        --reimplement --dag_impl=kernel [--epoch=N] [--batch_count=N] [--device=cpu]
    python -m erc_tpu_torch.train --module=dgcn --dataset=synthetic-cogmen-6 \
        --graph_impl=banded [--epoch=N] [--save_dir=DIR]
    python -m erc_tpu_torch.train --module=mmgcn --dataset=synthetic-cogmen-6 \
        [--adj_impl=dense|structured] [--gcn_remat=full|off|dots] [--lstm_mode=packed|unpacked]
    python -m erc_tpu_torch.train --module=dgcnv2 --dataset=synthetic-cogmen-6 \
        [--base_model=DialogRNN|LSTM|GRU|None] [--lstm_mode=packed|unpacked]
    python -m erc_tpu_torch.train --module=dgcnv2_daily --dataset=synthetic-daily-token-7
    python -m erc_tpu_torch.train --module=cim --dataset=synthetic-mosei-2 [--select_on=val]
    python -m erc_tpu_torch.train --module=cogmen_mosei --dataset=mosei-emo-sbert-6
    python -m erc_tpu_torch.train --module=mmin_base --dataset=synthetic-mmin-4 [--ema=False]
    python -m erc_tpu_torch.train --module=mmin_miss --dataset=synthetic-mmin-4 [--pretrain_path=FILE]
    python -m erc_tpu_torch.train --module=mmin_miss2 --dataset=synthetic-mmin-4 [--pretrain_path=FILE]

Every module under ``erc_tpu_torch/models`` that exports ``main`` trains
(COGMEN, DAG-ERC, DialogueGCN, MMGCN, DialogueGCN v2 with its DailyDialog
token track, CIM, COGMEN on MOSEI and the MMIN family: all seven families).
On a dataset with a real val split (MOSEI, DailyDialog, MMIN's) each eval
epoch runs the val stage before the test stage; ``--select_on=val`` then
keeps ``model.best_val.ckpt``.  It runs on the card unless ``--device=cpu`` is given;
without CUDA and without ``--device=cpu`` it raises.  Every ``main`` saves
the model at the end (``model.last.ckpt`` in the saver directory), which ``python -m
erc_tpu_torch.serve --module=<module> --checkpoint=...`` serves (but for
the token track and MMIN, which have no serving path).
Each run is an experiment: its metadata, log, best metrics (``metrics.json``)
and board (``board.jsonl``) under ``<exproot>/experiment/erc_tpu_torch.<Trainer>/<test>/``,
its checkpoints, predictions, profile and TensorBoard events under
``<exproot>/blob/...`` (``ERC_TPU_EXPROOT``, default ``~/.erc_tpu``); ``python
-m erc_tpu_torch.cli list|tests|sum|board|stop`` finds and stops runs.
``--checkpoint_per_epoch=N``, ``--checkpoint_per_step=N``,
``--keypoint_per_epoch=N`` and ``--resume`` (this run's newest readable
checkpoint, else a sibling run's with the same config) write and read the
rotating checkpoints and keypoints in the saver directory (``<blob>/saver``,
or ``--save_dir``); ``--eval_first``, ``--nan_guard``, ``--profile_steps=N``
(a Chrome trace of the first N steps), ``--debug_nans`` (the train step
eager, under NaN checks), ``--tensorboard``, ``--wandb`` and
``--remote_url=URL`` as in the JAX package;
``--pretrain=true --pretrain_path=FILE`` starts from the model and
optimizer state of a file of either package's Saver.  ``--config=FILE``
(yaml or json) sets knobs before the other flags; ``--steps_per_call=K``
trains K steps a replay and ``--eval_steps_per_call=K`` evaluates K batches
a replay; ``--prefetch=false`` collates in line; ``--optim.sche.name=Cos
--optim.sche.left=0 --optim.sche.right=N ...`` declares an LR schedule;
``--optim.split_wd=1|full`` and ``--optim.name=lars`` as in the JAX package.
Real datasets (``iemocap-cogmen-*``, ``meld-mmgcn-7``,
``meld-mmgcn-sbert-7``, ``mosei-cim-2``, the ``mosei-*-sbert*`` names,
``dailydialog-token-7``, ``iemocap-mmin-4``, which needs ``h5py``) are read
under ``--data_root`` or ``ERC_TPU_DATA_ROOT``.

Several processes, one a card (``parallel.mesh``): launch one process a rank
with ``--coordinator=host:port --num_processes=N --process_id=i`` (or
``ERC_TPU_COORDINATOR``, ``ERC_TPU_NUM_PROCESSES`` and ``ERC_TPU_PROCESS_ID``
in its environment; or ``ERC_TPU_DIST=auto`` under ``torchrun``); rank 0
serves the rendezvous at the coordinator's address.  The family's ``main``
starts the process group before it builds the trainer, and this entry point
ends it; rank r of a host takes card r
(``--device=cuda:N`` puts every rank on card N: gloo, and eager steps).  A
run without the flags trains on the one card that ``--device`` names (the
JAX package's run without them spans every local device)::

    for i in 0 1; do python -m erc_tpu_torch.train --module=cogmen --dataset=synthetic-cogmen-6 \
        --coordinator=localhost:29500 --num_processes=2 --process_id=$i & done; wait
"""

from __future__ import annotations

import importlib
import sys
from typing import List, Optional


def _module_arg(argv: List[str]) -> Optional[str]:
    for i, tok in enumerate(argv):
        if tok.startswith("--module="):
            return tok.split("=", 1)[1]
        if tok == "--module" and i + 1 < len(argv):
            return argv[i + 1]
    return None


def main(argv: Optional[List[str]] = None):
    argv = sys.argv[1:] if argv is None else list(argv)
    module = _module_arg(argv)
    if module is None:
        raise SystemExit("usage: python -m erc_tpu_torch.train --module=<name> [--dataset=... ...]")
    mod = importlib.import_module(f"erc_tpu_torch.models.{module}")
    if not hasattr(mod, "main"):
        raise SystemExit(f"training {module!r} is not ported yet")
    from erc_tpu_torch.parallel import mesh

    try:
        return mod.main(argv)
    finally:
        mesh.destroy()  # the trainer's process group, where the flags started one


if __name__ == "__main__":
    main()
