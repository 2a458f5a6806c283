"""One rank of a data-parallel run of the port (erc_tpu_torch), for the tests
and ``chip_smoke.py``.

The port's counterpart of ``scripts/mp_worker.py``: launched once a rank
with distinct ``--process_id`` against one ``--coordinator``, it runs a list
of jobs, each a trainer built through its family's params with
``--coordinator``, ``--num_processes`` and ``--process_id`` (the process
group starts, as the families' entry points start it, at the first job that
asks for it, before its trainer is built; a job with ``"group": false`` runs
before that, in one process), and writes a JSON
report of every job::

    python scripts/torch_mp_worker.py --coordinator=localhost:29500 --num_processes=2 --process_id=0 \\
        --jobs=jobs.json --out=rank0.json

``jobs.json`` is a list of objects: ``name``, ``module`` (a family under
``erc_tpu_torch/models``), ``args`` (its flags), and optionally ``group``
(default true), ``init`` (a ``.pt`` state dict the model starts from, the
EMA shadow with it), ``dropout0`` (every dropout off), ``mode`` (``steps``:
``steps`` optimizer steps on the train loader's first batches, 0 for the
whole epoch, through ``Trainer.train_batch``; ``train``: ``Trainer.train()``
with its callbacks; ``draw``: the keep-mask of the model's first dropout on
256 ones, drawn, then drawn again after every rank restored rank 0's
``state_tree``, as a resume restores rank 0's file, and no step), ``test`` (run ``test()`` after the steps), ``dump`` (a
``.npz`` path for the rank's parameters, buffers and EMA shadow; ``{rank}``
in it becomes the rank), written after step ``dump_step`` (default: the
last).  Per job the report holds the losses of each step, the valid labels
and rows of the first and of every batch, each batch's length, the test
name and directory, the test stage's F1, loss and rows, the kernels' launch
counts, the steps' walls, the captured step's captures and replays, and the
resumed epoch.  Only torch and the port are imported, never JAX.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAINERS = {"cogmen": "COGMENTrainer", "dagerc": "DAGERCTrainer", "dgcn": "DGCNTrainer", "mmgcn": "MMGCNTrainer",
            "dgcnv2": "DGCNV2Trainer", "cim": "CIMTrainer", "mmin_base": "MMINBaseTrainer",
            "mmin_miss": "MMINMissTrainer", "mmin_miss2": "MMINMiss2Trainer"}


def _valid(batch):
    """The batch's labels and their validity mask (dialogue or utterance rows)."""
    import numpy as np

    labels = np.asarray(batch["label"])
    mask = batch.get("attention_mask")
    mask = (np.asarray(mask) if mask is not None else np.asarray(batch["sample_mask"])) > 0
    return labels, mask & (labels >= 0)


def _launches():
    from erc_tpu_torch.ops.kernels import banded as kb, dag_block as kd

    return {**kb.launches, **kd.launches}


def _draw(trainer) -> list:
    """The keep-mask of the model's first dropout (p > 0), in training, on 256 ones."""
    import torch

    from erc_tpu_torch.ops.dropout import Dropout

    drop = next(m for m in trainer.model.modules() if isinstance(m, Dropout) and m.p > 0)
    drop.train()
    return (drop(torch.ones(256, device=trainer.device)) > 0).int().tolist()


def _sync(trainer):
    import torch

    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)


def _say(msg: str) -> None:
    """A progress line on standard output (a launcher that keeps it sees how far a rank got)."""
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def run_job(job: dict, dist_args: list) -> dict:
    import torch

    from erc_tpu_torch.ops.dropout import Dropout
    from erc_tpu_torch.parallel import mesh
    from erc_tpu_torch.train.trainer import start_group

    mod = importlib.import_module(f"erc_tpu_torch.models.{job['module']}")
    p = mod.ParamsType()
    p.finalize([*job["args"], *(dist_args if job.get("group", True) else [])])
    start_group(p)  # where the flags ask for one, before the trainer touches a card
    trainer = getattr(mod, TRAINERS[job["module"]])(p)
    _say(f"{job['name']}: trainer built, {mesh.describe()}")
    trainer.initialize()
    if job.get("dropout0"):
        for m in trainer.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    if job.get("init"):
        trainer.model.load_state_dict(torch.load(job["init"], map_location=trainer.device))
        if getattr(trainer, "ema_model", None) is not None:
            trainer.sync_ema()
    trainer.sync_from_main()
    out = {"rank": mesh.process_index(), "world": mesh.process_count(), "backend": mesh.backend(),
           "device": str(trainer.device), "test_name": trainer.exp.test_name, "test_dir": trainer.exp.test_dir,
           "train_graphs": bool(trainer.train_graphs), "losses": [], "rows": [], "walls": []}
    if job.get("mode") == "draw":
        out["draws"] = [_draw(trainer)]
        trainer.load_state_tree(mesh.broadcast_one_to_all(trainer.state_tree()))
        out["draws"].append(_draw(trainer))
        return out
    before = _launches()
    if job.get("mode", "steps") == "train":
        from erc_tpu_torch.train import callbacks as cbs

        class Recorder(cbs.Callback):
            priority = 150  # after AutoResume: the epoch it restored

            def train_begin(self, tr):
                out["eidx_at_begin"] = tr.eidx

            def train_step_end(self, tr, bidx, mets):
                out["losses"].append(float(mets["Lall"]))

        Recorder().hook(trainer)
        trainer.train()
        out.update(final_eidx=trainer.eidx, global_steps=trainer.global_steps,
                   checkpoints=sorted(os.path.basename(c) for c in trainer.saver.list_checkpoints()))
    else:
        loader = trainer.make_loader("train")
        steps = int(job.get("steps", 3))
        for i, host in enumerate(loader):
            if steps and i >= steps:
                break
            labels, valid = _valid(host)
            if i == 0:
                out["first_batch_labels"] = labels[valid].tolist()
            out["rows"].append(int(valid.any(-1).sum()) if valid.ndim > 1 else int(valid.sum()))
            if "attention_mask" in host:
                out.setdefault("lengths", []).append(int(host["attention_mask"].shape[1]))
            t0 = time.perf_counter()
            mets = trainer.train_batch(host)
            loss = float(mets["Lall"])  # waits for the step
            out["walls"].append(time.perf_counter() - t0)
            out["losses"].append(loss)
            _say(f"{job['name']}: step {i} loss {loss} in {out['walls'][-1]:.4f} s")
            out.setdefault("gnorms", []).append(float(mets["gnorm"]))
            if job.get("dump") and i + 1 == job.get("dump_step"):
                _dump(trainer, job["dump"])
    graphs = trainer._captured_step
    out["captures"], out["replays"] = (graphs.captures, graphs.replays) if graphs is not None else (0, 0)
    after = _launches()
    out["launches"] = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    if job.get("test"):
        res = trainer.test()
        _say(f"{job['name']}: test {res.get('f1')}")
        out.update(test_f1=res.get("f1"), test_Lall=res.get("Lall"), n_test_rows=len(trainer._true))
        if "multilabel" in res:
            out["test_multilabel"] = {k: v for k, v in res["multilabel"].items() if isinstance(v, float)}
    _sync(trainer)
    if job.get("dump") and not job.get("dump_step"):
        _dump(trainer, job["dump"])
    return out


def _dump(trainer, path: str) -> None:
    """The rank's model state (and EMA shadow) into ``path`` (``{rank}`` filled in)."""
    import numpy as np

    from erc_tpu_torch.parallel import mesh

    state = {f"model.{k}": v for k, v in trainer.model.state_dict().items()}
    ema = getattr(trainer, "ema_model", None)
    if ema is not None:
        state.update({f"ema.{k}": v for k, v in ema.state_dict().items()})
    np.savez(path.replace("{rank}", str(mesh.process_index())),
             **{k: v.detach().cpu().numpy() for k, v in state.items()})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--jobs", required=True, help="a JSON file: the list of jobs")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    os.environ.setdefault("ERC_TPU_GIT_SNAPSHOT", "0")
    import torch

    torch.set_num_threads(1)  # tiny tensors, several processes a core
    from erc_tpu_torch.parallel import mesh

    with open(args.jobs) as f:
        jobs = json.load(f)
    dist_args = [f"--coordinator={args.coordinator}", f"--num_processes={args.num_processes}",
                 f"--process_id={args.process_id}"]
    report = {}
    try:
        for job in jobs:
            report[job["name"]] = run_job(job, dist_args)
        with open(args.out, "w") as f:
            json.dump(report, f)
    finally:
        mesh.destroy()
    _say("group ended")


if __name__ == "__main__":
    main()
