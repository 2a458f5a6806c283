"""Management CLI of the port's runs (reference: lumo/cli/cli.py).

Port of ``erc_tpu.cli``, with every command:

    python -m erc_tpu_torch.cli list                 # experiments
    python -m erc_tpu_torch.cli tests <exp>          # tests of an experiment
    python -m erc_tpu_torch.cli sum <exp> <test>     # full summary of one test
    python -m erc_tpu_torch.cli board [exp]          # best-metric table across runs
    python -m erc_tpu_torch.cli stop <exp> <test>    # graceful stop (.stop file)
    python -m erc_tpu_torch.cli init [path]          # git init + .erc_tpurc.json skeleton
    python -m erc_tpu_torch.cli extract <exp> <test> [out.zip]   # archive one run
    python -m erc_tpu_torch.cli clone <url> [alias]  # git clone + init
    python -m erc_tpu_torch.cli archive <commit> <out.zip>       # export a run snapshot
    python -m erc_tpu_torch.cli warm <module> [dataset] [bs] [L] [--device=cpu]
    python -m erc_tpu_torch.cli checkdata [dataset ...]          # validate a feature-dump mount
    python -m erc_tpu_torch.cli mem [--device=cpu]               # device-memory snapshot
    python -m erc_tpu_torch.cli summary <module> [dataset] [--device=cpu]  # per-module param table

Runs live under the experiment root (``ERC_TPU_EXPROOT``, the machine
config's ``exproot``, or ``~/.erc_tpu``); the port's experiments are named
``erc_tpu_torch.<TrainerClass>``.  ``warm`` builds a family's trainer and,
on the card, captures its train step and eval forward for the (B, L)
bucket and replays each once: the port's counterpart of filling the JAX
package's compile cache (a process's graphs do not outlive it, so it times
the captures).  ``warm``, ``mem`` and ``summary`` run on the card unless
``--device=cpu`` is given, in one process.  ``stop`` also stops a run of
several processes: its rank 0 polls the ``.stop`` file and every rank stops
on the same step.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

from erc_tpu_torch import analyse
from erc_tpu_torch.core.experiment import exproot


def _init_repo(path: str) -> str:
    """`lumo init` equivalent (reference cli/cli.py:57-59): git init + a
    machine-config skeleton."""
    os.makedirs(path, exist_ok=True)
    subprocess.run(["git", "init", "-q", path], check=False)
    rc = os.path.join(path, ".erc_tpurc.json")
    if not os.path.exists(rc):
        with open(rc, "w") as f:
            json.dump({"exproot": None, "data_root": None, "git_snapshot": True}, f, indent=2)
    return os.path.abspath(path)


# the canonical real-data parity datasets: one row per distinct on-disk dump
# format the readers consume
_CHECKDATA_DEFAULTS = (
    "iemocap-cogmen-4",
    "iemocap-cogmen-6",
    "meld-mmgcn-7",
    "mosei-sent-sbert-2",
    "mosei-cim-2",
    "iemocap-mmin-4",
)


def _checkdata(names) -> int:
    """Validate an ERC_TPU_DATA_ROOT mount by loading each dataset through
    the port's reader stack: resolve the root, read every split the registry
    says exists, and report sample counts + feature dims, or the precise
    missing path / parse error.  Returns the number of failures."""
    from erc_tpu_torch.data.registry import dataset_has_val, get_root, pick_datas

    failures = 0
    for name in names:
        try:
            root = get_root(name)
        except KeyError:
            print(f"{name:36s} NO ROOT — unknown corpus {name.split('-')[0]!r} "
                  "(set ERC_TPU_DATA_ROOT or .erc_tpurc.json data_root)")
            failures += 1
            continue
        splits = ["train", "test"] + (["val"] if dataset_has_val(name) else [])
        parts = []
        for split in splits:
            try:
                samples = pick_datas(root, name, split=split)
            except FileNotFoundError as e:
                parts.append(f"{split}: MISSING {e.filename or str(e).splitlines()[0]}")
                failures += 1
                continue
            except Exception as e:  # corrupt/mislaid dump: show the parse error
                parts.append(f"{split}: ERROR {type(e).__name__}: {str(e).splitlines()[0][:160]}")
                failures += 1
                continue
            dims = ""
            if samples:
                shapes = {k: "x".join(map(str, v.shape)) for k, v in sorted(samples[0].items())
                          if hasattr(v, "shape") and getattr(v, "ndim", 0) > 0}
                dims = " " + ",".join(f"{k}={v}" for k, v in shapes.items())
            parts.append(f"{split}: {len(samples)}{dims}")
        print(f"{name:36s} " + " | ".join(parts))
    print("OK" if failures == 0 else f"{failures} FAILURE(S)")
    return failures


def _extract_test(exp: str, test: str, output=None) -> str:
    """`lumo extract` equivalent: zip one run's metadata + blobs."""
    import zipfile

    root = exproot()
    output = output or f"{exp}.{test}.zip"
    n = 0
    with zipfile.ZipFile(output, "w", zipfile.ZIP_DEFLATED) as z:
        for kind in ("experiment", "blob"):
            base = os.path.join(root, kind, exp, test)
            for dirpath, _, files in os.walk(base):
                for name in files:
                    full = os.path.join(dirpath, name)
                    z.write(full, os.path.join(kind, os.path.relpath(full, base)))
                    n += 1
    if n == 0:  # typo'd exp/test must not produce a silent empty archive
        os.remove(output)
        raise SystemExit(f"no files found for {exp}/{test} under {root}")
    return output


def _split_device(argv):
    """(the arguments without ``--device=...``, the device it names or 0: the card)."""
    rest = [a for a in argv if not a.startswith("--device=")]
    given = [a.split("=", 1)[1] for a in argv if a.startswith("--device=")]
    return rest, (given[-1] if given else 0)


def _trainer(module: str, dataset: str, device, batch_size=None, L=None):
    """The trainer of ``erc_tpu_torch.models.<module>`` on ``dataset``, with
    its published settings; ``L`` pads every batch to exactly L."""
    from erc_tpu_torch.train.trainer import Trainer

    mod = importlib.import_module(f"erc_tpu_torch.models.{module}")
    p = mod.ParamsType()
    p.module = module
    p.dataset = dataset
    p.device = device
    if batch_size:
        p.train.batch_size = p.test.batch_size = batch_size
    if L:
        p.max_seq_len = p.length_bucket = L
    p.iparams()
    cls = [v for v in vars(mod).values() if isinstance(v, type) and issubclass(v, Trainer) and v is not Trainer][-1]
    return cls(p)


def warm(module: str, dataset: str = "synthetic-cogmen-6", batch_size=None, L=None, device=0) -> dict:
    """Capture (on the card) the train step and the eval forward of
    ``module``'s trainer for the bucket of its first (B, L) batch and replay
    each once; eagerly on the CPU.  Returns the capture seconds."""
    import torch

    tr = _trainer(module, dataset, device, batch_size, L)
    tr.initialize()
    host = next(iter(tr.make_loader("train")))
    for _ in range(2):  # the bucket's eager first step and its capture, then a replay
        tr.train_batch(host)
    tr.model.eval()
    with torch.inference_mode(), tr.precision():
        for _ in range(2 if tr.device.type == "cuda" else 1):
            tr.captured(host) if tr.device.type == "cuda" else tr._eager_eval(host)
    out = {"device": str(tr.device), "shapes": {k: list(v.shape) for k, v in host.items() if v is not None}}
    if tr.device.type == "cuda" and tr.train_graphs:
        out["train_capture_s"] = sum(tr.captured_step.capture_seconds)
        out["eval_capture_s"] = sum(tr.captured.capture_seconds)
    return out


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    argv, device = _split_device(argv)
    cmd = argv[0] if argv else "board"
    if cmd == "init":
        print(_init_repo(argv[1] if len(argv) > 1 else "."))
    elif cmd == "extract":
        out = _extract_test(argv[1], argv[2], argv[3] if len(argv) > 3 else None)
        print(f"wrote {out}")
    elif cmd == "clone":
        url = argv[1]
        alias = argv[2] if len(argv) > 2 else os.path.basename(url.rstrip("/")).removesuffix(".git")
        subprocess.run(["git", "clone", "-q", url, alias], check=True)
        print(_init_repo(alias))
    elif cmd == "archive":
        from erc_tpu_torch.core.machine import archive_snapshot

        ok = archive_snapshot(argv[1], argv[2])
        print(f"{'wrote' if ok else 'FAILED to write'} {argv[2]}")
        if not ok:
            sys.exit(1)
    elif cmd == "warm":
        t0 = time.perf_counter()
        res = warm(argv[1], argv[2] if len(argv) > 2 else "synthetic-cogmen-6",
                   int(argv[3]) if len(argv) > 3 else None, int(argv[4]) if len(argv) > 4 else None, device)
        res["seconds"] = time.perf_counter() - t0
        print(f"warmed {argv[1]}: train step and eval forward {json.dumps(res)}")
    elif cmd == "list":
        for e in analyse.list_experiments():
            print(e)
    elif cmd == "tests":
        for t in analyse.list_tests(argv[1]):
            print(t)
    elif cmd == "sum":
        print(json.dumps(analyse.summarize_test(argv[1], argv[2]), indent=2, default=str))
    elif cmd == "board":
        print(analyse.format_table(analyse.collect_metrics(argv[1] if len(argv) > 1 else None)))
    elif cmd == "stop":
        path = os.path.join(exproot(), "experiment", argv[1], argv[2], ".stop")
        open(path, "w").close()
        print(f"created {path}")
    elif cmd == "checkdata":
        if _checkdata(argv[1:] or _CHECKDATA_DEFAULTS):
            sys.exit(1)
    elif cmd == "mem":
        from erc_tpu_torch.core import memstat
        from erc_tpu_torch.core.device import resolve_device

        resolve_device(device)  # the card unless --device=cpu: raises without CUDA
        print(memstat.memory_report())
    elif cmd == "summary":
        from erc_tpu_torch.core.summary import summarize_model
        from erc_tpu_torch.data.loader import to_device

        tr = _trainer(argv[1], argv[2] if len(argv) > 2 else "synthetic-cogmen-6", device)
        tr.imodels(tr.params)
        batch = to_device(next(iter(tr.make_loader("test"))), tr.device)
        print(summarize_model(tr.model, batch))
    else:
        print(__doc__)
        sys.exit(1)


if __name__ == "__main__":
    main()
