"""Epoch rates of the trainer's loader pipeline on one NVIDIA GPU: K = 1 and
K = 4 train steps a replay (``--steps_per_call``), each with the prefetch
thread on and off (``--prefetch``), for COGMEN banded, DAG-ERC's kernel form
and mmin_miss at ``chip_smoke.py``'s settings, and where the epoch's host
time goes.

- rates: ``Trainer.train()`` epochs of ``--batches`` batches of one shape
  (``length_bucket`` 0, no val or test stage), every setting captured
  before the first timed epoch, then ``--rounds`` rounds over the settings,
  in turn forwards and backwards; the median, least and most of each
  setting's epochs.  Two more settings run prefetch with Python's thread
  switch interval at 0.5 ms (5 ms by default), to test whether the
  producer thread slows the steps by holding the GIL, and two run K = 1 on
  half of torch's intra-op threads, to test whether it slows the staging
  copies (which run on those threads) by taking a core from them.
- split: one epoch of each setting through the trainer's own pipeline,
  timing the wait for each item, the step calls and the final sync apart,
  beside the loader alone (collation, no step).

    python scripts/torch_pipeline_rates.py [--batches 64] [--rounds 6] [--configs cogmen,dagerc,mmin_miss]
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SWITCH = 0.0005  # the shorter thread switch interval tried, seconds


def _settings():
    """(K, prefetch, switch interval or None, torch threads or None)."""
    half = max(torch.get_num_threads() // 2, 1)
    base = [(1, True, None, None), (1, False, None, None), (4, True, None, None), (4, False, None, None)]
    return base + [(1, True, SWITCH, None), (4, True, SWITCH, None), (1, True, None, half), (1, False, None, half)]


def _label(k, prefetch, switch, threads):
    tail = f", switch {switch * 1e3:g} ms" if switch else ""
    tail += f", {threads} torch threads" if threads else ""
    return f"K={k} prefetch {'on' if prefetch else 'off'}{tail}"


def _set(run, k, prefetch, switch, threads, defaults):
    run.params.steps_per_call, run.params.prefetch = k, prefetch
    sys.setswitchinterval(switch or defaults[0])
    torch.set_num_threads(threads or defaults[1])


def _epoch(run):
    run.eidx, run.params.epoch = run.eidx + 1, run.eidx + 2
    return run.train()[-1]


def _split(run, sync):
    """One epoch through the trainer's pipeline: seconds waiting for items, in step calls, in the final sync."""
    loader = run._pipeline_train(run.make_loader("train"))
    run.eidx += 1
    loader.set_epoch(run.eidx)
    wait = step = 0.0
    t0 = time.perf_counter()
    it = iter(loader)
    while True:
        a = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            break
        b = time.perf_counter()
        host, k = item if isinstance(item, tuple) else (item, 1)
        run.train_batch(host) if k == 1 else run.train_group(host, k)
        step += time.perf_counter() - b
        wait += b - a
    c = time.perf_counter()
    sync()
    end = time.perf_counter()
    return {"wait_s": wait, "step_s": step, "sync_s": end - c, "epoch_s": end - t0}


def _collate_only(run):
    loader = run.make_loader("train")
    loader.set_epoch(run.eidx + 1)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return {"batches": n, "seconds": time.perf_counter() - t0}


def measure(name, run, unit, batches, rounds, sync):
    p = run.params
    p.eval_per_epoch, p.batch_count, p.length_bucket = 0, batches, 0
    defaults = sys.getswitchinterval(), torch.get_num_threads()
    settings = _settings()
    try:
        for s in settings:  # every bucket of every setting captured before the timed epochs
            _set(run, *s, defaults)
            captures = -1
            while captures != run.captured_step.captures:
                captures = run.captured_step.captures
                _epoch(run)
        passes = {_label(*s): [] for s in settings}
        for r in range(rounds):
            for s in (settings if r % 2 == 0 else settings[::-1]):
                _set(run, *s, defaults)
                rec = _epoch(run)
                passes[_label(*s)].append(rec["dialogues"] / rec["seconds"])  # rows that are not padding
        split = {}
        for s in settings:
            _set(run, *s, defaults)
            split[_label(*s)] = {q: round(v, 6) for q, v in _split(run, sync).items()}
        split["loader alone"] = _collate_only(run)
    finally:
        sys.setswitchinterval(defaults[0])
        torch.set_num_threads(defaults[1])
    rates = {q: {"median": round(statistics.median(v), 1), "min": round(min(v), 1), "max": round(max(v), 1),
                 "passes": [round(x, 1) for x in v]} for q, v in passes.items()}
    return {"config": name, "unit": f"{unit}/s", "batches": batches, "rounds": rounds,
            "torch_threads": defaults[1], "rates": rates, "split": split}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--configs", default="cogmen,dagerc,mmin_miss")
    args = ap.parse_args()
    card = chip_smoke.probe()
    chip_smoke.log = lambda msg: None  # the trainers' own log lines

    def sync():
        torch.cuda.synchronize()

    makers = {
        "cogmen": ("COGMEN banded", lambda: chip_smoke._cogmen_trainer("banded"), "dialogues"),
        "dagerc": ("DAG-ERC kernel form", lambda: chip_smoke._trainer(), "dialogues"),
        "mmin_miss": ("mmin_miss", lambda: chip_smoke._mmin_trainer("mmin_miss"), "utterances"),
    }
    out = []
    for key in args.configs.split(","):
        name, make, unit = makers[key]
        t0 = time.perf_counter()
        run = make()
        res = measure(name, run, unit, args.batches, args.rounds, sync)
        res["seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(res), flush=True)
        out.append(res)
        del run
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi} (probe: {card})")
    for res in out:
        print(res["config"], {q: v["median"] for q, v in res["rates"].items()})


if __name__ == "__main__":
    main()
