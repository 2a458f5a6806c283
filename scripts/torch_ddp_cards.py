"""Data-parallel training over the cards of one host: N NCCL ranks, one a card,
against one process on one card.

    python scripts/torch_ddp_cards.py [--ranks 4] [--steps 20]   # a host with N cards
    python scripts/torch_ddp_cards.py --cpu                      # rehearsal: gloo processes, tiny widths

Runs ``scripts/torch_mp_worker.py`` once as one process (no group) and then as
N ranks started from the ``--coordinator`` flags (rank r on card
r, so NCCL, the gradient all-reduce captured in each replayed step), on
COGMEN banded at ``bench.py``'s parity config (batch 32, L 96) and DAG-ERC's
kernel form at the IEMOCAP reimplement settings (batch 16, L 128), dropout 0,
``--steps`` steps of one length bucket (the train loader cycled by
``--batch_count``) and ``test()``.  It fails unless the ranks' losses agree
within rtol 1e-6 of each other and their first 3 within rtol 2e-5 and atol
2e-6 of the one process's, test F1 is the same on every rank, and every
rank captured its step once and replayed the rest.  It prints, per family,
the median wall of a replayed step (the first step of the bucket excluded),
in one process and in N ranks, and the global batch's dialogues per second
each gives, then one JSON line with all of it, the cards' names and power
limits (``nvidia-smi``) among it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "scripts" / "torch_mp_worker.py"
RTOL, ATOL = 2e-5, 2e-6  # tests/test_multiprocess.py's, on the first 3 steps
RANK_RTOL = 1e-6
FAMILIES = {
    "cogmen": ["--dataset=synthetic-cogmen-6", "--encoder_mode=chained", "--max_seq_len=96", "--length_bucket=96",
               "--graph_impl=banded", "--drop_rate=0.0"],
    "dagerc": ["--dataset=synthetic-iemocap-6", "--reimplement", "--dag_impl=kernel", "--max_seq_len=128",
               "--length_bucket=128"],
}
TINY = {"cogmen": ["--hidden_size=16", "--encoder_mode=reference", "--max_seq_len=32", "--length_bucket=32"],
        "dagerc": ["--hidden_dim=16", "--max_seq_len=32", "--length_bucket=32"]}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp: Path, logs: Path, tag: str, n: int, jobs: list, timeout: int):
    """``n`` ranks of the worker on ``jobs``, each rank's output in ``logs/<tag>.<rank>.log``: each rank's
    report, and a list of faults.  Ranks still running after ``timeout`` seconds are killed and the end of
    every log printed; where every rank wrote its report first (the worker writes it before it ends its
    process group), the reports are returned with the fault, else the launch fails."""
    (tmp / f"{tag}.json").write_text(json.dumps(jobs))
    port = _free_port()
    procs, files = [], [logs / f"{tag}.{rank}.log" for rank in range(n)]
    deadline = time.monotonic() + timeout
    try:
        for rank in range(n):
            cmd = [sys.executable, str(WORKER), f"--coordinator=localhost:{port}", f"--num_processes={n}",
                   f"--process_id={rank}", f"--jobs={tmp / f'{tag}.json'}", f"--out={tmp / f'{tag}.{rank}.json'}"]
            with open(files[rank], "w") as log:
                procs.append(subprocess.Popen(cmd, cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT))
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(rank, p.returncode) for rank, p in enumerate(procs) if p.returncode != 0]
    outs = [tmp / f"{tag}.{rank}.json" for rank in range(n)]
    if bad:
        for rank, f in enumerate(files):
            print(f"--- {tag} rank {rank} (exit {procs[rank].returncode}), the end of {f}:\n"
                  f"{f.read_text(errors='replace')[-3000:]}", flush=True)
        if not all(o.exists() for o in outs):
            raise SystemExit(f"{tag}: ranks {bad} failed or were killed after {timeout} s")
    faults = [f"{tag}: ranks {bad} wrote their reports, then failed or were killed after {timeout} s"] if bad else []
    return [json.loads(o.read_text()) for o in outs], faults


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU: gloo processes at tiny widths")
    ap.add_argument("--timeout", type=int, default=600, help="seconds for each launch (one process, then N ranks)")
    ap.add_argument("--logs", default=None, help="a directory for the ranks' output (default: a temporary one)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    os.environ.setdefault("ERC_TPU_EXPROOT", tempfile.mkdtemp(prefix="ddp_cards_runs_"))
    common = ["--prefetch=false", "--heartbeat=false", f"--batch_count={args.steps}", "--confusion_matrix=false"]
    if args.cpu:
        common.append("--device=cpu")

    def jobs(group: bool) -> list:
        return [{"name": name, "module": name, "args": [*flags, *common, *(TINY[name] if args.cpu else [])],
                 "steps": args.steps, "test": True, "dropout0": True, "group": group}
                for name, flags in FAMILIES.items()]

    cards = [] if args.cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    for card in cards:
        print(f"card: {card}", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="ddp_cards_"))
    logs = Path(args.logs) if args.logs else tmp
    logs.mkdir(parents=True, exist_ok=True)
    ones, failed = _launch(tmp, logs, "one", 1, jobs(False), args.timeout)
    one = ones[0]
    print(f"one process done at {time.perf_counter() - t0:.1f} s", flush=True)
    ranks, faults = _launch(tmp, logs, "ranks", args.ranks, jobs(True), args.timeout)
    failed += faults
    print(f"{args.ranks} ranks done at {time.perf_counter() - t0:.1f} s", flush=True)
    summary = {}
    for name in FAMILIES:
        ref, rs = one[name], [r[name] for r in ranks]
        r0 = rs[0]
        for r in rs:
            if r["world"] != args.ranks or (not args.cpu and (r["backend"] != "nccl" or not r["train_graphs"])):
                failed.append(f"{name}: rank {r['rank']} ran {r['backend']} at world {r['world']}, captured "
                              f"{r['train_graphs']}")
            for k, (a, b) in enumerate(zip(r["losses"], r0["losses"])):
                if abs(a - b) > RANK_RTOL * abs(b):
                    failed.append(f"{name}: rank {r['rank']}'s step {k} loss {a} against rank 0's {b}")
            if r["test_f1"] != r0["test_f1"]:
                failed.append(f"{name}: rank {r['rank']}'s test F1 {r['test_f1']} against rank 0's {r0['test_f1']}")
            if not args.cpu and (r["captures"], r["replays"]) != (1, args.steps - 1):
                failed.append(f"{name}: rank {r['rank']} captured {r['captures']} and replayed {r['replays']}")
        for k, (a, b) in enumerate(zip(r0["losses"][:3], ref["losses"][:3])):
            if abs(a - b) > ATOL + RTOL * abs(b):
                failed.append(f"{name}: step {k} loss {a} over {args.ranks} ranks against {b} in one process")
        rows = [sum(x) for x in zip(*(r["rows"] for r in rs))]
        walls = {"one": statistics.median(ref["walls"][1:]), "ranks": statistics.median(r0["walls"][1:])}
        dps = {k: statistics.mean(rows[1:]) / w for k, w in walls.items()}
        summary[name] = {"walls_ms": {k: w * 1e3 for k, w in walls.items()}, "dialogues_per_s": dps,
                         "losses_one": ref["losses"][:3], "losses_ranks": r0["losses"][:3],
                         "test_f1": {"one": ref["test_f1"], "ranks": r0["test_f1"]},
                         "rows_a_rank": [r["rows"][1] for r in rs], "devices": [r["device"] for r in rs]}
        print(f"{name}: a replayed step (median of {args.steps - 1}), one process {walls['one'] * 1e3:.3f} ms, "
              f"{args.ranks} ranks {walls['ranks'] * 1e3:.3f} ms; the global batch's dialogues/s "
              f"{dps['one']:.1f} against {dps['ranks']:.1f}; first losses {ref['losses'][:3]} against "
              f"{r0['losses'][:3]}; test F1 {ref['test_f1']} against {r0['test_f1']}", flush=True)
    print(json.dumps({"ranks": args.ranks, "backend": ranks[0][next(iter(FAMILIES))]["backend"], "cards": cards,
                      **summary}))
    for f in failed:
        print(f"FAILED: {f}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
