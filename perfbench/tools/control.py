"""The readings that set a training cell's limits, on the card at the cell's
own size.

    python3 perfbench/tools/control.py --workload <name> --seeds 1,2,3 --mode program|tf32|half_batch

``tf32``: the control.  The plain reference is put in the program's place
and computed with TF32 products (the nearest precision below the float32
that the configurations state), on the batches a run of the cell compares:
the first three of the third epoch of the trainer's own loader
(``perfbench/core/train_cell.py``).  Its readings go against the reference
in IEEE float32 through the same comparison (``perfbench/core/check.py``).

``program``: the program as it ships, through a whole run of one second:
the readings that a limit's lower end comes from.  ``half_batch``: the
same, its loss taken over the first half of each batch's rows only (the
mean over the rest).

One JSON line of the numbers a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def control_numbers(r) -> dict:
    """The run's compared batches, chosen as the run chooses them, with the
    reference in TF32 as the program's readings."""
    import torch

    from perfbench.core import harness, manifest, program, traffic, train_cell, weights

    ref = manifest.reference(r.cell["config"])
    plain = ref.plain
    r.data = traffic.dialogues(r.mix["corpus"], r.seed)
    index = {d["text"][0].tobytes(): i for i, d in enumerate(r.data)}
    t = program.trainer(r.cfg, r.seed % (1 << 63), "cpu")  # the loader's order alone: no step is run
    feed = train_cell.Feed(program.train_loader(t, r.data))
    try:
        for _ in range(2 * len(feed)):
            feed.next()
        batches = []
        for _ in range(train_cell.COMPARED_STEPS):
            hb = feed.next()
            batches.append([index[hb["text_feature"][row, 0].tobytes()] for row in program.real_rows(hb)])
    finally:
        feed.close()
    dev = torch.device(r.device)
    w = weights.make({**ref.param_specs(r.model), **ref.buffer_specs(r.model)}, r.seed, dev)
    r.extra["weights"] = w
    params = {n: w[n] for n in ref.param_specs(r.model)}
    buffers = {n: w[n] for n in ref.buffer_specs(r.model)}
    tb = [plain.batch([r.data[i] for i in ids], r.model["modality"], dev) for ids in batches]
    with plain.tf32():
        r.readings = plain.train_readings(functools.partial(ref.forward, m=r.model), params, buffers, tb,
                                          r.cfg["train"]["optim"])
    r.readings["batches"] = batches
    return harness.compare(r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("program", "tf32", "half_batch"), required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.core import harness, manifest
    from perfbench.core.context import Run

    os.environ["ERC_TPU_EXPROOT"] = tempfile.mkdtemp(prefix="perfbench-control-")
    bench = manifest.benchmark(ROOT)
    cell = manifest.cell(bench, args.workload)
    cfg, mix = manifest.config(cell["config"]), manifest.mix(cell["traffic"])
    if args.mode == "half_batch":
        from erc_tpu_torch.train import trainer as tr

        full = tr.masked_cross_entropy

        def half(logits, labels, mask, class_weights=None):
            keep = torch.zeros_like(mask)
            keep[: mask.shape[0] // 2] = 1
            return full(logits, labels, mask * keep, class_weights)

        tr.masked_cross_entropy = half
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        if args.mode != "tf32":
            with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
                result, r = harness.run_cell(bench, args.workload, seed, args.seconds, False, "cuda:0", t0)
            numbers = {k: v["value"] for k, v in result["checks"].items()}
            numbers["kinks"] = r.extra["detail"].get("relu inputs near 0, sides taken")
        else:
            r = Run(cell=cell, cfg=cfg, mix=mix, seed=seed, seconds=args.seconds, traced=False, device="cuda:0",
                    work=manifest.work(cell["config"]))
            numbers = control_numbers(r)
            numbers["kinks"] = r.extra["detail"].get("relu inputs near 0, sides taken")
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
