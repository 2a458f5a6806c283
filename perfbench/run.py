"""The benchmark of ``erc_tpu_torch`` on the card: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  A cell of ``BENCHMARK.json`` names its
configuration (``perfbench/configs/``), its traffic mix
(``perfbench/traffic/``) and the chips it needs.  The run sets up, measures
for ``--seconds``, traces a segment after the window where ``--trace 1``,
compares what the timed path produced with the plain reference
(``perfbench/reference/``), and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, each read by
``perfbench/metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``,
and ``checks``, each number compared beside its limit (also the last lines
of standard error).  Everything else the program prints goes to standard
error.  The run exits with another code than 0, and prints no result, where
the card is missing or too few, or where JAX or the JAX package was loaded.

The program runs as it ships: the harness sets none of torch's or
Python's runtime settings.  The trainer's experiment directories go under
``$TMPDIR``, removed at the end; the port builds its kernels inside the
checkout (``erc_tpu_torch/_build/``), so only a cell's first run there
compiles.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "erc_tpu")


def loaded_forbidden() -> list:
    """Modules loaded whose top-level name (before the first dot) is, whole,
    one of JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "--id=0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() or "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.core import harness, manifest

    bench = manifest.benchmark(ROOT)
    cell = manifest.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell["chips"]),
                   "power_limit": power_limit()}
    scratch = tempfile.mkdtemp(prefix="perfbench-")  # under $TMPDIR
    os.environ["ERC_TPU_EXPROOT"] = scratch
    try:
        with contextlib.redirect_stdout(sys.stderr):
            result, _ = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                                         T_PROCESS, device_info=device_info)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    bad = loaded_forbidden()
    if bad:
        print(f"JAX or the JAX package was loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
