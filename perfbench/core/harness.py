"""One run of one cell: set-up, the window, the traced segment, the
comparison with the plain reference, the metrics, and the result's line."""

from __future__ import annotations

import importlib
import time
from types import ModuleType
from typing import Dict, Optional, Tuple

from perfbench.core import check, manifest
from perfbench.core.context import Run
from perfbench.core.trace import Span


def kind(mix: Dict) -> ModuleType:
    """The cell runner of a mix's ``kind``: ``perfbench/core/<kind>_cell.py``,
    with ``run(r)`` and ``compare(r, precision, mm)``."""
    return importlib.import_module(f"perfbench.core.{mix['kind']}_cell")


def compare(r: Run, precision=None, mm=None) -> Dict[str, float]:
    """The numbers of ``check`` for this run: the program's readings
    against the reference's, computed in ``precision`` (a context; IEEE
    float32 by default) with ``mm`` for its products."""
    return kind(r.mix).compare(r, precision, mm)


def run_cell(bench: Dict, name: str, seed: int, seconds: float, traced: bool, device: str,
             t_process: float, cfg: Optional[Dict] = None, mix: Optional[Dict] = None,
             device_info: Optional[Dict] = None) -> Tuple[Dict, Run]:
    cell = manifest.cell(bench, name)
    cfg = cfg or manifest.config(cell["config"])
    mix = mix or manifest.mix(cell["traffic"])
    r = Run(cell=cell, cfg=cfg, mix=mix, seed=seed, seconds=seconds, traced=traced, device=device,
            work=manifest.work(cell["config"]))
    r.extra["t_process"] = t_process
    r.extra["detail"] = {}
    r.spans.spans.append(Span("setup.process", t_process, time.perf_counter()))  # imports, the card's name
    kind(mix).run(r)

    t0 = time.perf_counter()
    readings = compare(r)
    r.extra["check_s"] = time.perf_counter() - t0
    limits = cfg["limits"][mix["kind"]]
    numbers = {k: readings[k] for k in limits}
    r.extra["detail"].update({f"{k} (not compared)": v for k, v in readings.items() if k not in limits})
    _report(r)
    correct = check.verdict(numbers, limits)

    metrics = {}
    for m in manifest.metrics_of(bench, name, traced):
        v = manifest.metric_reader(m["name"]).read(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = dict(device_info or {"platform": "cpu", "kind": "cpu", "count": 1})
    dev["memory_peak_bytes"] = int(r.extra["memory_peak_bytes"])
    result = {"correct": bool(correct), "attempted": int(r.extra["attempted"]), "failed": int(r.extra["failed"]),
              "metrics": metrics, "device": dev}
    if r.trace is not None:
        dev["busy_s"] = r.trace.busy_s()
        dev["window_s"] = r.trace.window_s
        result["breakdown"] = r.trace.breakdown()
    result["checks"] = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    return result, r


def _report(r: Run) -> None:
    """What the run did, on standard error (the result's line is on standard output)."""
    import sys

    def say(*a):
        print(*a, file=sys.stderr, flush=True)

    for sp in r.spans.spans:
        if sp.name.startswith("setup."):
            say(f"span {sp.name} {sp.seconds:.3f} s")
    w = r.window
    say(f"setup_s {r.setup_s:.3f}; window {w['end'] - w['start']:.3f} s, "
        + ", ".join(f"{k} {w[k]}" for k in ("steps", "requests", "dialogues", "late") if k in w)
        + f"; comparison {r.extra['check_s']:.3f} s; memory peak {r.extra['memory_peak_bytes']} bytes")
    for name in ("loader.next", "train_batch", "predict"):
        sp = r.spans.named(name, w["start"], w["end"])
        if sp:
            say(f"span {name} in the window: {len(sp)}, mean {1e3 * sum(x.seconds for x in sp) / len(sp):.3f} ms")
    if "buckets" in r.extra:
        say(f"buckets warmed {r.extra['buckets']}")
    for k, due, ms, n in r.extra.get("slowest", []):
        say(f"slow request {k}: due at {due:.3f} s, {ms:.3f} ms, {n} dialogues")
    for k, v in r.extra.get("detail", {}).items():
        say(f"detail {k} {v}")
