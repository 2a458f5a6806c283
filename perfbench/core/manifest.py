"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``perfbench/configs/<config>.json``, with its
plain reference ``perfbench/reference/<config>.py`` and its model FLOPs
``perfbench/work/<config>.py``) and a traffic mix
(``perfbench/traffic/<mix>.json``).  Every metric is a reader of its own,
``perfbench/metrics/<metric>.py``.  Adding any of them is adding a file.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]  # perfbench/
ROOT = HERE.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, base: Path = HERE) -> Dict:
    return read_json(base / "configs" / f"{name}.json")


def mix(name: str, base: Path = HERE) -> Dict:
    return read_json(base / "traffic" / f"{name}.json")


def load_file(path: Path) -> ModuleType:
    """The module in ``path``, loaded by its path: names such as
    ``dagerc-iemocap`` or ``dag_roofline_pct.train`` are no Python
    identifiers."""
    mod_name = "perfbench_file_" + re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference(name: str, base: Path = HERE) -> ModuleType:
    return load_file(base / "reference" / f"{name}.py")


def work(name: str, base: Path = HERE) -> ModuleType:
    return load_file(base / "work" / f"{name}.py")


def metric_reader(name: str, base: Path = HERE) -> ModuleType:
    return load_file(base / "metrics" / f"{name}.py")


def _reports(metric: Dict, cell_name: str) -> bool:
    return cell_name in metric.get("workloads", [cell_name])


def metrics_of(bench: Dict, cell_name: str, traced: bool) -> List[Dict]:
    """The metrics a run of ``cell_name`` prints: its end-to-end metrics, or
    with ``--trace 1`` its per-layer ones.  A per-layer metric with no
    ``workloads`` key goes to every cell that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell_name)]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
