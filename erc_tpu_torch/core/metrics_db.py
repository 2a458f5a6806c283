"""Metric persistence (reference: lumo/core/disk.py — TableRow + Metrics).

Port of ``erc_tpu.core.metrics_db``: given the same calls, the three stores
write the JAX package's files byte for byte.  ``write=False`` (every process
but 0, once several train one model) keeps each decision in memory and
writes nothing.

- ``BestMetrics``: best-so-far compare-and-set per run (disk.py:53-105),
  stored as json next to the experiment metadata.
- ``MetricBoard``: append-only per-step metric log (disk.py:8-24's sqlite
  PList, rebuilt as jsonl — trivially greppable, no sqlite locking issues
  across hosts).
- ``PredictionStore``: raw (true, pred) dumps per test (mmbase.py:140,322).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


def _jsonable(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, torch.Tensor):
        return _jsonable(v.detach().cpu().numpy())
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class BestMetrics:
    def __init__(self, path: str, write: bool = True):
        # write=False (non-main processes): CAS decisions still happen
        # in-memory — identical on every process — but only process 0
        # touches the file (concurrent writers would corrupt it)
        self.path = path
        self.write = write
        self._data: Dict[str, Any] = {}
        if os.path.exists(path):
            with open(path) as f:
                self._data = json.load(f)

    def update_metric(self, key: str, value, compare: str = "max") -> Dict[str, Any]:
        """Compare-and-set; returns {key: best_value} (reference: disk.py:53-77)."""
        cur = self._data.get(key)
        better = (
            cur is None
            or (compare == "max" and value > cur)
            or (compare == "min" and value < cur)
        )
        if better:
            self._data[key] = _jsonable(value)
        return {key: self._data[key]}

    def update_metric_pair(
        self, key: str, value, key2: str, value2, compare: str = "max"
    ) -> Dict[str, Any]:
        """CAS on `key`; `key2` rides along with the winning step (disk.py:79-105)."""
        cur = self._data.get(key)
        better = (
            cur is None
            or (compare == "max" and value > cur)
            or (compare == "min" and value < cur)
        )
        if better:
            self._data[key] = _jsonable(value)
            self._data[key2] = _jsonable(value2)
        return {key: self._data[key], key2: self._data.get(key2)}

    def update_metrics(self, metrics: Dict[str, Any], compare: str = "max") -> Dict[str, Any]:
        out = {}
        for k, v in metrics.items():
            out.update(self.update_metric(k, v, compare=compare))
        return out

    def todict(self) -> Dict[str, Any]:
        return dict(self._data)

    def flush(self):
        if not self.write:
            return
        with open(self.path, "w") as f:
            json.dump(self._data, f, indent=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()


class MetricBoard:
    def __init__(self, path: str, write: bool = True):
        self.path = path
        self.write = write
        self._buf = []

    def append(self, metrics: Dict[str, Any], step: int, stage: str = "train"):
        self._buf.append({"step": step, "stage": stage, **_jsonable(metrics)})

    def flush(self):
        if not self._buf:
            return
        if self.write:
            with open(self.path, "a") as f:
                for row in self._buf:
                    f.write(json.dumps(row, default=str) + "\n")
        self._buf.clear()

    @staticmethod
    def load(path: str) -> list:
        if not os.path.exists(path):
            return []
        rows = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    # a preemption mid-append can tear the last line; one
                    # lost row must not make the whole board unreadable
                    continue
        return rows


class PredictionStore:
    def __init__(self, path: str, write: bool = True):
        self.path = path
        self.write = write
        self._buf = []

    def append(self, item):
        self._buf.append(_jsonable(item))

    def flush(self):
        if not self._buf:
            return
        if self.write:
            with open(self.path, "a") as f:
                for row in self._buf:
                    f.write(json.dumps(row) + "\n")
        self._buf.clear()
