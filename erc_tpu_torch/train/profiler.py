"""Profiling: device traces, named regions and host step timing.

Port of ``erc_tpu.train.profiler``:

- ``trace(dir)``: a ``torch.profiler.profile`` of the block, with CPU
  activity and, where CUDA is available, the card's (kernels, copies and
  memsets, the kernels inside replayed CUDA graphs too), exported as a
  Chrome trace into ``dir`` (``chrome://tracing`` or Perfetto opens it);
- ``annotate(name)``: a named region in such a trace
  (``torch.profiler.record_function``);
- ``StepTimer``: host wall-clock step timing with percentiles.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional

TRACE_FILE = "trace.pt.trace.json"


def activities(cuda: Optional[bool] = None):
    """CPU activity, and the card's where CUDA is available (or ``cuda``)."""
    import torch
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available() if cuda is None else cuda
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


@contextlib.contextmanager
def trace(log_dir: str, metadata: Optional[Dict[str, Any]] = None, cuda: Optional[bool] = None):
    """Profile the block and write ``<log_dir>/trace.pt.trace.json``;
    ``metadata`` (json-able values) lands in the trace's top level.  Yields
    the profiler."""
    import torch
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities(cuda))
    prof.start()
    try:
        for key, value in (metadata or {}).items():
            prof.add_metadata_json(key, json.dumps(value))
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    from torch.profiler import record_function

    return record_function(name)


class StepTimer:
    """Wall-clock step timing with warmup skip and percentile summary."""

    def __init__(self, skip_first: int = 3):
        self.skip_first = skip_first
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.skip_first:
            self._times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[int(n * 0.9)],
            "max_s": ts[-1],
            "steps_per_s": n / sum(ts),
        }
