"""Spans on the host clock, and the device trace of a traced segment.

``Spans`` records the benchmark's spans around its calls into the program
(name, start, end on ``time.perf_counter``); inside a traced segment each
span is also a ``torch.profiler.record_function`` range, so that the trace
holds it on the device events' clock.

``traced(fn)`` runs ``fn`` under ``torch.profiler`` (host and device
activity) and returns a ``Trace``: the device operations (kernels, copies,
memsets) and the benchmark's ranges, in microseconds on one clock.  Busy
time is the union of the device operations' intervals, as ``chip_smoke.py``'s
``_profile`` takes it.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench."  # the benchmark's ranges in a trace


@dataclass
class Span:
    name: str
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Spans:
    def __init__(self):
        self.spans: List[Span] = []
        self.ranges = False  # inside a traced segment: spans are profiler ranges too

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.ranges:
            import torch

            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.spans.append(Span(name, t0, t1))

    def named(self, name: str, since: float = float("-inf"), until: float = float("inf")) -> List[Span]:
        return [s for s in self.spans if s.name == name and s.start >= since and s.end <= until]


@dataclass
class Trace:
    ops: List[Tuple[str, float, float]]  # device operations: name, start us, end us
    ranges: List[Tuple[str, float, float]]  # the benchmark's ranges (prefix dropped)
    window: Tuple[float, float]  # the traced segment, us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def ops_named(self, names) -> List[Tuple[str, float, float]]:
        return [o for o in self.ops if any(n in o[0] for n in names)]

    def busy_intervals(self, lo: Optional[float] = None, hi: Optional[float] = None) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to [lo, hi]."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        spans = sorted((max(a, lo), min(b, hi)) for _, a, b in self.ops if b > lo and a < hi)
        out: List[Tuple[float, float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self, lo: Optional[float] = None, hi: Optional[float] = None) -> float:
        return sum(b - a for a, b in self.busy_intervals(lo, hi)) / 1e6

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time, by name, and the idle
        time of the segment by what the host was doing (the innermost of the
        benchmark's ranges open at each gap's start)."""
        by_name: Dict[str, float] = {}
        for n, a, b in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
        idle: Dict[str, float] = {}
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for ab in busy for x in ab] + [self.window[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            open_ = [r for r in self.ranges if r[1] <= a < r[2]]
            label = min(open_, key=lambda r: r[2] - r[1])[0] if open_ else "outside the benchmark's spans"
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}


def traced(fn: Callable[[], None], spans: Spans, device) -> Trace:
    """``fn`` under the profiler, inside a range of its own that marks the
    segment; the device synchronised at its end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spans.ranges = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with spans("segment"):
                fn()
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
    finally:
        spans.ranges = False
    ops, ranges, window = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "activity_type", "kernel") in DEVICE_WORK and not e.is_user_annotation:
                ops.append((e.name, float(tr.start), float(tr.end)))
        elif e.name.startswith(PREFIX):
            name = e.name[len(PREFIX):]
            ranges.append((name, float(tr.start), float(tr.end)))
            if name == "segment":
                window = (float(tr.start), float(tr.end))
    if window is None:
        raise RuntimeError("the profiler recorded no segment range")
    ops = [o for o in ops if o[2] > window[0] and o[1] < window[1]]
    return Trace(ops, ranges, window)
