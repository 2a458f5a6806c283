"""Spans of the port's hot path, recorded while a ``torch.profiler`` records.

``span(name, **attrs)`` marks a stretch of host work::

    with tracing.span("step", step=trainer.global_steps, k=1):
        ...

Outside a profiler it reads one flag, torch's own
(``torch.autograd.profiler._is_profiler_enabled``), and returns ``OFF``, a
shared object that does nothing: no clock read, no span, no range, nothing
kept (the call's keyword dict, where it passes attributes, and the ``with``
statement's bound methods are freed at once).  Inside one
(the trainer's ``--profile_steps`` trace, the benchmark's traced segment,
any caller's ``torch.profiler.profile``) a span

- opens a ``torch.profiler.record_function("erc.<name>")`` range, so that
  the Chrome trace holds it on the device events' clock;
- on closing, appends itself to an in-memory record of the last
  ``CAPACITY`` spans: its name, start (read once the range is open) and
  end (read once it is closed) on ``time.perf_counter``, its thread, its
  parent (the innermost span open on that thread when it opened), its
  step (its ``step`` attribute, else its parent's: the trainer's
  ``global_steps``, which every span of one optimizer step shares) and its
  attributes.

``spans(since, until)`` returns the recorded spans that lie within an
interval of ``time.perf_counter``.  A span is falsy where it records
nothing, so an attribute that costs something to compute is computed only
where it is kept::

    with tracing.span("loader.get") as sp:
        if sp:
            sp.attrs["empty"] = q.empty()

Never yield inside a span: the parent of each thread's next span is read
from the spans open on that thread.  A range opened on a thread that the
profiler does not follow (the prefetch loader's producer) may miss the
profiler's events; its span reaches the record all the same.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "erc."  # the spans' ranges in a trace
CAPACITY = 1 << 16

_record: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_open = threading.local()  # .top: the innermost span open on the thread


class Span:
    """One recorded span (``start`` and ``end`` on ``time.perf_counter``)."""

    __slots__ = ("name", "start", "end", "thread", "parent", "step", "attrs", "_range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs
        self.start = self.end = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self) -> "Span":
        self.parent: Optional[Span] = getattr(_open, "top", None)
        self.step = self.attrs.get("step", None if self.parent is None else self.parent.step)
        self.thread = threading.get_ident()
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        _open.top = self
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _open.top = self.parent
        self._range.__exit__(*exc)  # the range's end is stamped late in its exit
        self.end = time.perf_counter()
        self._range = None
        _record.append(self)

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {1e3 * self.seconds:.3f} ms, step={self.step}, {self.attrs})"


class _Off:
    """The span outside a profiler: records nothing, and is falsy."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def __bool__(self) -> bool:
        return False


OFF = _Off()


def span(name: str, **attrs):
    """A span named ``name`` (its range ``erc.<name>``) with ``attrs``, or
    ``OFF`` where no profiler records."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name, attrs)


def spans(since: float = float("-inf"), until: float = float("inf")) -> List[Span]:
    """The recorded spans that start at or after ``since`` and end at or
    before ``until``, in the order they closed."""
    return [s for s in list(_record) if s.start >= since and s.end <= until]
