"""Profiling: device traces.

Port of ``erc_tpu.train.profiler``'s ``trace``: ``trace(dir)`` is a
``torch.profiler.profile`` of the block, with CPU activity and, where CUDA
is available, the card's (kernels, copies and memsets, the kernels inside
replayed CUDA graphs too), exported as a Chrome trace into ``dir``
(``chrome://tracing`` or Perfetto opens it).  While it records, the port's
spans (``core.tracing``: the train step, its wait, staging and launch, the
loader's gets and collation, captures) are ranges named ``erc.<span>`` in
it, and reach ``tracing.spans``.  The JAX module's ``annotate`` and
``StepTimer`` have no counterpart: ``tracing.span`` names regions, and the
trainer times its epochs.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Optional

TRACE_FILE = "trace.pt.trace.json"


def trace_file(rank: int = 0) -> str:
    """The trace's file name: ``TRACE_FILE`` for rank 0, ``trace.<rank>.pt.trace.json``
    for the other ranks of a process group.  Every rank traces, as every
    process of the JAX package's ``jax.profiler`` does, into one file each."""
    return TRACE_FILE if rank == 0 else f"trace.{rank}.pt.trace.json"


def activities(cuda: Optional[bool] = None):
    """CPU activity, and the card's where CUDA is available (or ``cuda``)."""
    import torch
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available() if cuda is None else cuda
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


@contextlib.contextmanager
def trace(log_dir: str, metadata: Optional[Dict[str, Any]] = None, cuda: Optional[bool] = None,
          file: str = TRACE_FILE):
    """Profile the block and write ``<log_dir>/<file>`` (``trace.pt.trace.json``);
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
        prof.export_chrome_trace(os.path.join(log_dir, file))
