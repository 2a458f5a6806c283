"""Device-memory probe.

Port of ``erc_tpu.core.memstat`` onto PyTorch's caching allocator:

- ``device_memory_stats``: the allocator's counters for one card
  (``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``) under the
  JAX function's normalised keys, or None on the CPU, where the JAX
  function gives None too;
- ``live_array_summary``: the live CUDA tensors that the garbage collector
  can see, grouped by (shape, dtype), largest first;
- ``memory_report``: one formatted snapshot of both.

``MemoryMonitor`` (``train/callbacks.py``) logs the per-epoch peak.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Optional

import torch

# the JAX function's keys, from the caching allocator's counters
_KEYS = (
    ("allocated_bytes.all.current", "bytes_in_use"),
    ("allocated_bytes.all.peak", "peak_bytes_in_use"),
    ("allocation.all.allocated", "num_allocs"),
)


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """Normalised allocator counters of one card (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``: the card's total memory,
    ``bytes_free``: what CUDA reports free, ``num_allocs``:
    allocations made since the start, ``largest_alloc_size``: the largest
    block in use), or None for a CPU device or where CUDA is absent."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    raw = torch.cuda.memory_stats(device)
    out = {norm: int(raw[k]) for k, norm in _KEYS if k in raw}
    free, total = torch.cuda.mem_get_info(device)
    out["bytes_limit"] = int(total)
    out["bytes_free"] = int(free)
    blocks = [b["size"] for seg in torch.cuda.memory_snapshot() if seg.get("device") == device.index
              for b in seg.get("blocks", ()) if b.get("state") == "active_allocated"]
    if blocks:
        out["largest_alloc_size"] = int(max(blocks))
    return out


def live_array_summary(top_k: int = 20) -> List[Dict]:
    """Live CUDA tensor census grouped by (shape, dtype, device), largest
    first: what holds the card's memory, without a trace."""
    groups: Dict[tuple, Dict] = {}
    for obj in gc.get_objects():
        try:
            if not issubclass(type(obj), torch.Tensor) or not obj.is_cuda:
                continue
            shape, dtype = tuple(obj.shape), str(obj.dtype).replace("torch.", "")
            nbytes = obj.numel() * obj.element_size()
            kind = str(obj.device)
        except (ReferenceError, RuntimeError):  # a dead weak proxy, a tensor freed under the census
            continue
        g = groups.setdefault((shape, dtype, kind),
                              {"shape": shape, "dtype": dtype, "platform": kind, "count": 0, "bytes": 0})
        g["count"] += 1
        g["bytes"] += nbytes
    return sorted(groups.values(), key=lambda g: -g["bytes"])[:top_k]


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n:.1f}TiB"


def memory_report(top_k: int = 12) -> str:
    """Formatted snapshot: each card's allocator counters and the largest
    live-tensor groups."""
    lines = []
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        lines.append("cpu: no allocator stats exposed")
    for i in range(n):
        d = torch.device("cuda", i)
        stats = device_memory_stats(d)
        parts = [f"in_use={_fmt_bytes(stats['bytes_in_use'])}"]
        for key, name in (("peak_bytes_in_use", "peak"), ("bytes_limit", "limit"), ("bytes_free", "free")):
            if key in stats:
                parts.append(f"{name}={_fmt_bytes(stats[key])}")
        lines.append(f"{d} ({torch.cuda.get_device_name(d)}): " + " ".join(parts))
    rows = live_array_summary(top_k)
    if rows:
        lines.append(f"live arrays (top {len(rows)} groups):")
        for g in rows:
            shape = "x".join(map(str, g["shape"])) or "scalar"
            lines.append(f"  {_fmt_bytes(g['bytes']):>10}  {g['count']:>4}x {shape} {g['dtype']} [{g['platform']}]")
    return "\n".join(lines)
