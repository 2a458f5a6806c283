"""Step-metric aggregation (``Meter``, ``Record``).

Port of ``erc_tpu.core.meter``: ``meter.mean.Lall = loss`` selects the
aggregation of a key (``mean``, ``sum``, ``last``, ``max``, ``min``,
``smean``); a ``Record`` folds a stream of meters into running aggregates
for an epoch or a stage.  Values may be Python scalars, numpy values or
torch tensors.  A tensor stays a tensor: it accumulates on its device
(``+``, ``torch.maximum``, ``torch.minimum``, which queue work and wait for
nothing) and is read back once, in ``Record.agg``, never once per step.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_AGGS = ("mean", "sum", "last", "max", "min", "smean")


def _to_scalar(v: Any) -> Any:
    """A Python or numpy value of ``v`` (a tensor is read back from its device)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return v.item()
    return v


class _AggProxy:
    __slots__ = ("_meter", "_agg")

    def __init__(self, meter: "Meter", agg: str):
        object.__setattr__(self, "_meter", meter)
        object.__setattr__(self, "_agg", agg)

    def __setattr__(self, key: str, value: Any):
        self._meter._set(key, value, self._agg)

    def __setitem__(self, key: str, value: Any):
        self._meter._set(key, value, self._agg)


class Meter:
    """One step's metrics. Default aggregation is ``mean``."""

    def __init__(self):
        object.__setattr__(self, "_vals", {})
        object.__setattr__(self, "_aggs", {})

    def _set(self, key: str, value: Any, agg: str):
        self._vals[key] = value
        self._aggs[key] = agg

    def __setattr__(self, key: str, value: Any):
        self._set(key, value, self._aggs.get(key, "mean"))

    def __getattr__(self, key: str):
        if key in _AGGS:
            return _AggProxy(self, key)
        try:
            return self._vals[key]
        except KeyError:
            raise AttributeError(key)

    def __setitem__(self, key, value):
        self.__setattr__(key, value)

    def __getitem__(self, key):
        return self._vals[key]

    def __contains__(self, key):
        return key in self._vals

    def update(self, d: Dict[str, Any]) -> "Meter":
        for k, v in d.items():
            self[k] = v
        return self

    def items(self):
        return self._vals.items()

    def keys(self):
        return self._vals.keys()

    def todict(self) -> Dict[str, Any]:
        return {k: _to_scalar(v) for k, v in self._vals.items()}

    def scalar_items(self):
        return self.todict().items()

    def __repr__(self):
        return _format(self.todict())


def _format(values: Dict[str, Any]) -> str:
    return " | ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in values.items())


class _AggItem:
    """Running aggregate of one key; a tensor accumulates on its device and
    is read back only in ``value()``."""

    __slots__ = ("agg", "acc", "n", "last")

    def __init__(self, agg: str):
        self.agg = agg
        self.acc = None
        self.n = 0
        self.last = None

    def add(self, v: Any):
        if not isinstance(v, torch.Tensor):
            v = _to_scalar(v)
        self.last = v
        self.n += 1
        if self.acc is None:
            self.acc = v
            return
        if self.agg in ("mean", "sum", "smean"):
            self.acc = self.acc + v
        elif self.agg in ("max", "min"):
            if isinstance(self.acc, torch.Tensor) or isinstance(v, torch.Tensor):
                op = torch.maximum if self.agg == "max" else torch.minimum
                self.acc = op(torch.as_tensor(self.acc), torch.as_tensor(v))
            else:
                self.acc = (max if self.agg == "max" else min)(self.acc, v)
        elif self.agg == "last":
            self.acc = v

    def value(self):
        if self.acc is None:
            return None
        acc = _to_scalar(self.acc)
        if self.agg in ("mean", "smean"):
            return acc / max(self.n, 1)
        return acc


class Record:
    """Aggregates a stage's meters."""

    def __init__(self, stage: str = "train"):
        self.stage = stage
        self._items: Dict[str, _AggItem] = {}

    def record(self, meter: Meter):
        if meter is None:
            return
        if isinstance(meter, dict):
            meter = Meter().update(meter)
        for k, v in meter._vals.items():
            agg = meter._aggs.get(k, "mean")
            item = self._items.get(k)
            if item is None or item.agg != agg:
                item = _AggItem(agg)
                self._items[k] = item
            item.add(v)

    def agg(self) -> Dict[str, Any]:
        return {k: it.value() for k, it in self._items.items()}

    def clear(self):
        self._items.clear()

    def __repr__(self):
        return _format(self.agg())
