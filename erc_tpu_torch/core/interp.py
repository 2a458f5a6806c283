"""Value-interpolation curves, and the LR schedules made of them.

Port of ``erc_tpu.core.interp``: each curve is a pure ``f(step) -> value`` on
the host, and ``to_schedule(curve)`` is the counterpart of
``to_optax_schedule``: the same curve as a function of a step count held as
a tensor, which the captured train step evaluates on the card (between the
inner steps of a K-step replay the host cannot write the LR).  ``Constant``,
``Linear``, ``Cos`` and ``PowerDecay`` are computed in float32 from the
count, as the JAX package's jnp versions are; every other curve is read
from a float32 table of its values at steps 0..horizon, horizon
``int(right or period or 1000) + 1``, the step taken modulo the horizon for
the periodic curves and clipped to [0, horizon] otherwise (the JAX
package's table, quirk included: a periodic curve's table repeats every
``period + 1`` steps).
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch


class Interp:
    def __init__(self, start: float, end: float, left: float = 0, right: float = 1):
        self.start, self.end = float(start), float(end)
        self.left, self.right = float(left), float(right)

    def _ratio(self, step) -> float:
        if self.right <= self.left:
            return 1.0
        r = (float(step) - self.left) / (self.right - self.left)
        return min(max(r, 0.0), 1.0)

    def interp(self, r: float) -> float:
        raise NotImplementedError

    def __call__(self, step) -> float:
        return self.interp(self._ratio(step))


class Constant(Interp):
    def __init__(self, value: float):
        super().__init__(value, value)

    def interp(self, r):
        return self.start


class Linear(Interp):
    def interp(self, r):
        return self.start + (self.end - self.start) * r


class Cos(Interp):
    def interp(self, r):
        return self.end + (self.start - self.end) * (1 + math.cos(math.pi * r)) / 2


class Exp(Interp):
    def interp(self, r):
        return self.start + (self.end - self.start) * (math.exp(5 * r) - 1) / (math.e**5 - 1)


class Log(Interp):
    def interp(self, r):
        return self.start + (self.end - self.start) * math.log(1 + r * (math.e - 1))


class PowerDecay(Interp):
    def __init__(self, start: float, decay: float, period: float):
        super().__init__(start, 0)
        self.decay, self.period = decay, period

    def __call__(self, step):
        return self.start * (self.decay ** (float(step) / self.period))


class _Periodic(Interp):
    def __init__(self, start, end, period):
        super().__init__(start, end, 0, period)
        self.period = float(period)

    def _phase(self, step) -> float:
        return (float(step) % self.period) / self.period


class PeriodCos(_Periodic):
    def __call__(self, step):
        return self.end + (self.start - self.end) * (1 + math.cos(2 * math.pi * self._phase(step))) / 2


class HalfPeriodCos(_Periodic):
    def __call__(self, step):
        return self.end + (self.start - self.end) * (1 + math.cos(math.pi * self._phase(step))) / 2


class PeriodTriangle(_Periodic):
    def __call__(self, step):
        tri = 1 - abs(2 * self._phase(step) - 1)
        return self.start + (self.end - self.start) * tri


class PeriodLinear(_Periodic):
    def __call__(self, step):
        return self.start + (self.end - self.start) * self._phase(step)


class InterpList:
    """Piecewise schedule: list of (curve, until_step) segments."""

    def __init__(self, segments: List[tuple]):
        self.segments = segments

    def __call__(self, step):
        for curve, until in self.segments:
            if float(step) < until:
                return curve(step)
        return self.segments[-1][0](step)


CURVES = {c.__name__: c for c in (Constant, Linear, Cos, Exp, Log, PowerDecay, PeriodCos, HalfPeriodCos,
                                  PeriodTriangle, PeriodLinear, InterpList)}


def to_schedule(curve) -> Callable[[torch.Tensor], torch.Tensor]:
    """``curve`` as a function of a step count (an integer tensor) giving a
    0-d float32 tensor on the count's device, with no host sync: the
    counterpart of ``erc_tpu.core.interp.to_optax_schedule``.  A table is
    copied to a device at its first call there, which must not be inside a
    CUDA graph's capture (the captured step's eager warm-up comes first)."""
    if isinstance(curve, Constant):
        return lambda step: torch.full((), curve.start, dtype=torch.float32, device=step.device)
    if isinstance(curve, (Linear, Cos)):
        denom = max(curve.right - curve.left, 1e-9)

        def ramp(step):
            r = ((step.float() - curve.left) / denom).clamp(0, 1)
            if isinstance(curve, Linear):
                return curve.start + (curve.end - curve.start) * r
            return curve.end + (curve.start - curve.end) * (1 + torch.cos(math.pi * r)) / 2

        return ramp
    if isinstance(curve, PowerDecay):
        return lambda step: curve.start * (curve.decay ** (step.float() / curve.period))

    horizon = int(getattr(curve, "right", 0) or getattr(curve, "period", 0) or 1000) + 1
    values = np.array([curve(s) for s in range(horizon + 1)], np.float32)
    tables = {}
    periodic = getattr(curve, "period", None) is not None and not hasattr(curve, "decay")

    def lookup(step):
        table = tables.get(step.device)
        if table is None:
            table = tables[step.device] = torch.from_numpy(values).to(step.device)
        idx = step.long() % horizon if periodic else step.long().clamp(0, horizon)
        return table[idx]

    return lookup


def build_curve(cfg):
    """The curve of a ``--optim.sche`` config: its ``name`` and the curve's
    keyword arguments."""
    kw = {k: v for k, v in cfg.items() if k != "name"}
    name = cfg.get("name")
    if name not in CURVES:
        raise ValueError(f"unknown schedule {name!r}: one of {sorted(CURVES)}")
    return CURVES[name](**kw)
