"""Weights made from ``--seed`` on the device, in three calls, handed to the
program and to the reference alike.

A reference lists its tensors as ``name → (shape, init)``, with the names of
the port's ``state_dict`` keys: ``("uniform", a)`` draws U(-a, a), ``("zeros",)``
and ``("ones",)`` fill.  One generator on the device draws every uniform
value at once; one multiply scales each tensor's slice by its own bound.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Spec = Dict[str, Tuple[Tuple[int, ...], tuple]]


def make(specs: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    drawn = [(n, shape, init[1]) for n, (shape, init) in specs.items() if init[0] == "uniform"]
    sizes = [math.prod(shape) for _, shape, _ in drawn]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
    bounds = torch.repeat_interleave(torch.tensor([float(a) for _, _, a in drawn], device=device),
                                     torch.tensor(sizes, device=device))
    flat.mul_(bounds)
    out: Dict[str, torch.Tensor] = {}
    for (name, shape, _), part in zip(drawn, flat.split(sizes)):
        out[name] = part.view(shape)
    for name, (shape, init) in specs.items():
        if init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init[0] != "uniform":
            raise ValueError(f"{name}: unknown init {init!r}")
    return {n: out[n] for n in specs}


def count(specs: Spec) -> int:
    return sum(math.prod(shape) for shape, _ in specs.values())
