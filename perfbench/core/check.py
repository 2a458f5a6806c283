"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference in IEEE float32 on the same inputs and weights.

Training, the first three steps of the trainer that the window then drives:

- ``loss_first``, ``loss_steps``: the relative gap of the first step's loss,
  and the largest of the three steps';
- ``grad_worst``: the first step's gradient as the optimizer took it (worked
  out from Adam's first moment after one step), by the worst leaf: the gap
  between the two norms over the larger of the reference leaf's norm and
  the median leaf's.  The reference takes each ReLU input within rounding
  of 0 on the side nearest the program (``plain.first_grads``);
- ``change_worst``: the parameters' change after the three steps, likewise,
  over the elements whose reference first gradient is at least a thousandth
  of the median leaf's root mean square element: an element under a
  softmax's shift (a key's bias, the query half of DAG-ERC's ``att_w``) has
  a gradient of rounding alone, which Adam's first updates, normalised by
  the gradient itself, turn into steps of up to the learning rate either
  way.

The first step's loss and gradient are held close; the later steps' losses
and the change carry Adam's first updates: their limits are wider.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

# an element's first gradient under this share of the median leaf's root
# mean square element is rounding alone
ROUNDING = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> List[float]:
    """Each leaf's gap of norms, over the larger of its reference norm and the median leaf's."""
    floor = statistics.median(ref.values())
    return [abs(prog[n] - ref[n]) / max(ref[n], floor) for n in ref]


def kept_elements(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf's elements whose gradient is at least ``ROUNDING`` of the
    median leaf's root mean square element (bool, on the host)."""
    rms = {n: float(torch.linalg.vector_norm(g.double())) / g.numel() ** 0.5 for n, g in grads.items()}
    floor = ROUNDING * statistics.median(rms.values())
    return {n: (g.detach().abs() >= floor).cpu() for n, g in grads.items()}


def _change_norms(change: Dict[str, torch.Tensor], kept: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(change[n].detach().cpu().double()[k])) for n, k in kept.items()
            if bool(k.any())}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program's leaves are not the reference's")
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad = _leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    kept = kept_elements(ref["grads"])
    change = _leaf_gaps(_change_norms(prog["change"], kept), _change_norms(ref["change"], kept))
    return {"loss_first": losses[0], "loss_steps": max(losses), "grad_worst": max(grad),
            "change_worst": max(change)}


def train_detail(prog: Dict, ref: Dict) -> Dict:
    """Each step's two losses, the three leaves furthest apart in each norm,
    and the elements left out of the change."""
    kept = kept_elements(ref["grads"])
    norms = {"grad_norms": (prog["grad_norms"], ref["grad_norms"]),
             "change": (_change_norms(prog["change"], kept), _change_norms(ref["change"], kept))}

    def worst(key):
        p, r = norms[key]
        fl = statistics.median(r.values())
        gaps = {n: abs(p[n] - r[n]) / max(r[n], fl) for n in r}
        return [(n, p[n], r[n]) for n in sorted(gaps, key=gaps.get, reverse=True)[:3]]

    return {"losses": list(zip(prog["losses"], ref["losses"])), "grad": worst("grad_norms"),
            "change": worst("change"), "change elements left out": sum(int((~k).sum()) for k in kept.values()),
            "relu inputs near 0, sides taken": ref.get("kinks")}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a NaN is not)."""
    return all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
