"""Optimizers from the config, and optax's gradient clipping.

Port of ``erc_tpu.train.optim.build_optim`` for ``adam``, ``adamw`` and
``sgd``, on torch's optimizers, whose updates are optax's:

- ``adam``: ``torch.optim.Adam(weight_decay=wd)`` folds the L2 term into the
  gradient before the moments, as ``add_decayed_weights`` → ``scale_by_adam``;
- ``adamw``: decoupled decay.  ``torch.optim.AdamW`` defaults to
  ``weight_decay=0.01``; the config's value (0.0 for DAG-ERC) is always passed;
- ``sgd``: optional momentum and Nesterov.

``clip_by_global_norm_`` is ``optax.clip_by_global_norm``: the gradients
scale by ``max_norm / norm`` only when ``norm >= max_norm``, with no
``+ 1e-6`` in the denominator as ``torch.nn.utils.clip_grad_norm_`` has.
The plateau controller is ``torch.optim.lr_scheduler.ReduceLROnPlateau``,
whose semantics the JAX package's class copies.  Declared LR schedules
(``--optim.sche``), ``split_wd`` and ``lars`` are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

from erc_tpu_torch.core.params import Params


def build_optim(cfg: Params, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    name = str(cfg.get("name", "Adam")).lower()
    lr = float(cfg.get("lr", 1e-3))
    wd = float(cfg.get("weight_decay", 0.0))
    betas = (float(cfg.get("beta1", 0.9)), float(cfg.get("beta2", 0.999)))
    eps = float(cfg.get("eps", 1e-8))
    if cfg.get("split_wd") or (cfg.get("sche") and cfg.get("sche").get("name")):
        raise NotImplementedError("optim.split_wd and optim.sche are not ported yet")
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(cfg.get("momentum", 0.0) or 0.0),
                               nesterov=bool(cfg.get("nesterov", False)))
    raise ValueError(f"unknown optimizer {name!r}")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(tensors: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Clip in place as optax does: t unchanged when norm < max_norm, else
    (t / norm) · max_norm.  Returns the norm before the clip.  No value
    leaves the device."""
    norm = global_norm(tensors)
    under = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(tensors, torch.where(under, one, norm))
    torch._foreach_mul_(tensors, torch.where(under, one, one * max_norm))
    return norm
