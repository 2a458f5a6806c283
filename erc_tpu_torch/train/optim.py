"""Optimizers from the config, and optax's gradient clipping.

Port of ``erc_tpu.train.optim.build_optim`` for ``adam``, ``adamw`` and
``sgd``, on torch's optimizers, whose updates are optax's:

- ``adam``: ``torch.optim.Adam(weight_decay=wd)`` folds the L2 term into the
  gradient before the moments, as ``add_decayed_weights`` → ``scale_by_adam``;
- ``adamw``: decoupled decay.  ``torch.optim.AdamW`` defaults to
  ``weight_decay=0.01``; the config's value (0.0 for DAG-ERC) is always passed;
- ``sgd``: optional momentum and Nesterov.

On the card (``device`` a CUDA device) ``adam`` and ``adamw`` are built with
``capturable=True`` and the LR as a 0-d float32 tensor on the card, so that
the train step can be captured in a CUDA graph and the plateau controller
still changes the LR the graph reads (it writes the tensor in place): the
counterpart of optax's ``inject_hyperparams``.  ``sgd`` reads its LR on the
host and cannot be captured: on the card, a trainer built with it raises
``NotImplementedError`` at its first step unless the caller sets
``train_graphs = False`` first, and then steps eagerly.  The CPU keeps a
float LR: torch allows
``capturable`` only on the card.

``clip_by_global_norm_`` is ``optax.clip_by_global_norm``: the gradients
scale by ``max_norm / norm`` only when ``norm >= max_norm``, with no
``+ 1e-6`` in the denominator as ``torch.nn.utils.clip_grad_norm_`` has.
The plateau controller is ``torch.optim.lr_scheduler.ReduceLROnPlateau``,
whose semantics the JAX package's class copies.  Declared LR schedules
(``--optim.sche``), ``split_wd`` and ``lars`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch

from erc_tpu_torch.core.params import Params


def build_optim(cfg: Params, params: Iterable[torch.nn.Parameter],
                device: Optional[torch.device] = None) -> torch.optim.Optimizer:
    """The optimizer of ``cfg`` over ``params``, capturable where ``device``
    is a CUDA device."""
    name = str(cfg.get("name", "Adam")).lower()
    lr = float(cfg.get("lr", 1e-3))
    wd = float(cfg.get("weight_decay", 0.0))
    betas = (float(cfg.get("beta1", 0.9)), float(cfg.get("beta2", 0.999)))
    eps = float(cfg.get("eps", 1e-8))
    if cfg.get("split_wd") or (cfg.get("sche") and cfg.get("sche").get("name")):
        raise NotImplementedError("optim.split_wd and optim.sche are not ported yet")
    if name in ("adam", "adamw"):
        cls = torch.optim.Adam if name == "adam" else torch.optim.AdamW
        if device is not None and torch.device(device).type == "cuda":
            return cls(params, lr=torch.tensor(lr, device=device), betas=betas, eps=eps, weight_decay=wd,
                       capturable=True)
        return cls(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(cfg.get("momentum", 0.0) or 0.0),
                               nesterov=bool(cfg.get("nesterov", False)))
    raise ValueError(f"unknown optimizer {name!r}")


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    """``optimizer.load_state_dict(state)``, keeping what the optimizer was
    built with for its device, whichever device saved ``state``: a capturable
    one keeps its LR a 0-d float32 tensor on the parameters' device and its
    step counts there, a CPU one a float LR."""
    capturable = [bool(g.get("capturable")) for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for g, cap in zip(optimizer.param_groups, capturable):
        dev = g["params"][0].device
        lr = float(g["lr"])
        g["lr"] = torch.tensor(lr, device=dev) if cap else lr
        if "capturable" in g:
            g["capturable"] = cap
        for p in g["params"] if cap else ():
            st = optimizer.state.get(p, {})
            if isinstance(st.get("step"), torch.Tensor):
                st["step"] = st["step"].to(device=dev, dtype=torch.float32)


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
