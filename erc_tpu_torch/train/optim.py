"""Optimizers from the config, declared LR schedules, and optax's clip.

Port of ``erc_tpu.train.optim.build_optim`` on torch's optimizers and one of
the port's own, whose updates are optax's:

- ``adam``: ``torch.optim.Adam(weight_decay=wd)`` folds the L2 term into the
  gradient before the moments, as ``add_decayed_weights`` → ``scale_by_adam``;
- ``adamw``: decoupled decay.  ``torch.optim.AdamW`` defaults to
  ``weight_decay=0.01``; the config's value (0.0 for DAG-ERC) is always passed;
- ``sgd``: ``Sgd``, ``optax.sgd(lr, momentum or None, nesterov)`` (no decay);
- ``lars``: ``Lars``, ``optax.lars(lr, weight_decay=wd)`` with its defaults.

``--optim.split_wd=1`` decays every parameter but those under a name with
``bn`` in it (``wd_mask_bn``), ``--optim.split_wd=full`` only the parameters
of two or more dimensions that are not a bias or a scale and not under a
batch or layer norm (``wd_mask``): adam and adamw then take two parameter
groups, decayed and not, each with its own LR tensor of the same value
(torch's plateau controller reduces each group's LR once, where a tensor
shared by both would be reduced twice).  The rules read the port's
parameter names, and ``tests/test_torch_schedules.py`` holds them for every
family against the JAX package's masks seen through ``convert.py``.  sgd
and lars take no mask, as in the JAX package.

On the card (``device`` a CUDA device) every optimizer is built
capturable, with the LR a 0-d float32 tensor on the card, so that the train
step can be captured in a CUDA graph and the plateau controller still
changes the LR the graph reads (it writes the tensor in place): the
counterpart of optax's ``inject_hyperparams``.  ``Sgd`` is the port's own,
as ``Lars`` is: torch's SGD scales by the LR as a Python number
(``alpha=-lr``), which a captured graph keeps as it was at capture.  The CPU
keeps a float LR: torch allows ``capturable`` only on the card.

A declared schedule (``--optim.sche.name=Cos --optim.sche.left=0 ...``,
``core.interp``) is the LR: update n (from 0) runs at ``sche(n)``, as
``inject_hyperparams`` evaluates the schedule at its count.  The count is a
tensor in the optimizer's state (``optimizer.state["schedule"]["count"]``,
saved and restored with it), and a hook before every ``optimizer.step()``
writes ``sche(count)`` into each group's LR and advances the count, on the
device: inside a captured step too, and so between the inner steps of a
K-step replay.

``clip_by_global_norm_`` is ``optax.clip_by_global_norm``: the gradients
scale by ``max_norm / norm`` only when ``norm >= max_norm``, with no
``+ 1e-6`` in the denominator as ``torch.nn.utils.clip_grad_norm_`` has.
The plateau controller is ``torch.optim.lr_scheduler.ReduceLROnPlateau``,
whose semantics the JAX package's class copies.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch

from erc_tpu_torch.core import interp
from erc_tpu_torch.core.params import Params

Named = Iterable[Union[torch.nn.Parameter, Tuple[str, torch.nn.Parameter]]]


def wd_mask_bn(name: str, param: torch.Tensor) -> bool:
    """``--optim.split_wd=1``: decayed unless a part of the name holds ``bn``."""
    return not any("bn" in part.lower() for part in name.split("."))


def wd_mask(name: str, param: torch.Tensor) -> bool:
    """``--optim.split_wd=full``: decayed where the parameter has two or more
    dimensions, is not a bias or a scale, and is not under a norm."""
    *modules, last = name.split(".")
    if last in ("bias", "scale") or last.startswith("b_"):
        return False
    if any("bn" in m.lower() or "norm" in m.lower() for m in modules):
        return False
    return param.ndim >= 2


def split_mask(split):
    """The decay rule of a ``split_wd`` value, or None where it is off."""
    if not split:
        return None
    return wd_mask if str(split).lower() == "full" else wd_mask_bn


class Lars(torch.optim.Optimizer):
    """``optax.lars(lr, weight_decay=wd)`` with optax's defaults, per tensor:
    ``u = g + wd·p``; ``u ·= 1e-3·‖p‖ / ‖u‖`` (1 where either norm is 0); ``u
    ·= −lr``; ``trace = u + 0.9·trace``; ``p += trace`` (not Nesterov).
    Capturable where ``lr`` is a tensor on the card: nothing reads a value
    back on the host."""

    def __init__(self, params, lr=1e-3, weight_decay: float = 0.0, trust_coefficient: float = 1e-3,
                 eps: float = 0.0, momentum: float = 0.9, capturable: bool = False):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, trust_coefficient=trust_coefficient,
                                      eps=eps, momentum=momentum, capturable=capturable))

    @torch.no_grad()
    def step(self, closure=None):
        for g in self.param_groups:
            params = [p for p in g["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if "trace" not in self.state[p]:
                    self.state[p]["trace"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            grads = [p.grad for p in params]
            traces = [self.state[p]["trace"] for p in params]
            u = torch._foreach_add(grads, params, alpha=g["weight_decay"]) if g["weight_decay"] else \
                torch._foreach_mul(grads, 1.0)
            pn = torch.stack(torch._foreach_norm(params))
            un = torch.stack(torch._foreach_norm(u))
            axis = getattr(self, "model_axis", None)  # parallel.mesh.ModelAxis: a block's norm is its parameter's
            if axis is not None:
                pn, un = axis.full_norms(params, torch.stack([pn, un])).unbind()
            ratio = torch.where((pn == 0) | (un == 0), 1.0, g["trust_coefficient"] * pn / (un + g["eps"]))
            torch._foreach_mul_(u, list(ratio.unbind()))
            torch._foreach_mul_(u, -g["lr"])
            torch._foreach_mul_(traces, g["momentum"])
            torch._foreach_add_(traces, u)
            torch._foreach_add_(params, traces)


class Sgd(torch.optim.Optimizer):
    """``optax.sgd(lr, momentum or None, nesterov)``, per tensor: with a
    momentum m > 0, ``trace = g + m·trace``, then ``u = g + m·trace`` where
    ``nesterov`` else ``trace``; with none, ``u = g`` (``nesterov`` then has no
    effect, as in optax); ``p -= lr·u``.  No weight decay.  Capturable where
    ``lr`` is a tensor on the card: nothing reads a value back on the host."""

    def __init__(self, params, lr=1e-3, momentum: float = 0.0, nesterov: bool = False, capturable: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov, capturable=capturable))

    @torch.no_grad()
    def step(self, closure=None):
        for g in self.param_groups:
            params = [p for p in g["params"] if p.grad is not None]
            if not params:
                continue
            u = [p.grad for p in params]
            if g["momentum"]:
                for p in params:
                    if "trace" not in self.state[p]:
                        self.state[p]["trace"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                traces = [self.state[p]["trace"] for p in params]
                torch._foreach_mul_(traces, g["momentum"])
                torch._foreach_add_(traces, u)
                u = torch._foreach_add(u, traces, alpha=g["momentum"]) if g["nesterov"] else traces
            torch._foreach_add_(params, torch._foreach_mul(u, -g["lr"]))


class _ScheduleHook:
    """The step pre-hook of a declared schedule: each group's LR := sche(count), then count += 1."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, optimizer, args, kwargs) -> None:
        count = optimizer.state["schedule"]["count"]
        lr = self.fn(count)
        for g in optimizer.param_groups:
            if isinstance(g["lr"], torch.Tensor):
                g["lr"].copy_(lr)
            else:
                g["lr"] = float(lr)
        count.add_(1)


def build_schedule(cfg: Optional[Params]):
    """``sche`` config → a function of a step-count tensor (``core.interp.to_schedule``), or None."""
    if cfg is None or not cfg.get("name"):
        return None
    return interp.to_schedule(interp.build_curve(cfg))


def lr_tensor(lr: float, device) -> torch.Tensor:
    """A capturable optimizer's LR: a 0-d float32 tensor on ``device``."""
    return torch.tensor(lr, device=device)


def build_optim(cfg: Params, params: Named, device: Optional[torch.device] = None) -> torch.optim.Optimizer:
    """The optimizer of ``cfg`` over ``params`` (the model's
    ``named_parameters()``; bare tensors where ``split_wd`` is off),
    capturable where ``device`` is a CUDA device."""
    name = str(cfg.get("name", "Adam")).lower()
    lr = float(cfg.get("lr", 1e-3))
    wd = float(cfg.get("weight_decay", 0.0))
    betas = (float(cfg.get("beta1", 0.9)), float(cfg.get("beta2", 0.999)))
    eps = float(cfg.get("eps", 1e-8))
    named = [p if isinstance(p, tuple) else (None, p) for p in params]
    tensors = [p for _, p in named]
    dev = tensors[0].device if tensors else torch.device("cpu")
    capturable = device is not None and torch.device(device).type == "cuda"
    sche = build_schedule(cfg.get("sche"))
    if sche is not None:
        lr = float(sche(torch.zeros((), dtype=torch.int64)))  # optax's init evaluates the schedule at count 0

    def lr_value():
        return lr_tensor(lr, device) if capturable else lr

    if name in ("adam", "adamw"):
        cls = torch.optim.Adam if name == "adam" else torch.optim.AdamW
        mask = split_mask(cfg.get("split_wd"))
        if mask is None:
            groups = [{"params": tensors, "weight_decay": wd}]
        else:
            if any(n is None for n, _ in named):
                raise ValueError("optim.split_wd needs the parameters' names: pass model.named_parameters()")
            decayed = [mask(n, p) for n, p in named]
            groups = [{"params": [p for (_, p), d in zip(named, decayed) if d], "weight_decay": wd},
                      {"params": [p for (_, p), d in zip(named, decayed) if not d], "weight_decay": 0.0}]
            groups = [g for g in groups if g["params"]]
        for g in groups:
            g["lr"] = lr_value()
        opt = cls(groups, lr=lr, betas=betas, eps=eps, **({"capturable": True} if capturable else {}))
    elif name == "lars":
        opt = Lars(tensors, lr=lr_value(), weight_decay=wd, capturable=capturable)
    elif name == "sgd":
        opt = Sgd(tensors, lr=lr_value(), momentum=float(cfg.get("momentum", 0.0) or 0.0),
                  nesterov=bool(cfg.get("nesterov", False)), capturable=capturable)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if sche is not None:
        opt.state["schedule"] = {"count": torch.zeros((), dtype=torch.int64, device=dev)}
        opt.register_step_pre_hook(_ScheduleHook(sche))
    return opt


def has_schedule(optimizer: torch.optim.Optimizer) -> bool:
    return "schedule" in optimizer.state


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    """``optimizer.load_state_dict(state)``, keeping what the optimizer was
    built with for its device, whichever device saved ``state``: a capturable
    one keeps its LR a 0-d float32 tensor on the parameters' device and its
    step counts there, a CPU one a float LR.  A declared schedule's count
    comes back on the parameters' device; a state saved without one gives
    the count of Adam's steps (0 for the others)."""
    capturable = [bool(g.get("capturable")) for g in optimizer.param_groups]
    scheduled = has_schedule(optimizer)
    optimizer.load_state_dict(state)
    for g, cap in zip(optimizer.param_groups, capturable):
        dev = g["params"][0].device if g["params"] else torch.device("cpu")
        lr = float(g["lr"])
        g["lr"] = torch.tensor(lr, device=dev) if cap else lr
        if "capturable" in g:
            g["capturable"] = cap
        for p in g["params"] if cap else ():
            st = optimizer.state.get(p, {})
            if isinstance(st.get("step"), torch.Tensor):
                st["step"] = st["step"].to(device=dev, dtype=torch.float32)
    if scheduled:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        dev = params[0].device if params else torch.device("cpu")
        saved = optimizer.state.get("schedule")
        if saved is None:
            steps = [float(optimizer.state[p]["step"]) for p in params if "step" in optimizer.state.get(p, {})]
            count = torch.tensor(int(max(steps, default=0)))
        else:
            count = saved["count"]
        optimizer.state["schedule"] = {"count": count.to(device=dev, dtype=torch.int64)}


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
