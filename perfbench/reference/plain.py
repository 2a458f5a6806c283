"""What the plain references share: plain PyTorch in float32, importing
nothing of the program.

- ``batch``: dialogues padded to the batch's longest, as the reference
  takes them (its own padding, not the program's buckets);
- ``linear`` / ``mm``: every product of a reference goes through ``mm``, so
  that a control can round the operands (``tf32_mm``, the CPU's stand-in for
  the card's TF32, whose products keep 10 bits of mantissa);
- ``gru_cell``: torch's GRU cell (gates r, z, n);
- ``masked_cross_entropy``: the mean over real utterances;
- ``train_readings``: a reference's first steps with optax's clip and
  torch's Adam/AdamW update written out, and what the comparison reads of them.

A ReLU's gradient jumps where its input crosses 0, and a float32 input
within rounding of 0 may land on either side in two sound computations:
the loss stays the same, but the gradients of every leaf upstream differ
by that one input's share (up to 2e-4 of a leaf's norm at DAG-ERC's
widths; the reference's own float32 against float64 does it as well).  So
the first step's gradient is judged against each side of such inputs:
``first_grads`` finds the ReLU inputs within ``KINK_BAND`` of 0 (over the
median |input| of their call, at real positions), works out what taking
the other side at each would add, and keeps the combination whose leaf
norms lie nearest the program's.  The steps after it start from that
gradient.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MODALITY_KEYS = {"a": "audio", "t": "text", "v": "visual"}
# a ReLU input within this share of its call's median |input| of 0 may round
# to either side: float32 puts an input up to 5e-6 of it off float64 (the
# reference's and the port's alike, DAG-ERC at its widths), so twice that on
# two sides, and room
KINK_BAND = 2e-5
MAX_KINKS = 12  # the nearest to 0 of them; 2**12 combinations
# the sides are searched only where the plain first step lies further than
# this from the program by the worst leaf (sound runs read 3e-8 to 9e-8)
KINK_GATE = 1e-6


@contextlib.contextmanager
def strict_float32():
    """Products in IEEE float32 on the card: TF32 off for cuBLAS and cuDNN
    within the block, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def tf32():
    """The card's TF32 products within the block (the control's precision)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mm`` on operands rounded to TF32, accumulated in float32; the
    backward's products see rounded cotangents too."""
    return torch.matmul(_RoundTF32.apply(a), _RoundTF32.apply(b))


def linear(x, w, b=None, mm: Callable = mm):
    y = mm(x, w.t())
    return y if b is None else y + b


def gru_cell(x, h, w_ih, w_hh, b_ih, b_hh, mm: Callable = mm):
    xr, xz, xn = linear(x, w_ih, b_ih, mm).chunk(3, -1)
    hr, hz, hn = linear(h, w_hh, b_hh, mm).chunk(3, -1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def batch(dialogues: Sequence[dict], modality: str, device) -> Dict[str, torch.Tensor]:
    """x [B, L, E] (features in ``modality``'s order), speakers [B, L],
    labels [B, L] (-1 past each length), mask [B, L], lengths [B]."""
    B, L = len(dialogues), max(len(d["label"]) for d in dialogues)
    E = sum(np.asarray(dialogues[0][MODALITY_KEYS[m]]).shape[-1] for m in modality)
    x = np.zeros((B, L, E), np.float32)
    spk = np.zeros((B, L), np.int64)
    lab = np.full((B, L), -1, np.int64)
    lens = np.zeros(B, np.int64)
    for i, d in enumerate(dialogues):
        n = len(d["label"])
        lens[i] = n
        x[i, :n] = np.concatenate([np.asarray(d[MODALITY_KEYS[m]], np.float32) for m in modality], -1)
        spk[i, :n] = np.asarray(d["speakers"]).argmax(-1)
        lab[i, :n] = np.asarray(d["label"])
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    mask = torch.arange(L)[None, :] < torch.from_numpy(lens)[:, None]
    return {"x": t(x), "speakers": t(spk), "labels": t(lab), "mask": mask.to(device), "lengths": t(lens)}


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return torch.where(mask, nll, torch.zeros_like(nll)).sum() / mask.sum()


def _leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def train_readings(forward: Callable, params0: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                   batches: List[Dict[str, torch.Tensor]], optim: Dict, mm: Callable = mm,
                   target: Optional[Dict[str, float]] = None) -> Dict:
    """Steps of ``forward(params, buffers, batch, training=True, mm=mm)`` on
    ``batches`` from ``params0``: each step's loss, the first step's gradient
    as the optimizer takes it (clipped by the global norm as optax does, with
    Adam's L2 term folded in) and each leaf's norm of it, and the
    parameters' change after the last step.  Adam's update is
    torch's: m/(1-b1^t) over sqrt(v)/sqrt(1-b2^t) + eps; AdamW decays first.
    With ``target`` (the program's first-gradient leaf norms), the first
    step's ReLU inputs near 0 take the sides nearest it (``first_grads``)."""
    params = {n: t.detach().clone() for n, t in params0.items()}
    m = {n: torch.zeros_like(t) for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    b1, b2 = optim["betas"]
    lr, eps, wd = float(optim["lr"]), float(optim["eps"]), float(optim["weight_decay"])
    decoupled = optim["name"].lower() == "adamw"
    losses, first_grad, kinks = [], None, (0, 0)
    for t, b in enumerate(batches, start=1):
        leaves = {n: p.requires_grad_(True) for n, p in params.items()}
        if t == 1 and target is not None:
            loss, grads, kinks = first_grads(forward, leaves, buffers, b, optim, mm, target)
        else:
            logits = forward(leaves, buffers, b, training=True, mm=mm)
            loss = masked_cross_entropy(logits, b["labels"], b["mask"])
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            params = {n: p.detach() for n, p in leaves.items()}
            if optim.get("clip"):
                norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
                if float(norm) >= float(optim["clip"]):
                    grads = {n: g / norm * float(optim["clip"]) for n, g in grads.items()}
            if wd and not decoupled:
                grads = {n: g + wd * params[n] for n, g in grads.items()}
            if first_grad is None:
                first_grad = grads
            new = {}
            for n, p in params.items():
                if wd and decoupled:
                    p = p * (1.0 - lr * wd)
                m[n] = b1 * m[n] + (1.0 - b1) * grads[n]
                v[n] = b2 * v[n] + (1.0 - b2) * grads[n] * grads[n]
                denom = (v[n].sqrt() / math.sqrt(1.0 - b2 ** t)) + eps
                new[n] = p - (lr / (1.0 - b1 ** t)) * m[n] / denom
            params = new
    return {"losses": losses, "grad_norms": _leaf_norms(first_grad), "grads": first_grad,
            "change": {n: params[n] - params0[n] for n in params}, "kinks": kinks}


class Relus:
    """``torch.relu`` that keeps each call's input and output."""

    def __init__(self):
        self.calls: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(x)
        self.calls.append((x, y))
        return y


def _near_kinks(relus: Relus, mask: torch.Tensor) -> List[Tuple[int, int]]:
    """(call, flat index) of the ReLU inputs within ``KINK_BAND`` of 0, the
    nearest first, at most ``MAX_KINKS``."""
    found = []
    for c, (x, _) in enumerate(relus.calls):
        ax = x.detach().abs()
        real = mask[..., None].expand_as(ax)
        rel = (ax / ax[real].median()).flatten()
        for i in torch.nonzero((rel < KINK_BAND) & real.flatten())[:, 0].tolist():
            found.append((float(rel[i]), c, i))
    return [(c, i) for _, c, i in sorted(found)[:MAX_KINKS]]


def first_grads(forward: Callable, leaves: Dict[str, torch.Tensor], buffers: Dict, b: Dict[str, torch.Tensor],
                optim: Dict, mm: Callable, target: Dict[str, float]):
    """The first step's loss and gradient, each ReLU input near 0 taken on
    the side that brings the leaf norms (clipped, with Adam's L2 term, as
    the optimizer takes them) nearest ``target`` by the worst leaf, where
    the plain gradient lies further than ``KINK_GATE`` from it; and (inputs
    near 0, sides changed)."""
    relus = Relus()
    logits = forward(leaves, buffers, b, training=True, mm=mm, relu=relus)
    loss = masked_cross_entropy(logits, b["labels"], b["mask"])
    names, ps = list(leaves), list(leaves.values())
    outs = torch.autograd.grad(loss, ps + [y for _, y in relus.calls], retain_graph=True)
    grads = dict(zip(names, outs[:len(ps)]))
    near = _near_kinks(relus, b["mask"])
    detached = {n: p.detach() for n, p in leaves.items()}
    none = {n: g.new_zeros((0, *g.shape)) for n, g in grads.items()}
    if not near or _nearest(grads, none, detached, optim, target)[1] <= KINK_GATE:
        return loss, grads, (len(near), 0)
    x = torch.stack([relus.calls[c][0].reshape(-1)[i] for c, i in near])
    # the other side adds (or, from the open side, takes away) the input's
    # cotangent times its gradient
    cot = torch.stack([outs[len(ps) + c].reshape(-1)[i] for c, i in near])
    coef = torch.where(x.detach() > 0, -cot, cot)
    jac = torch.autograd.grad(x, ps, grad_outputs=torch.eye(len(near), dtype=x.dtype, device=x.device),
                              is_grads_batched=True, allow_unused=True)
    deltas = {n: (coef.view(-1, *[1] * p.dim()) * j if j is not None else torch.zeros(len(near), *p.shape,
                                                                                        dtype=p.dtype, device=p.device))
              for n, p, j in zip(names, ps, jac)}
    pick = _nearest(grads, deltas, detached, optim, target)[0]
    if pick:
        grads = {n: g + deltas[n][list(pick)].sum(0) for n, g in grads.items()}
    return loss, grads, (len(near), len(pick))


def _nearest(grads, deltas, params, optim, target) -> Tuple[Tuple[int, ...], float]:
    """The combination of ``deltas`` whose leaf norms, as the optimizer
    takes them, lie nearest ``target`` by the worst leaf (``check``'s gap),
    and that gap."""
    names = list(grads)
    g = [grads[n].double().reshape(-1) for n in names]
    d = [deltas[n].double().reshape(len(deltas[n]), grads[n].numel()) for n in names]
    p = [params[n].double().reshape(-1) for n in names]
    gg = torch.stack([(x * x).sum() for x in g])  # [leaves]
    gd = torch.stack([dx @ x for x, dx in zip(g, d)], -1)  # [k, leaves]
    dd = torch.stack([dx @ dx.T for dx in d], -1)  # [k, k, leaves]
    gp = torch.stack([x @ px for x, px in zip(g, p)])
    dp = torch.stack([dx @ px for dx, px in zip(d, p)], -1)
    pp = torch.stack([(px * px).sum() for px in p])
    k = gd.shape[0]
    s = torch.tensor(list(itertools.product((0.0, 1.0), repeat=k)), dtype=torch.float64, device=gg.device)
    raw = gg + 2 * s @ gd + torch.einsum("su,uvl,sv->sl", s, dd, s)  # [2^k, leaves]: |g + sum d|^2
    clip = float(optim.get("clip") or 0.0)
    total = raw.sum(-1, keepdim=True).sqrt()
    f = torch.where(total >= clip, clip / total, torch.ones_like(total)) if clip else torch.ones_like(total)
    wd = float(optim["weight_decay"]) if optim["name"].lower() != "adamw" else 0.0
    norm = (f * f * raw + 2 * f * wd * (gp + s @ dp) + wd * wd * pp).clamp_min(0).sqrt()
    want = torch.tensor([target[n] for n in names], dtype=torch.float64, device=gg.device)
    floor = norm.median(-1, keepdim=True).values
    worst = ((norm - want).abs() / torch.maximum(norm, floor)).amax(-1)
    best = int(worst.argmin())
    return tuple(u for u in range(k) if s[best, u] > 0), float(worst[best])
