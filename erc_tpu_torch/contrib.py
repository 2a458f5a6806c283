"""Training-technique extras (reference: lumo/contrib + contrib/tensor.py).

Port of ``erc_tpu.contrib``:

- EMA parameter averaging (lumo/contrib/module/ema.py:20; the MMIN trainers
  keep their own shadow, ``models/mmin_base.py``)
- mixup / cutmix / label sharpening / label guessing (contrib/tensor.py —
  the semi-supervised toolkit of the legacy image tracks)
- loss zoo (lumo/contrib/nest/trainer/losses.py:12-184): CE, MSE, min-ENT,
  KL, SimCLR-style contrastive
- ``MemoryBank``, a FIFO feature bank threaded as an explicit
  ``(bank, ptr)`` pair
- host helpers: raw-audio augmentation, dataset mean/std and the split
  helpers, with the JAX package's explicit numpy RNG.

The tensor functions run on the device of the tensors they are given.  The
random ones split a draw from an apply: ``mixup_draw`` / ``cutmix_draw`` take
their numbers from an explicit ``torch.Generator`` (on the tensors' device),
and ``mixup_apply`` / ``cutmix_apply`` compute from given numbers, so the
apply can be fed the JAX package's own draws.  ``mixup`` and ``cutmix`` are
the two together.  Beta variates come from two gamma variates
(Marsaglia–Tsang, boosted below shape 1), drawn from the generator.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def _tensors(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


@torch.no_grad()
def ema_update(ema_params: Union[torch.nn.Module, Dict[str, torch.Tensor], Iterable[torch.Tensor]],
               params, alpha: float = 0.999):
    """shadow ← α·shadow + (1-α)·params (ema.py:20-…), in place on the
    shadow's tensors (a module's parameters, a dict's values by key, or a
    sequence); returns the shadow."""
    e, p = _tensors(ema_params), _tensors(params)
    if len(e) != len(p):
        raise ValueError(f"the shadow holds {len(e)} tensors, the parameters {len(p)}")
    torch._foreach_mul_(e, alpha)
    torch._foreach_add_(e, [t.detach() for t in p], alpha=1 - alpha)
    return ema_params


# -- semi-supervised tensor ops (contrib/tensor.py) -------------------------


def onehot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """float32 one-hot rows; a label outside [0, n_classes) gives a row of
    zeros, as ``jax.nn.one_hot`` does."""
    return (labels[..., None] == torch.arange(n_classes, device=labels.device)).float()


def sharpen(probs: torch.Tensor, T: float = 0.5) -> torch.Tensor:
    """Temperature sharpening of a prob distribution."""
    p = probs ** (1.0 / T)
    return p / p.sum(-1, keepdim=True)


def label_guess(*prob_list):
    """Average predictions across augmentations (label guessing)."""
    return sum(prob_list) / len(prob_list)


def _gamma(shape: float, generator: Optional[torch.Generator], device, tries: int = 64) -> torch.Tensor:
    """One Gamma(shape, 1) variate, float32, 0-d on ``device``: Marsaglia–Tsang
    with ``tries`` candidates drawn at once (the first accepted one; each is
    accepted with probability > 0.95), boosted by U^(1/shape) below shape 1."""
    a = shape + 1.0 if shape < 1.0 else shape
    d = a - 1.0 / 3.0
    c = 1.0 / np.sqrt(9.0 * d)
    x = torch.randn(tries, generator=generator, device=device, dtype=torch.float64)
    u = torch.rand(tries, generator=generator, device=device, dtype=torch.float64)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp_min(1e-300)))
    g = d * v[torch.argmax(ok.int())]
    if shape < 1.0:
        g = g * torch.rand((), generator=generator, device=device, dtype=torch.float64) ** (1.0 / shape)
    return g.float()


def beta_draw(a: float, b: float, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """One Beta(a, b) variate, float32, 0-d on ``device``."""
    ga, gb = _gamma(a, generator, device), _gamma(b, generator, device)
    return ga / (ga + gb)


def mixup_draw(n: int, beta: float = 0.75, generator: Optional[torch.Generator] = None, device=None):
    """``mixup``'s numbers: a permutation of ``n`` rows and λ ~ Beta(β, β)
    (before ``mixup_apply`` takes max(λ, 1 − λ))."""
    perm = torch.randperm(n, generator=generator, device=device)
    return perm, beta_draw(beta, beta, generator, device)


def mixup_apply(x1, y1, perm, lam, x2=None, y2=None):
    """Beta-interpolated pairs from given numbers; single-batch mixup (the
    pairs are rows ``perm`` of the batch) when ``x2`` is None.  Returns
    (xm, ym, λ) with λ := max(λ, 1 − λ)."""
    if x2 is None:
        x2, y2 = x1[perm], y1[perm]
    lam = torch.as_tensor(lam, dtype=torch.float32, device=x1.device)
    lam = torch.maximum(lam, 1 - lam)
    return lam * x1 + (1 - lam) * x2, lam * y1 + (1 - lam) * y2, lam


def mixup(x1, y1, x2=None, y2=None, beta: float = 0.75, generator: Optional[torch.Generator] = None):
    """``mixup_apply`` of ``mixup_draw``'s numbers, drawn from ``generator``."""
    perm, lam = mixup_draw(x1.shape[0], beta, generator, x1.device)
    return mixup_apply(x1, y1, perm, lam, x2, y2)


def cutmix_draw(B: int, H: int, W: int, beta: float = 1.0, generator: Optional[torch.Generator] = None,
                device=None):
    """``cutmix``'s numbers: a permutation of ``B`` rows, λ ~ Beta(β, β) and the
    box centre cy ~ U[0, H), cx ~ U[0, W)."""
    perm = torch.randperm(B, generator=generator, device=device)
    lam = beta_draw(beta, beta, generator, device)
    cy = torch.rand((), generator=generator, device=device) * H
    cx = torch.rand((), generator=generator, device=device) * W
    return perm, lam, cy, cx


def cutmix_apply(x, y, perm, lam, cy, cx):
    """CutMix of [B, H, W, C] images from given numbers: the box of side
    √(1 − λ)·(H, W) about (cy, cx), clipped to the image and half-open, takes
    the permuted batch's pixels; labels mix by the realized (pixel) box area.
    Returns (xm, ym, 1 − area)."""
    H, W = x.shape[1], x.shape[2]
    f32 = dict(dtype=torch.float32, device=x.device)
    lam, cy, cx = (torch.as_tensor(v, **f32) for v in (lam, cy, cx))
    rh = torch.sqrt(1.0 - lam) * H
    rw = torch.sqrt(1.0 - lam) * W
    y0, y1 = torch.clamp(cy - rh / 2, 0, H), torch.clamp(cy + rh / 2, 0, H)
    x0, x1 = torch.clamp(cx - rw / 2, 0, W), torch.clamp(cx + rw / 2, 0, W)
    yy = torch.arange(H, **f32)[:, None]
    xx = torch.arange(W, **f32)[None, :]
    box = ((yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1))[None, :, :, None]
    xm = torch.where(box, x[perm], x)
    area = box.float().mean()
    ym = (1.0 - area) * y + area * y[perm]
    return xm, ym, 1.0 - area


def cutmix(x, y, beta: float = 1.0, generator: Optional[torch.Generator] = None):
    """``cutmix_apply`` of ``cutmix_draw``'s numbers, drawn from ``generator``."""
    return cutmix_apply(x, y, *cutmix_draw(x.shape[0], x.shape[1], x.shape[2], beta, generator, x.device))


# -- loss zoo (nest/trainer/losses.py) --------------------------------------


def _masked_mean(per: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return per.mean()
    return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def ce_loss(logits, labels, mask=None):
    """Cross-entropy; soft targets where ``labels`` has the logits' rank."""
    logp = F.log_softmax(logits, -1)
    if labels.ndim == logits.ndim:
        nll = -(labels * logp).sum(-1)
    else:
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return _masked_mean(nll, mask)


def mse_loss(a, b, mask=None):
    return _masked_mean(((a - b) ** 2).mean(-1), mask)


def minent_loss(logits, mask=None):
    """Entropy minimization of predictions."""
    ent = -(F.softmax(logits, -1) * F.log_softmax(logits, -1)).sum(-1)
    return _masked_mean(ent, mask)


def kl_loss(logits_p, logits_q, mask=None):
    """KL(p ‖ q) between two predicted distributions."""
    p = F.softmax(logits_p, -1)
    kl = (p * (F.log_softmax(logits_p, -1) - F.log_softmax(logits_q, -1))).sum(-1)
    return _masked_mean(kl, mask)


def contrastive_loss(za, zb, temperature: float = 0.1):
    """SimCLR NT-Xent over two views [N, D] (losses.py contrastive mixin); the
    diagonal is masked by a finite −1e9·I."""
    za = za / torch.linalg.vector_norm(za, dim=-1, keepdim=True)
    zb = zb / torch.linalg.vector_norm(zb, dim=-1, keepdim=True)
    n = za.shape[0]
    z = torch.cat([za, zb], 0)
    sim = z @ z.T / temperature
    sim = sim - 1e9 * torch.eye(2 * n, dtype=sim.dtype, device=sim.device)
    ar = torch.arange(n, device=z.device)
    return ce_loss(sim, torch.cat([ar + n, ar]))


class MemoryBank:
    """Fixed-size FIFO feature bank (models/module_utils.py MemoryBank),
    functional: (bank, ptr) threaded explicitly; a push wraps modulo the
    bank's size."""

    @staticmethod
    def init(size: int, dim: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.zeros(size, dim, device=device), torch.zeros((), dtype=torch.int32, device=device)

    @staticmethod
    def push(bank, ptr, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        n, size = feats.shape[0], bank.shape[0]
        idx = (ptr.long() + torch.arange(n, device=bank.device)) % size
        out = bank.clone()
        out[idx] = feats.to(bank.dtype)
        return out, ((ptr + n) % size).to(torch.int32)


# --------------------------------------------------------------------------
# legacy raw-audio augmentation helpers (reference:
# augmentations/audio_strategies.py:24-66 — the deprecated raw-audio track).
# Host-side pipeline ops (they run in the data loader on variable-length
# clips, before padding/batching), with EXPLICIT rng: a np.random.Generator
# is threaded instead of the reference's global random/np.random state.


def audio_random_crop(max_size: int):
    """Crop a random window of ``max_size`` samples (audio_strategies.py:24)."""

    def inner(x: np.ndarray, rng: np.random.Generator):
        size = len(x)
        if size <= max_size:
            return x
        left = int(rng.integers(0, size - max_size))
        return x[left: left + max_size]

    return inner


def audio_center_crop(max_size: int):
    """Crop the centered window of ``max_size`` samples (audio_strategies.py:45)."""

    def inner(x: np.ndarray, rng: np.random.Generator = None):
        size = len(x)
        if size <= max_size:
            return x
        left = (size - max_size) // 2
        return x[left: left + max_size]

    return inner


def audio_gauss_noise(ratio: float = 20.0, p: float = 0.5):
    """Add zero-mean gaussian noise with std = |x|max·ratio/100, with
    probability ``p`` (audio_strategies.py:35; |x|max where the reference
    takes the signed max, which would hand a negative std to the sampler on
    an all-negative clip)."""

    def inner(x: np.ndarray, rng: np.random.Generator):
        if rng.random() < p:
            std = float(np.abs(x).max()) * ratio / 100.0
            x = x + rng.normal(0.0, std, x.shape)
        return x

    return inner


class AudioCompose:
    """Sequential host-side audio pipeline (audio_strategies.py:55-66);
    falsy entries are skipped.  Each op takes (x, rng)."""

    def __init__(self, *ops):
        self.ops = list(ops)

    def append(self, op):
        self.ops.append(op)

    def __call__(self, x: np.ndarray, rng: np.random.Generator = None):
        rng = rng if rng is not None else np.random.default_rng(0)
        for op in self.ops:
            if op:
                x = op(x, rng)
        return x


def dataset_mean_std(images):
    """Per-channel mean/std of a dataset of HWC uint8-range images, /255
    scaled (reference: lumo/sketch/preprocess_mean_std.py:9-46 — two-pass:
    mean = average of per-image channel means, std = sqrt of the pixel-
    weighted squared deviation from that mean).  ``images`` is a re-
    iterable sequence of arrays (or (img, label) pairs)."""

    def _img(x):
        return np.asarray(x[0] if isinstance(x, (tuple, list)) else x, dtype=np.float64)

    n_imgs = 0
    mean = None
    for item in images:
        img = _img(item)
        n_imgs += 1
        m = img.reshape(-1, img.shape[-1]).mean(axis=0)
        mean = m if mean is None else mean + m
    if not n_imgs:
        raise ValueError("empty dataset")
    mean = mean / n_imgs

    sq = np.zeros_like(mean)
    n_pix = 0
    for item in images:
        flat = _img(item).reshape(-1, mean.shape[0])
        sq += ((flat - mean) ** 2).sum(axis=0)
        n_pix += flat.shape[0]
    std = np.sqrt(sq / n_pix)
    return tuple(mean / 255.0), tuple(std / 255.0)


# -- dataset split helpers (lumo/contrib/data/splits.py) ---------------------
#
# Host-side index arithmetic for the legacy semi-supervised tracks; ``rng``
# is explicit, and ``np.random`` itself (the global stream, the reference's)
# where none is given.


def sequence_split(lengths):
    """Contiguous index ranges of the given lengths (splits.py:8-19)."""
    out, offset = [], 0
    for n in lengths:
        out.append(list(range(offset, offset + n)))
        offset += n
    return out


def ratio2length(total_len: int, *ratios):
    """Ratios → integer lengths, truncating (splits.py:74-85)."""
    return [int(total_len * r) for r in ratios]


def semi_split(labels, n_percls: int, val_size: int = 10000, include_sup: bool = True, repeat_sup: bool = True,
               shuffle: bool = True, rng=None):
    """Class-balanced semi-supervised split (splits.py:22-53): per class the
    first ``n_percls`` shuffled indices are labeled, the first (or, with
    ``include_sup=False``, the next) ``(N - val_size) // n_cls`` unlabeled, the
    rest validation; ``repeat_sup`` tiles the labeled set to the unlabeled
    length.  Returns (labeled_idx, unlabeled_idx, val_idx)."""
    rng = np.random if rng is None else rng
    labels = np.asarray(labels)
    n_cls = len({int(i) for i in labels})
    n_per_un = (len(labels) - val_size) // n_cls

    sup, unsup, val = [], [], []
    for c in range(n_cls):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        sup.extend(idx[:n_percls])
        unsup.extend(idx[0 if include_sup else n_percls:n_per_un])
        val.extend(idx[n_per_un:])

    sup = np.asarray(sup)
    if repeat_sup and len(sup):
        reps = len(unsup) // len(sup) + 1
        sup = np.hstack([sup] * reps)[: len(unsup)]
    unsup, val = np.asarray(unsup), np.asarray(val)
    if shuffle:
        rng.shuffle(sup)
        rng.shuffle(unsup)
    return sup, unsup, val


def train_val_split(target, val_size: int = 10000, train_size=None, rng=None):
    """Shuffled (train_idx, val_idx) split (splits.py:56-71): the first
    ``val_size`` shuffled indices are validation, the rest (optionally capped
    at ``train_size``) training."""
    rng = np.random if rng is None else rng
    idx = np.arange(len(target))
    rng.shuffle(idx)
    if train_size is not None:
        if len(idx) <= val_size + train_size:
            raise ValueError(f"need > {val_size + train_size} samples, have {len(idx)}")
        return idx[val_size: val_size + train_size], idx[:val_size]
    return idx[val_size:], idx[:val_size]


def create_imbalanced_data(labels, imb_type: str = "exp", imb_factor: float = 0.02, rng=None):
    """Long-tailed subsample indices (splits.py:88-121, BBN recipe): per-class
    keep counts decay exponentially ('exp'), step to ``img_max·imb_factor``
    for the back half ('step'), or stay flat."""
    rng = np.random if rng is None else rng
    labels = np.asarray(labels)
    n_cls = len(set(labels.tolist()))
    img_max = len(labels) // n_cls
    if imb_type == "exp":
        keep = [int(img_max * imb_factor ** (c / (n_cls - 1.0))) for c in range(n_cls)]
    elif imb_type == "step":
        half = n_cls // 2
        keep = [img_max] * half + [int(img_max * imb_factor)] * (n_cls - half)
    else:
        keep = [img_max] * n_cls

    out = []
    for c, num in enumerate(keep):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        out.extend(idx[:num])
    return out
