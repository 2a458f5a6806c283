"""RandAugment on uint8 image tensors (reference: augmentations/components/
randaugment.py — the FixMatch variant: uniformly-random magnitudes, a 14-op
pool, and a trailing Cutout).

Port of ``erc_tpu.augment_image``: the same op pool as plain tensor ops on
uint8 ``[H, W, 3]`` images or batches ``[B, H, W, 3]``, on the device of the
image tensor.  PIL semantics are matched per op as the JAX package matches
them: Pillow's truncating float→uint8 (``_to_u8``), the fixed-point gray
formula, blend formulas, histogram LUTs, the (x + 0.5, y + 0.5)-floor
nearest-neighbour affine convention and black fill.

Each op takes ``(img, v)``; on a batch ``v`` is one magnitude for every image
or one per image (a tensor ``[B]``), and per-image statistics (autocontrast's
range, contrast's mean, equalize's histograms) are taken per image.
``randaugment`` splits a draw from an apply: ``randaugment_draw`` takes its
numbers from an explicit ``torch.Generator`` (``n`` op indices uniform with
replacement, a uniform per op for its magnitude ``lo + (hi − lo)·u``, and the
cutout's ``v ~ U[0, 0.5)`` and centre), one set per image of a batch, which
is what ``jax.vmap`` of the JAX function gives; ``randaugment_apply`` computes
from given numbers, so it can be fed the JAX package's own draws.  A batch
computes every op on every image and keeps each image's choice (no host
synchronisation).

Serves the legacy CIFAR/image tracks; the ERC feature pipelines do not use
image augmentation.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def _batch(img: torch.Tensor):
    """(images as [B, H, W, 3], whether the input was one image)."""
    return (img[None], True) if img.ndim == 3 else (img, False)


def _out(x: torch.Tensor, single: bool) -> torch.Tensor:
    return x[0] if single else x


def _mag(v, x: torch.Tensor) -> torch.Tensor:
    """A float32 magnitude per image, shaped [B, 1, 1, 1]."""
    v = torch.as_tensor(v, dtype=torch.float32, device=x.device)
    return v.reshape(-1, 1, 1, 1).expand(x.shape[0], 1, 1, 1)


def _to_u8(img_f: torch.Tensor) -> torch.Tensor:
    """Pillow's float→uint8 in blend/filter paths TRUNCATES (C cast)."""
    return torch.clamp(torch.floor(img_f), 0, 255).to(torch.uint8)


def _gray(x: torch.Tensor) -> torch.Tensor:
    """PIL convert('L'): fixed-point (R·19595 + G·38470 + B·7471 + 2¹⁵) ≫ 16,
    float32 [B, H, W]."""
    i = x.to(torch.int32)
    return ((i[..., 0] * 19595 + i[..., 1] * 38470 + i[..., 2] * 7471 + 32768) >> 16).float()


def _blend(degenerate: torch.Tensor, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """PIL ImageEnhance: Image.blend(degenerate, image, v)."""
    return _to_u8(degenerate + v * (x.float() - degenerate))


def autocontrast(img, _v=None):
    """PIL ImageOps.autocontrast(cutoff=0): per-channel min-max stretch."""
    x, single = _batch(img)
    f = x.float()
    lo = f.amin((1, 2), keepdim=True)
    hi = f.amax((1, 2), keepdim=True)
    scale = 255.0 / torch.clamp_min(hi - lo, 1.0)
    out = torch.floor((f - lo) * scale + 1e-6)
    return _out(_to_u8(torch.where(hi > lo, out, f)), single)


def brightness(img, v):
    x, single = _batch(img)
    return _out(_blend(torch.zeros((), device=x.device), x, _mag(v, x)), single)


def color(img, v):
    x, single = _batch(img)
    return _out(_blend(_gray(x)[..., None], x, _mag(v, x)), single)


def contrast(img, v):
    """Degenerate = solid gray at floor(mean(L) + 0.5)."""
    x, single = _batch(img)
    g = _gray(x)
    mean = torch.floor(g.sum((1, 2)) / (g.shape[1] * g.shape[2]) + 0.5)
    return _out(_blend(mean.reshape(-1, 1, 1, 1), x, _mag(v, x)), single)


# PIL's SMOOTH kernel [[1,1,1],[1,5,1],[1,1,1]] / 13, as float32 taps
_SMOOTH = [(dy, dx, (5.0 if dy == dx == 1 else 1.0) / 13.0) for dy in range(3) for dx in range(3)]


def sharpness(img, v):
    """Degenerate = PIL SMOOTH filter of the interior, rounded (half to even),
    the border rows and columns kept from the source image."""
    x, single = _batch(img)
    f = x.float()
    H, W = f.shape[1], f.shape[2]
    sm = None
    for dy, dx, w in _SMOOTH:
        tap = f[:, dy: dy + H - 2, dx: dx + W - 2] * torch.tensor(w, dtype=torch.float32)
        sm = tap if sm is None else sm + tap
    deg = f.clone()
    deg[:, 1:-1, 1:-1] = torch.round(sm)
    return _out(_blend(deg, x, _mag(v, x)), single)


def equalize(img, _v=None):
    """PIL ImageOps.equalize: per-channel histogram-derived LUT; the identity
    where a channel has at most one level or its step is 0."""
    x, single = _batch(img)
    B = x.shape[0]
    ch = x.permute(0, 3, 1, 2).reshape(B * 3, -1).long()  # [B·3, H·W]
    h = torch.zeros(B * 3, 256, dtype=torch.int64, device=x.device).scatter_add_(1, ch, torch.ones_like(ch))
    nz = h > 0
    n_levels = nz.sum(1, keepdim=True)
    last = 255 - torch.argmax(nz.flip(1).int(), 1, keepdim=True)
    step = (h.sum(1, keepdim=True) - torch.gather(h, 1, last)) // 255
    csum = torch.cumsum(h, 1) - h  # exclusive
    lut = (step // 2 + csum) // torch.clamp_min(step, 1)
    ident = torch.arange(256, device=x.device).expand_as(lut)
    lut = torch.where((n_levels <= 1) | (step == 0), ident, lut).clamp(0, 255)
    out = torch.gather(lut, 1, ch).reshape(B, 3, *x.shape[1:3]).permute(0, 2, 3, 1)
    return _out(out.to(torch.uint8).contiguous(), single)


def invert(img, _v=None):
    return (255 - img.to(torch.int32)).to(torch.uint8)


def identity(img, _v=None):
    return img


def posterize(img, v):
    """Keep the top ``v`` bits, ``v`` truncated to an integer and clipped to 1..8."""
    x, single = _batch(img)
    shift = 8 - torch.clamp(_mag(v, x).to(torch.int32), 1, 8)
    return _out(((x.to(torch.int32) >> shift) << shift).to(torch.uint8), single)


def solarize(img, v):
    """Invert pixels ≥ threshold (PIL lut: i if i < v else 255 − i)."""
    x, single = _batch(img)
    i = x.to(torch.int32)
    return _out(torch.where(i < _mag(v, x), i, 255 - i).to(torch.uint8), single)


def _affine_nearest(x: torch.Tensor, a, b, c, d, e, f) -> torch.Tensor:
    """PIL Image.transform(AFFINE, (a,b,c,d,e,f)), resample=NEAREST, black
    fill, on [B, H, W, 3] with float32 coefficients [B, 1, 1]:
    out(x, y) = in(a·x' + b·y' + c, d·x' + e·y' + f) with x' = x + 0.5,
    y' = y + 0.5, floored to the source pixel."""
    B, H, W = x.shape[:3]
    ys = torch.arange(H, dtype=torch.float32, device=x.device) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=x.device) + 0.5
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]
    xi = torch.floor(a * xg + b * yg + c).to(torch.int64)
    yi = torch.floor(d * xg + e * yg + f).to(torch.int64)
    ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, H * W, 1).expand(B, H * W, 3)
    out = torch.gather(x.reshape(B, H * W, 3), 1, flat).reshape(B, H, W, 3)
    return torch.where(ok[..., None], out, torch.zeros((), dtype=x.dtype, device=x.device))


def _coef(v, x: torch.Tensor) -> torch.Tensor:
    """A float32 coefficient per image, shaped [B, 1, 1]."""
    return _mag(v, x)[..., 0]


def _affine(img, coefs):
    x, single = _batch(img)
    one, zero = _coef(1.0, x), _coef(0.0, x)
    a, b, c, d, e, f = (k if isinstance(k, torch.Tensor) else one if k == 1 else zero for k in coefs(x))
    return _out(_affine_nearest(x, a, b, c, d, e, f), single)


def shear_x(img, v):
    return _affine(img, lambda x: (1, _coef(v, x), 0, 0, 1, 0))


def shear_y(img, v):
    return _affine(img, lambda x: (1, 0, 0, _coef(v, x), 1, 0))


def translate_x(img, v):
    return _affine(img, lambda x: (1, 0, _coef(v, x) * x.shape[2], 0, 1, 0))


def translate_y(img, v):
    return _affine(img, lambda x: (1, 0, 0, 0, 1, _coef(v, x) * x.shape[1]))


def rotate(img, v):
    """PIL img.rotate(v): counter-clockwise degrees about (W/2, H/2), NEAREST
    (the inverse map turns by th = −v)."""

    def coefs(x):
        H, W = x.shape[1:3]
        th = -_coef(v, x) * math.pi / 180.0
        cx, cy = W / 2.0, H / 2.0
        cos, sin = torch.cos(th), torch.sin(th)
        c = cx - cx * cos - cy * sin
        f = cy + cx * sin - cy * cos
        return cos, sin, c, -sin, cos, f

    return _affine(img, coefs)


CUTOUT_FILL = (125, 123, 114)


def cutout_apply(img, v, ux, uy):
    """Reference Cutout from given numbers: a box of side v·W (v ∈ [0, 0.5])
    at centre (ux·W, uy·H) (ux, uy ∈ [0, 1)), its corner floored and clipped
    to the image, filled gray (125, 123, 114) INCLUSIVE of its end pixel, and
    nothing where v = 0."""
    x, single = _batch(img)
    H, W = x.shape[1:3]
    v, ux, uy = (_coef(t, x) for t in (v, ux, uy))
    size = v * W
    x0 = torch.floor(torch.clamp_min(ux * W - size / 2.0, 0.0))
    y0 = torch.floor(torch.clamp_min(uy * H - size / 2.0, 0.0))
    x1 = torch.clamp_max(x0 + size, W)
    y1 = torch.clamp_max(y0 + size, H)
    ys = torch.arange(H, dtype=torch.float32, device=x.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=x.device)[None, :]
    box = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1) & (v > 0)
    fill = torch.tensor(CUTOUT_FILL, dtype=torch.uint8, device=x.device)
    return _out(torch.where(box[..., None], fill, x), single)


def cutout(img, v, generator: Optional[torch.Generator] = None):
    """``cutout_apply`` with its centre drawn from ``generator`` (one per image)."""
    x, _ = _batch(img)
    u = torch.rand(2, x.shape[0], generator=generator, device=x.device)
    return cutout_apply(img, v, u[0], u[1])


# (op, min_v, max_v) — exactly augment_list() (randaugment.py:143-160)
AUGMENT_LIST = [
    (autocontrast, 0.0, 1.0),
    (brightness, 0.05, 0.95),
    (color, 0.05, 0.95),
    (contrast, 0.05, 0.95),
    (equalize, 0.0, 1.0),
    (identity, 0.0, 1.0),
    (posterize, 4.0, 8.0),
    (rotate, -30.0, 30.0),
    (sharpness, 0.05, 0.95),
    (shear_x, -0.3, 0.3),
    (shear_y, -0.3, 0.3),
    (solarize, 0.0, 256.0),
    (translate_x, -0.3, 0.3),
    (translate_y, -0.3, 0.3),
]


def randaugment_draw(batch: int, n: int = 2, generator: Optional[torch.Generator] = None,
                     device=None) -> Dict[str, torch.Tensor]:
    """``randaugment``'s numbers for ``batch`` images: ``ops`` [B, n] op indices
    (uniform over AUGMENT_LIST, with replacement), ``u`` [B, n] uniforms of
    their magnitudes, and the cutout's ``cut_v`` [B] (U[0, 0.5)), ``cut_ux``
    and ``cut_uy`` [B] (its centre's uniforms)."""
    g = dict(generator=generator, device=device)
    ops = torch.randint(0, len(AUGMENT_LIST), (batch, n), **g)
    u = torch.rand(batch, n, **g)
    cut = torch.rand(3, batch, **g)
    return {"ops": ops, "u": u, "cut_v": cut[0] * 0.5, "cut_ux": cut[1], "cut_uy": cut[2]}


def randaugment_apply(img, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """FixMatch RandAugment (randaugment.py:163-176) from given numbers: for
    each of the ``n`` rounds every image takes its op at magnitude
    ``lo + (hi − lo)·u``, then the cutout."""
    x, single = _batch(torch.as_tensor(img).to(torch.uint8))
    dev = x.device
    ops = torch.as_tensor(draws["ops"], device=dev).reshape(x.shape[0], -1)
    u = torch.as_tensor(draws["u"], dtype=torch.float32, device=dev).reshape(x.shape[0], -1)
    for r in range(ops.shape[1]):
        out = x
        for k, (op, lo, hi) in enumerate(AUGMENT_LIST):
            if op is identity:
                continue
            sel = (ops[:, r] == k).reshape(-1, 1, 1, 1)
            out = torch.where(sel, op(x, lo + (hi - lo) * u[:, r]), out)
        x = out
    x = cutout_apply(x, *(torch.as_tensor(draws[k], dtype=torch.float32, device=dev).reshape(-1)
                          for k in ("cut_v", "cut_ux", "cut_uy")))
    return _out(x, single)


def randaugment(img, n: int = 2, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``randaugment_apply`` of ``randaugment_draw``'s numbers, drawn from
    ``generator``: uint8 [H, W, 3] or [B, H, W, 3] in and out."""
    x, _ = _batch(torch.as_tensor(img))
    return randaugment_apply(img, randaugment_draw(x.shape[0], n, generator, x.device))
