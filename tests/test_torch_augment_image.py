"""The port's RandAugment (``erc_tpu_torch/augment_image.py``) against the
JAX package's (``erc_tpu/augment_image.py``), on the CPU.

Each of the 14 ops and ``cutout`` at three magnitudes on 24 × 20 uint8
images: the integer-path ops (invert, posterize, solarize, equalize,
autocontrast, the affine ops, identity) bit for bit; the float-blend ops
(brightness, color, contrast, sharpness) equal on ≥ 99 % of pixels and none
off by more than 1, the rule ``tests/test_randaugment.py`` holds the JAX ops
to against PIL.  The composed ``randaugment`` given the JAX function's own
draws (taken with its key splits) against ``randaugment(key, img)``, a
batch against per-image calls, and the generator path deterministic per
seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu import augment_image as jaug
from erc_tpu_torch import augment_image as taug
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 24, 20
BLEND = {"brightness", "color", "contrast", "sharpness"}
BLEND_SHARE, BLEND_MAX = 0.99, 1  # tests/test_randaugment.py's rule against PIL
MAGNITUDES = (0.1, 0.5, 0.93)  # uniforms: magnitude lo + (hi - lo)·u


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    imgs[0, :, :, 1] = 77  # a flat channel: autocontrast's and equalize's identity branches
    return imgs


def _agree(name, got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if name in BLEND:
        assert (d == 0).mean() >= BLEND_SHARE and d.max() <= BLEND_MAX, (name, (d == 0).mean(), d.max())
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("k", range(len(jaug.AUGMENT_LIST)), ids=[op.__name__ for op, _, _ in jaug.AUGMENT_LIST])
def test_op_matches_jax(k):
    jop, lo, hi = jaug.AUGMENT_LIST[k]
    top = taug.AUGMENT_LIST[k][0]
    assert top.__name__ == jop.__name__
    for i, img in enumerate(_images(2, seed=k)):
        for u in MAGNITUDES:
            v = np.float32(lo + (hi - lo) * np.float32(u))
            want = np.asarray(jop(jnp.asarray(img), jnp.float32(v)))
            got = top(torch.from_numpy(img), torch.tensor(v)).numpy()
            assert got.dtype == np.uint8 and got.shape == img.shape
            _agree(jop.__name__, got, want)


def test_cutout_matches_jax():
    img = _images(1)[0]
    for i, v in enumerate((0.0, 0.2, 0.49)):
        key = jax.random.PRNGKey(i)
        kx, ky = jax.random.split(key)
        ux, uy = (float(jax.random.uniform(kk)) for kk in (kx, ky))
        want = np.asarray(jaug.cutout(key, jnp.asarray(img), jnp.float32(v)))
        got = taug.cutout_apply(torch.from_numpy(img), v, ux, uy).numpy()
        np.testing.assert_array_equal(got, want)
        if v:
            assert (got != img).any()


def _jax_draws(key, n):
    """The numbers ``erc_tpu.augment_image.randaugment`` draws from ``key``, by its own splits (:224-233)."""
    key, kc = jax.random.split(key)
    ops, us = [], []
    for k in jax.random.split(key, n):
        ki, kv = jax.random.split(k)
        ops.append(int(jax.random.randint(ki, (), 0, len(jaug.AUGMENT_LIST))))
        us.append(float(jax.random.uniform(kv)))
    kv, kbox = jax.random.split(kc)
    kx, ky = jax.random.split(kbox)
    return {"ops": torch.tensor([ops]), "u": torch.tensor([us]),
            "cut_v": torch.tensor([float(jax.random.uniform(kv) * 0.5)]),
            "cut_ux": torch.tensor([float(jax.random.uniform(kx))]),
            "cut_uy": torch.tensor([float(jax.random.uniform(ky))])}


def test_randaugment_given_jax_draws_matches_jax():
    imgs = _images(12, seed=3)
    chosen = set()
    for i, img in enumerate(imgs):
        key = jax.random.PRNGKey(100 + i)
        draws = _jax_draws(key, 2)
        chosen.update(draws["ops"].reshape(-1).tolist())
        want = np.asarray(jaug.randaugment(key, jnp.asarray(img)))
        got = taug.randaugment_apply(torch.from_numpy(img), draws).numpy()
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert (d == 0).mean() >= BLEND_SHARE and d.max() <= BLEND_MAX, (i, draws, (d == 0).mean(), d.max())
    assert len(chosen) >= 8  # the draws reached most of the pool


def test_batch_matches_per_image_calls():
    imgs = torch.from_numpy(_images(6, seed=5))
    v = torch.tensor([0.1, 0.3, 0.5, 0.7, 0.9, 0.2])
    for op, lo, hi in taug.AUGMENT_LIST:
        mags = lo + (hi - lo) * v
        batch = op(imgs, mags)
        for i in range(len(imgs)):
            torch.testing.assert_close(batch[i], op(imgs[i], mags[i]), rtol=0, atol=0, msg=op.__name__)
    g = torch.Generator().manual_seed(4)
    draws = taug.randaugment_draw(len(imgs), 3, generator=g)
    batch = taug.randaugment_apply(imgs, draws)
    for i in range(len(imgs)):
        one = {k: t[i: i + 1] for k, t in draws.items()}
        torch.testing.assert_close(batch[i], taug.randaugment_apply(imgs[i], one), rtol=0, atol=0)


def test_generator_path_is_deterministic_per_seed():
    imgs = torch.from_numpy(_images(8, seed=6))

    def run(seed):
        return taug.randaugment(imgs, 2, generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert a.dtype == torch.uint8 and a.shape == imgs.shape
    assert torch.equal(a, b) and not torch.equal(a, c)
    d = taug.randaugment_draw(4096, 2, generator=torch.Generator().manual_seed(0))
    assert set(d["ops"].unique().tolist()) == set(range(len(taug.AUGMENT_LIST)))
    assert 0 <= float(d["cut_v"].min()) and float(d["cut_v"].max()) < 0.5
    cut = [taug.cutout(imgs, 0.3, generator=torch.Generator().manual_seed(2)) for _ in range(2)]
    assert torch.equal(cut[0], cut[1]) and (cut[0] != imgs).any()
