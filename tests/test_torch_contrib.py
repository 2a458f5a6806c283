"""The port's training extras (``erc_tpu_torch/contrib.py``) against the JAX
package's (``erc_tpu/contrib.py``), on the CPU.

Every tensor function against JAX at 1e-6 (absolute and relative): the EMA
update over a dict and over a module, one-hot, sharpening, label guessing,
``mixup`` and ``cutmix`` fed the draws the JAX functions take from their keys
(``contrib.py:42-44``: the permutation and λ from the same key;
``:66-74``: four split keys), the loss zoo with and without masks and with
soft targets, and ``MemoryBank``'s wrap-around.  The host helpers (audio
crops, noise and compose, dataset mean/std, the split helpers) give the same
arrays bit for bit under the same ``np.random.default_rng`` or
``np.random.seed``.  The generator-driven draws are held to their laws.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu import contrib as jc
from erc_tpu_torch import contrib as tc
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-6, atol=1e-6)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), **TOL)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_ema_update_dict_and_module():
    r = _rng()
    e = {"w": r.normal(size=(3, 4)).astype(np.float32), "b": r.normal(size=4).astype(np.float32)}
    p = {k: r.normal(size=v.shape).astype(np.float32) for k, v in e.items()}
    want = jc.ema_update({k: jnp.asarray(v) for k, v in e.items()}, {k: jnp.asarray(v) for k, v in p.items()}, 0.9)
    shadow = {k: torch.tensor(v) for k, v in e.items()}
    tc.ema_update(shadow, {k: torch.tensor(v) for k, v in p.items()}, 0.9)
    for k in e:
        _close(shadow[k], want[k])
    lin, lin2 = torch.nn.Linear(4, 3), torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(e["w"]))
        lin2.weight.copy_(torch.tensor(p["w"]))
    tc.ema_update(lin, lin2, 0.9)
    _close(lin.weight.detach().numpy(), want["w"])
    with pytest.raises(ValueError):
        tc.ema_update([torch.zeros(2)], [], 0.5)


def test_onehot_sharpen_label_guess():
    labels = np.array([[0, 2, 1], [3, -1, 1]])
    _close(tc.onehot(torch.tensor(labels), 4), jc.onehot(jnp.asarray(labels), 4))
    probs = _rng(1).dirichlet(np.ones(5), size=6).astype(np.float32)
    _close(tc.sharpen(torch.tensor(probs), 0.5), jc.sharpen(jnp.asarray(probs), 0.5))
    a, b = probs[:3], probs[3:]
    _close(tc.label_guess(torch.tensor(a), torch.tensor(b)), jc.label_guess(jnp.asarray(a), jnp.asarray(b)))


def test_mixup_apply_given_jax_draws():
    r = _rng(2)
    x = r.normal(size=(6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 6)]
    x2, y2 = r.normal(size=x.shape).astype(np.float32), y[::-1].copy()
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        perm = np.asarray(jax.random.permutation(key, 6))  # contrib.py:42-44: one key for both
        lam = float(jax.random.beta(key, 0.75, 0.75))
        for pair in (False, True):
            extra_j = (jnp.asarray(x2), jnp.asarray(y2)) if pair else ()
            extra_t = (torch.tensor(x2), torch.tensor(y2)) if pair else ()
            want = jc.mixup(key, jnp.asarray(x), jnp.asarray(y), *extra_j)
            got = tc.mixup_apply(torch.tensor(x), torch.tensor(y), torch.tensor(perm), lam, *extra_t)
            for g, w in zip(got, want):
                _close(g, w)


def test_cutmix_apply_given_jax_draws():
    r = _rng(3)
    x = r.normal(size=(4, 9, 7, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[r.integers(0, 5, 4)]
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        kperm, klam, kx, ky = jax.random.split(key, 4)  # contrib.py:66-74
        perm = torch.tensor(np.asarray(jax.random.permutation(kperm, 4)))
        lam = float(jax.random.beta(klam, 1.0, 1.0))
        cy = float(jax.random.uniform(ky, (), minval=0.0, maxval=9))
        cx = float(jax.random.uniform(kx, (), minval=0.0, maxval=7))
        want = jc.cutmix(key, jnp.asarray(x), jnp.asarray(y))
        got = tc.cutmix_apply(torch.tensor(x), torch.tensor(y), perm, lam, cy, cx)
        for g, w in zip(got, want):
            _close(g, w)


def test_generator_draws():
    g = torch.Generator().manual_seed(0)
    lams = torch.stack([tc.beta_draw(0.75, 0.75, g) for _ in range(4000)]).double()
    assert abs(float(lams.mean()) - 0.5) < 0.02
    assert abs(float(lams.var()) - 0.25 / 2.5) < 0.01  # Beta(a, a): 1 / (4 (2a + 1))
    gam = torch.stack([tc._gamma(2.5, g, None) for _ in range(4000)]).double()
    assert abs(float(gam.mean()) - 2.5) < 0.1
    x = torch.randn(8, 6, 5, 3, generator=g)
    y = tc.onehot(torch.randint(0, 4, (8,), generator=g), 4)
    a = tc.cutmix(x, y, generator=torch.Generator().manual_seed(7))
    b = tc.cutmix(x, y, generator=torch.Generator().manual_seed(7))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    xm, ym, lam = tc.mixup(x, y, generator=torch.Generator().manual_seed(1))
    assert float(lam) >= 0.5 and xm.shape == x.shape and torch.allclose(ym.sum(-1), torch.ones(8))


@pytest.mark.parametrize("masked", [False, True])
def test_loss_zoo(masked):
    r = _rng(4)
    logits = r.normal(size=(3, 4, 5)).astype(np.float32)
    other = r.normal(size=logits.shape).astype(np.float32)
    labels = r.integers(0, 5, (3, 4))
    soft = r.dirichlet(np.ones(5), size=(3, 4)).astype(np.float32)
    mask = (r.random((3, 4)) > 0.4).astype(np.float32) if masked else None
    J, T = (lambda a: jnp.asarray(a)), (lambda a: torch.tensor(a))
    m_j = None if mask is None else J(mask)
    m_t = None if mask is None else T(mask)
    _close(tc.ce_loss(T(logits), T(labels), m_t), jc.ce_loss(J(logits), J(labels), m_j))
    _close(tc.ce_loss(T(logits), T(soft), m_t), jc.ce_loss(J(logits), J(soft), m_j))
    _close(tc.mse_loss(T(logits), T(other), m_t), jc.mse_loss(J(logits), J(other), m_j))
    _close(tc.minent_loss(T(logits), m_t), jc.minent_loss(J(logits), m_j))
    _close(tc.kl_loss(T(logits), T(other), m_t), jc.kl_loss(J(logits), J(other), m_j))
    zero = np.zeros((3, 4), np.float32)  # max(mask.sum(), 1): an all-invalid mask gives 0, not NaN
    _close(tc.ce_loss(T(logits), T(labels), T(zero)), jc.ce_loss(J(logits), J(labels), J(zero)))


def test_contrastive_loss():
    r = _rng(5)
    za, zb = (r.normal(size=(6, 8)).astype(np.float32) for _ in range(2))
    for t in (0.1, 0.5):
        _close(tc.contrastive_loss(torch.tensor(za), torch.tensor(zb), t),
               jc.contrastive_loss(jnp.asarray(za), jnp.asarray(zb), t))


def test_memory_bank_wraps():
    jb, jp = jc.MemoryBank.init(5, 3)
    tb, tp = tc.MemoryBank.init(5, 3)
    r = _rng(6)
    for n in (3, 4, 2, 5):
        feats = r.normal(size=(n, 3)).astype(np.float32)
        jb, jp = jc.MemoryBank.push(jb, jp, jnp.asarray(feats))
        tb, tp = tc.MemoryBank.push(tb, tp, torch.tensor(feats))
        _close(tb, jb)
        assert int(tp) == int(jp) and tp.dtype == torch.int32
    assert int(tp) == (3 + 4 + 2 + 5) % 5


def test_audio_helpers_bit_for_bit():
    sig = _rng(7).normal(size=1000)
    neg = -np.abs(sig)
    for seed in range(3):
        for op in ("random_crop", "center_crop"):
            j = getattr(jc, f"audio_{op}")(300)(sig, np.random.default_rng(seed))
            t = getattr(tc, f"audio_{op}")(300)(sig, np.random.default_rng(seed))
            np.testing.assert_array_equal(t, j)
        for x in (sig, neg, sig[:100]):
            j = jc.audio_gauss_noise(20.0, 0.7)(x, np.random.default_rng(seed))
            t = tc.audio_gauss_noise(20.0, 0.7)(x, np.random.default_rng(seed))
            np.testing.assert_array_equal(t, j)
        ops = lambda m: m.AudioCompose(m.audio_random_crop(500), None, m.audio_gauss_noise(10.0, 1.0))
        np.testing.assert_array_equal(ops(tc)(sig, np.random.default_rng(seed)),
                                      ops(jc)(sig, np.random.default_rng(seed)))
    np.testing.assert_array_equal(tc.AudioCompose(tc.audio_center_crop(10))(sig),
                                  jc.AudioCompose(jc.audio_center_crop(10))(sig))


def test_dataset_mean_std_bit_for_bit():
    r = _rng(8)
    imgs = [r.integers(0, 256, (6, 5, 3)).astype(np.uint8) for _ in range(4)]
    assert tc.dataset_mean_std(imgs) == jc.dataset_mean_std(imgs)
    pairs = [(im, i) for i, im in enumerate(imgs)]
    assert tc.dataset_mean_std(pairs) == jc.dataset_mean_std(pairs)
    with pytest.raises(ValueError):
        tc.dataset_mean_std([])


def _same(a, b):
    if isinstance(a, (tuple, list)) and a and isinstance(a[0], (np.ndarray, list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_split_helpers_bit_for_bit():
    labels = np.repeat(np.arange(4), 30)
    assert tc.sequence_split([2, 3, 1]) == jc.sequence_split([2, 3, 1])
    assert tc.ratio2length(97, 0.5, 0.3, 0.2) == jc.ratio2length(97, 0.5, 0.3, 0.2)
    cases = [("semi_split", (labels, 5), dict(val_size=20)),
             ("semi_split", (labels, 5), dict(val_size=20, include_sup=False, repeat_sup=False, shuffle=False)),
             ("train_val_split", (labels,), dict(val_size=30)),
             ("train_val_split", (labels,), dict(val_size=30, train_size=50)),
             ("create_imbalanced_data", (labels,), dict(imb_type="exp", imb_factor=0.1)),
             ("create_imbalanced_data", (labels,), dict(imb_type="step", imb_factor=0.1)),
             ("create_imbalanced_data", (labels,), dict(imb_type="none"))]
    for name, args, kw in cases:
        _same(getattr(tc, name)(*args, rng=np.random.default_rng(3), **kw),
              getattr(jc, name)(*args, rng=np.random.default_rng(3), **kw))
        np.random.seed(11)  # no rng given: the global stream, as the reference
        j = getattr(jc, name)(*args, **kw)
        np.random.seed(11)
        _same(getattr(tc, name)(*args, **kw), j)
    with pytest.raises(ValueError):
        tc.train_val_split(labels, val_size=100, train_size=50)
