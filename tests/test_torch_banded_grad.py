"""The band kernels' gradients in the port (autograd Functions of K1/K2,
built from K1, K2 and K1ᵀ) ≡ the JAX package's custom VJPs.

On the CPU the Functions run the plain pieces, as the wrappers do for CPU
tensors, so the composition is the one the card runs.  Against
``jax.vjp`` of ``erc_tpu.ops.pallas.banded.banded_gather_sum`` and
``banded_dot`` (Pallas in interpret mode): forward and gradients within
1e-5 absolute (float32; the sums differ from JAX's only in order, and K1ᵀ
sums the taps in ``_bgs_bwd``'s order).  Shapes: the RGCN's halves of
COGMEN's band (offsets −5..−1 and 0..5), the full band, L < K, D = 13 and
asymmetric offsets.  Also: ``banded_gather_sum_t_reference`` against a
direct loop (exact), that an unneeded gradient is not computed, that
expanded cotangents and the strided ``Ysel`` views give the gradients of
autograd through the plain versions (1e-6), and that with grad off the
wrappers return the plain forward with no autograd node.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu.ops.pallas import banded as jbanded
from erc_tpu_torch.ops.kernels import banded as tb
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-5

CASES = [  # (B, L, D, offsets)
    (2, 16, 8, tuple(range(-5, 0))),  # the RGCN's backward half
    (2, 16, 8, tuple(range(0, 6))),  # its forward half
    (3, 12, 8, tuple(range(-5, 6))),  # TransformerConv's full band
    (2, 3, 8, tuple(range(-5, 6))),  # L < K: most taps out of range
    (2, 9, 13, (-3, 0, 1, 4)),  # D = 13, asymmetric offsets
]
IDS = [f"B{b}-L{l}-D{d}-K{len(o)}" for b, l, d, o in CASES]


def _inputs(B, L, D, K, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    return f(B, L, K), f(B, L, D), f(B, L, D), f(B, L, D), f(B, L, K)


def _grads(fn, x, y, g):
    """fn(x, y) and the gradients of <fn(x, y), g> through the port."""
    x, y = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    with torch.enable_grad():
        out = fn(x, y)
        out.backward(torch.from_numpy(g))
    return out.detach().numpy(), x.grad.numpy(), y.grad.numpy()


@pytest.mark.parametrize("B,L,D,offs", CASES, ids=IDS)
def test_gather_sum_grads_match_jax_vjp(B, L, D, offs):
    coef, src, _, g, _ = _inputs(B, L, D, len(offs))
    want, vjp = jax.vjp(lambda c, s: jbanded.banded_gather_sum(c, s, offs), coef, src)
    dcoef, dsrc = vjp(jnp.asarray(g))
    got, gcoef, gsrc = _grads(lambda c, s: tb.banded_gather_sum(c, s, offs), coef, src, g)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(gcoef, np.asarray(dcoef), rtol=0, atol=ATOL)
    np.testing.assert_allclose(gsrc, np.asarray(dsrc), rtol=0, atol=ATOL)


@pytest.mark.parametrize("B,L,D,offs", CASES, ids=IDS)
def test_dot_grads_match_jax_vjp(B, L, D, offs):
    _, a, b, _, g = _inputs(B, L, D, len(offs), seed=1)
    want, vjp = jax.vjp(lambda x, y: jbanded.banded_dot(x, y, offs), a, b)
    da, db = vjp(jnp.asarray(g))
    got, ga, gb = _grads(lambda x, y: tb.banded_dot(x, y, offs), a, b, g)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ga, np.asarray(da), rtol=0, atol=ATOL)
    np.testing.assert_allclose(gb, np.asarray(db), rtol=0, atol=ATOL)


@pytest.mark.parametrize("B,L,D,offs", CASES, ids=IDS)
def test_gather_sum_t_reference_is_the_transposed_band(B, L, D, offs):
    coef, src, *_ = _inputs(B, L, D, len(offs), seed=2)
    want = np.zeros((B, L, D), np.float32)
    for b in range(B):
        for u in range(L):
            for k, o in enumerate(offs):
                if 0 <= u + o < L:
                    want[b, u] += coef[b, u + o, k] * src[b, u + o]
    got = tb.banded_gather_sum_t_reference(torch.from_numpy(coef), torch.from_numpy(src), offs)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(tb.banded_gather_sum_t(torch.from_numpy(coef), torch.from_numpy(src), offs).numpy(),
                                  want)


def test_unneeded_gradients_are_not_computed(monkeypatch):
    """Only src requires grad (the RGCN's case): no K2 for d coef, and coef's
    gradient stays None; only b requires grad: no K1 for d a."""
    calls = []
    real_dot, real_gather = tb._dot, tb._gather
    monkeypatch.setattr(tb, "_dot", lambda *a: calls.append("K2") or real_dot(*a))
    monkeypatch.setattr(tb, "_gather", lambda name, *a: calls.append(name) or real_gather(name, *a))
    coef, src, a, g, gk = (torch.from_numpy(x) for x in _inputs(2, 12, 8, 11))
    offs = tuple(range(-5, 6))
    src.requires_grad_()
    with torch.enable_grad():
        tb.banded_gather_sum(coef, src, offs).backward(g)
    assert calls == ["banded_gather_sum", "banded_gather_sum_t"] and coef.grad is None
    calls.clear()
    b = a.clone().requires_grad_()
    with torch.enable_grad():
        tb.banded_dot(a, b, offs).backward(gk)
    assert calls == ["K2", "banded_gather_sum_t"] and a.grad is None


def _plain_grads(fn, ref, *inputs, cotangent):
    """Gradients of <fn(*inputs), cotangent> through the port's Function and
    through autograd of the plain version `ref`."""
    out = []
    for f in (fn, ref):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        with torch.enable_grad():
            f(*leaves).backward(cotangent)
        out.append([t.grad for t in leaves])
    return out


def test_expanded_cotangent_and_strided_views_give_plain_autograd():
    """The RGCN reads Ysel[:, :, s, t, :], strided views of [B, L, S, 2, D]; a
    sum's cotangent arrives expanded (zero strides)."""
    r = np.random.default_rng(3)
    B, L, S, D = 2, 14, 2, 8
    ysel = torch.from_numpy(r.normal(size=(B, L, S, 2, D)).astype(np.float32))
    coef = torch.from_numpy(r.normal(size=(B, L, 6)).astype(np.float32))
    g = torch.from_numpy(r.normal(size=(1, 1, D)).astype(np.float32)).expand(B, L, D)
    assert g.stride()[:2] == (0, 0)
    pos = tuple(range(0, 6))
    got, want = _plain_grads(lambda c, y: tb.banded_gather_sum(c, y[:, :, 1, 1, :], pos),
                             lambda c, y: tb.banded_gather_sum_reference(c, y[:, :, 1, 1, :], pos),
                             coef, ysel, cotangent=g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    assert not got[1][:, :, :, 0].any() and not got[1][:, :, 0].any()  # only the view's slots
    gk = torch.from_numpy(r.normal(size=(1, 1, 11)).astype(np.float32)).expand(B, L, 11)
    full = tuple(range(-5, 6))
    got, want = _plain_grads(lambda x, y: tb.banded_dot(x[:, :, 0, 1, :], y[:, :, 1, 0, :], full),
                             lambda x, y: tb.banded_dot_reference(x[:, :, 0, 1, :], y[:, :, 1, 0, :], full),
                             ysel, ysel.flip(0), cotangent=gk)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_grad_off_returns_the_plain_forward_without_a_node(mode):
    coef, src, a, *_ = (torch.from_numpy(x) for x in _inputs(2, 10, 8, 11))
    coef.requires_grad_()
    src.requires_grad_()
    offs = tuple(range(-5, 6))
    ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    with ctx:
        out = tb.banded_gather_sum(coef, src, offs)
        dot = tb.banded_dot(src, a, offs)
    assert out.grad_fn is None and dot.grad_fn is None and not out.requires_grad
    want = tb.banded_gather_sum_reference(coef.detach(), src.detach(), offs)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    np.testing.assert_array_equal(dot.numpy(), tb.banded_dot_reference(src.detach(), a, offs).numpy())
    with torch.enable_grad():
        assert type(tb.banded_gather_sum(coef, src, offs).grad_fn).__name__ == "_GatherSumFunctionBackward"
        assert type(tb.banded_dot(src, a, offs).grad_fn).__name__ == "_DotFunctionBackward"


def test_launch_args_carry_the_negated_offsets():
    args = tb.launch_args(range(-5, 0))
    assert args.negated == (5, 4, 3, 2, 1)
    assert tb.launch_args(args.negated).negated == args.offsets
