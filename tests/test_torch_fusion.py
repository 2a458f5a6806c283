"""The port's fusion modules (``erc_tpu_torch/ops/fusion.py``) against the JAX
package's (``erc_tpu/ops/fusion.py``), on the CPU.

The flax weights go through ``convert.py`` (``simple_attention_state``,
``matching_attention_state``, ``mm_gated_attention_state``); outputs, the
gradients of the parameters (the flax gradient tree carried through the same
converter) and of the inputs agree within 1e-5: ``SimpleAttention`` with and
without a mask, ``MatchingAttention`` in all four ``att_type``s with masks,
``MMGatedAttention`` over 'atv', 'av', 'at' and 'vt' in eval mode, and its
per-modality dropout in training (off at p = 0, masks drawn from the port's
generator above it).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu.ops import fusion as jf
from erc_tpu_torch import convert
from erc_tpu_torch.ops import fusion as tf
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-5)
B, L, D_MEM, D_CAND = 3, 6, 8, 5


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **TOL)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    M = r.normal(size=(B, L, D_MEM)).astype(np.float32)
    x = r.normal(size=(B, D_CAND)).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[0, 4:] = 0
    mask[2, 1:] = 0
    return M, x, mask


def _check(jmod, variables, tmod, state, j_args, t_args, reduce):
    """Outputs and gradients (parameters, then inputs) of ``reduce(outputs)``."""
    tmod.load_state_dict(state)

    arrays = [i for i, a in enumerate(j_args) if isinstance(a, jax.Array)]

    def jloss(params, *xs):
        args = list(j_args)
        for i, xv in zip(arrays, xs):
            args[i] = xv
        return reduce(jnp, jmod.apply({"params": params}, *args))

    want = jmod.apply(variables, *j_args)
    grad = jax.grad(jloss, argnums=tuple(range(len(arrays) + 1)))
    jg, *jxg = grad(variables["params"], *(j_args[i] for i in arrays))
    inputs = [a.clone().requires_grad_(True) if i in arrays else a for i, a in enumerate(t_args)]
    with torch.enable_grad():  # another test file may have switched grad mode off at import
        got = tmod(*inputs)
        reduce(torch, got).backward()
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        _close(g.detach(), w, "output")
    want_g = convert.STATES[state_name(tmod)]({"params": jax.tree_util.tree_map(np.asarray, jg)})
    for name, p in tmod.named_parameters():
        _close(p.grad, want_g[name].numpy(), name)
    for i, w in zip(arrays, jxg):
        g = inputs[i].grad  # None where the input only selects (a mask through `mask > 0`)
        _close(np.zeros_like(w) if g is None else g, w, f"gradient of input {i}")


def state_name(tmod) -> str:
    return {tf.SimpleAttention: "simple_attention", tf.MatchingAttention: "matching_attention",
            tf.MMGatedAttention: "mm_gated_attention"}[type(tmod)]


def _weighted(seed, shapes):
    r = np.random.default_rng(seed)
    return [r.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("masked", [False, True])
def test_simple_attention(masked):
    M, _, mask = _inputs(1)
    wp, wa = _weighted(2, [(B, D_MEM), (B, L)])
    jmod = jf.SimpleAttention()
    args = (jnp.asarray(M),) + ((jnp.asarray(mask),) if masked else ())
    variables = jmod.init(jax.random.PRNGKey(0), *args)
    tmod = tf.SimpleAttention(D_MEM)
    t_args = (torch.tensor(M),) + ((torch.tensor(mask),) if masked else ())
    reduce = lambda m, out: (out[0] * m.asarray(wp) if m is jnp else out[0] * torch.tensor(wp)).sum() + \
        (out[1] * (m.asarray(wa) if m is jnp else torch.tensor(wa))).sum()
    _check(jmod, variables, tmod, convert.simple_attention_state(variables["params"]), args, t_args, reduce)


@pytest.mark.parametrize("att_type", ["dot", "general", "general2", "concat"])
def test_matching_attention(att_type):
    M, x, mask = _inputs(3)
    cand = D_MEM if att_type == "dot" else D_CAND
    x = np.random.default_rng(4).normal(size=(B, cand)).astype(np.float32)
    wp, wa = _weighted(5, [(B, D_MEM), (B, L)])
    jmod = jf.MatchingAttention(D_MEM, cand, alpha_dim=7, att_type=att_type)
    j_args = (jnp.asarray(M), jnp.asarray(x), jnp.asarray(mask))
    variables = jmod.init(jax.random.PRNGKey(1), *j_args)
    if att_type == "dot":
        variables = {"params": {}}
    tmod = tf.MatchingAttention(D_MEM, cand, alpha_dim=7, att_type=att_type)
    state = convert.matching_attention_state(variables["params"], att_type)
    assert set(state) == {n for n, _ in tmod.named_parameters()}

    def reduce(m, out):
        lift = jnp.asarray if m is jnp else torch.tensor
        return (out[0] * lift(wp)).sum() + (out[1] * lift(wa)).sum()

    _check(jmod, variables, tmod, state, j_args, (torch.tensor(M), torch.tensor(x), torch.tensor(mask)), reduce)
    if att_type == "general2":
        with torch.no_grad():
            assert float(tmod(torch.tensor(M), torch.tensor(x), torch.tensor(mask))[1][0, 4:].abs().sum()) < 1e-6


@pytest.mark.parametrize("modals", ["atv", "av", "at", "vt"])
def test_mm_gated_attention(modals):
    r = np.random.default_rng(6)
    a, v, l = (r.normal(size=(B, D_MEM)).astype(np.float32) for _ in range(3))
    jmod = jf.MMGatedAttention(D_MEM, D_CAND)
    j_args = (jnp.asarray(a), jnp.asarray(v), jnp.asarray(l), modals)
    variables = jmod.init(jax.random.PRNGKey(2), *j_args)
    tmod = tf.MMGatedAttention(D_MEM, D_CAND, modals=modals).eval()
    width = D_CAND * (3 if modals == "atv" else 1)
    (w,) = _weighted(7, [(B, width)])

    def reduce(m, out):
        return (out * (jnp.asarray(w) if m is jnp else torch.tensor(w))).sum()

    state = convert.mm_gated_attention_state(variables["params"])
    assert set(state) == {n for n, _ in tmod.named_parameters()}
    _check(jmod, variables, tmod, state, j_args, (torch.tensor(a), torch.tensor(v), torch.tensor(l), modals), reduce)


def test_mm_gated_attention_dropout_in_training():
    r = np.random.default_rng(8)
    a, v, l = (torch.tensor(r.normal(size=(B, D_MEM)).astype(np.float32)) for _ in range(3))
    off = tf.MMGatedAttention(D_MEM, D_CAND, dropout=0.0)
    torch.testing.assert_close(off.train()(a, v, l), off.eval()(a, v, l), rtol=0, atol=0)
    on = tf.MMGatedAttention(D_MEM, D_CAND, dropout=0.5)
    for drop in (on.drop_a, on.drop_v, on.drop_l):
        drop.generator = torch.Generator().manual_seed(3)
    first = on.train()(a, v, l)
    assert not torch.allclose(first, on.eval()(a, v, l))
    for drop in (on.drop_a, on.drop_v, on.drop_l):
        drop.generator = torch.Generator().manual_seed(3)
    torch.testing.assert_close(on.train()(a, v, l), first, rtol=0, atol=0)  # the generator's masks
