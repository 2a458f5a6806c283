"""K4, the backward of DAG-ERC's block recurrence, in the port ≡ the JAX
package's.

The port's plain version of K4 (``dag_block_backward_reference``), reached
through ``dag_block``'s autograd Function on CPU tensors, against
``jax.grad`` of the JAX ``dag_block`` (its custom VJP: the Pallas kernels
``_dag_block_all`` and ``_dag_block_bwd`` in interpret mode), on the cases of
tests/test_pallas_dag_block.py:68-115: a block with a prefix, a padded tail
whose cotangents are zero, and the first block (flag = 1).  Every input's
gradient is compared; the masks get none in either package.  K3's residuals
``hpc``/``xpp`` against ``_dag_block_all``'s.

Tolerance 1e-5 × max(1, max |want|): both sides run the same replay in
float32 and differ only in summation order; the weight gradients sum B·C
terms, hence the scale.  Against autograd of the eager form (the plain
forward differentiated by torch) the same tolerance holds, but only under
the gradient contract: rows with no predecessor carry zero cotangents or
are flag-gated.  Also K4's launch plan (``bwd_plan``, pure Python: which
variant of the sweep, rows and clusters) and its refusals.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu.ops.pallas import dag_block as dbk
from erc_tpu_torch.ops.kernels import dag_block as tdb
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

B, C, D = 3, 4, 8
RTOL = 1e-5
NAMES = ["qb", "xcb", "hppb", "hb", "num01", "den_p", "mp", "amw", "smw",
         "Whc", "bhc", "Wip", "bip", "Wr0T", "Wr1T", "wkc"]
MASKS = ("amw", "smw")


def _inputs(seed, with_prefix=True, all_masked_tail=False):
    """K3's arguments as numpy arrays, as tests/test_pallas_dag_block.py builds
    them: i - 1 always precedes a valid i, additive -1e30 masks."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    adj = (r.random((B, C, C)) < 0.6) & (np.tril(np.ones((C, C)), -1) > 0)
    for c in range(1, C):
        adj[:, c, c - 1] = True
    if all_masked_tail:
        adj[:, -1, :] = False  # a padding-like row, given zero cotangents
    amw = (-(1.0 - adj.astype(f32)) * 1e30).astype(f32)
    smw = (r.random((B, C, C)) < 0.5).astype(f32)
    qb, xcb, hppb, hb = (r.normal(size=s).astype(f32) for s in ((B, C), (B, C, 3, D), (B, C, 3, D), (B, C, D)))
    if with_prefix:
        num01 = r.normal(size=(B, C, D)).astype(f32)
        den_p = (r.random((B, C)) + 0.5).astype(f32)
        mp = r.normal(size=(B, C)).astype(f32)
    else:
        num01, den_p = np.zeros((B, C, D), f32), np.zeros((B, C), f32)
        mp = np.full((B, C), np.finfo(f32).min / 2, f32)
    weights = [(r.normal(size=s) * sc).astype(f32) for s, sc in (
        ((3, D, D), 0.3), ((3, D), 0.1), ((3, D, D), 0.3), ((3, D), 0.1),
        ((D, D), 0.3), ((D, D), 0.3), ((D, 1), 0.3))]
    flag = np.array([0 if with_prefix else 1], np.int32)
    return [flag, qb, xcb, hppb, hb, num01, den_p, mp, amw, smw, *weights]


def _cotangents(seed, zero_tail):
    r = np.random.default_rng(seed)
    cts = [r.normal(size=s).astype(np.float32) for s in ((B, C, D), (B, C, D), (B, C, D), (B, C))]
    if zero_tail:
        for ct in cts:
            ct[:, -1] = 0.0
    return cts


# (inputs seed, with_prefix, padded tail with zero cotangents)
CASES = [(1, True, False), (1, True, True), (2, False, False)]
IDS = ["prefix", "padded-tail-zero-cotangent", "first-block-flag"]


def _jax_loss(flag, *rest):
    """<dag_block(flag, *args), cts>: rest = 16 arguments, then 4 cotangents."""
    outs = dbk.dag_block(flag, *rest[:16])
    return sum(jnp.vdot(o, ct) for o, ct in zip(outs, rest[16:]))


# one compile of the interpret-mode kernels serves every case
_jax_grad_fn = jax.jit(jax.grad(_jax_loss, argnums=tuple(range(1, 17))))
_jax_all_fn = jax.jit(dbk._dag_block_all)


def _jax_grads(args, cts):
    """jax.grad of <dag_block(...), cts> for every input but the flag."""
    with jax.default_matmul_precision("highest"):
        grads = _jax_grad_fn(*[jnp.asarray(a) for a in (*args, *cts)])
    return [np.asarray(g) for g in grads]


def _port_grads(args, cts, tail=None):
    """Gradients of <dag_block(...), cts> through the port's Function (or, with
    `tail`, through torch autograd of that forward)."""
    leaves = [torch.from_numpy(a.copy()).requires_grad_(name not in MASKS)
              for name, a in zip(NAMES, args[1:])]
    with torch.enable_grad():
        outs = (tail or tdb.dag_block)(int(args[0][0]), *leaves)
        loss = sum((o * torch.from_numpy(ct)).sum() for o, ct in zip(outs, cts))
        loss.backward()
    return [None if t.grad is None else t.grad.numpy() for t in leaves]


def _close(got, want, name):
    tol = RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("seed,with_prefix,tail", CASES, ids=IDS)
def test_function_grads_match_jax_kernel_vjp(seed, with_prefix, tail):
    args = _inputs(seed, with_prefix, tail)
    cts = _cotangents(9, tail)
    tdb.reset_launches()
    got = _port_grads(args, cts)
    assert tdb.launches == {"dag_block": 0, "dag_block_bwd": 0}  # CPU tensors: the plain versions
    for name, g, w in zip(NAMES, got, _jax_grads(args, cts)):
        if name in MASKS:
            assert g is None and not w.any(), name  # no gradient reaches the masks in either
            continue
        _close(g, w, name)


@pytest.mark.parametrize("seed,with_prefix,tail", CASES, ids=IDS)
def test_function_grads_match_eager_autograd_under_contract(seed, with_prefix, tail):
    args = _inputs(seed, with_prefix, tail)
    cts = _cotangents(10, tail)
    want = _port_grads(args, cts, tail=tdb.dag_block_reference)
    for name, g, w in zip(NAMES, _port_grads(args, cts), want):
        if name not in MASKS:
            _close(g, w, name)


def test_unused_outputs_take_zero_cotangents():
    """Only h1 reaches the loss: autograd hands the Function None for V0w, V1w
    and Kw, which it takes as zeros, as jax.grad does."""
    args = _inputs(3)
    cts = _cotangents(11, False)
    cts[1:] = [np.zeros_like(ct) for ct in cts[1:]]
    leaves = [torch.from_numpy(a.copy()).requires_grad_(n not in MASKS) for n, a in zip(NAMES, args[1:])]
    with torch.enable_grad():
        (tdb.dag_block(0, *leaves)[0] * torch.from_numpy(cts[0])).sum().backward()
    for name, t, w in zip(NAMES, leaves, _jax_grads(args, cts)):
        if name not in MASKS:
            _close(t.grad.numpy(), w, name)


@pytest.mark.parametrize("seed,with_prefix,tail", CASES, ids=IDS)
def test_residuals_match_jax_dag_block_all(seed, with_prefix, tail):
    args = _inputs(seed, with_prefix, tail)
    with jax.default_matmul_precision("highest"):
        want = _jax_all_fn(*[jnp.asarray(a) for a in args])
    got = tdb.dag_block_reference(int(args[0][0]), *[torch.from_numpy(a) for a in args[1:]],
                                  residuals=True)
    assert len(got) == len(want) == 6
    for name, g, w in zip(["h1", "V0w", "V1w", "Kw", "hpc", "xpp"], got, want):
        _close(g.numpy(), np.asarray(w), name)


def test_backward_wrapper_cpu_route_matches_jax_vjp():
    """dag_block_backward called directly on CPU tensors (the plain version,
    given K3's residuals and the cotangents) ≡ the JAX kernels' VJP."""
    args = _inputs(4)
    cts = _cotangents(12, False)
    t = [torch.from_numpy(a.copy()) for a in args[1:]]
    outs = tdb.dag_block_reference(0, *t, residuals=True)
    tdb.reset_launches()
    got = tdb.dag_block_backward(0, *t, *outs, *[torch.from_numpy(c) for c in cts])
    assert tdb.launches["dag_block_bwd"] == 0
    names = [n for n in NAMES if n not in MASKS]
    want = [w for n, w in zip(NAMES, _jax_grads(args, cts)) if n not in MASKS]
    assert len(got) == len(want) == 14
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        _close(g.numpy(), w, name)


def test_grad_refuses_out_views_and_bad_cotangents():
    args = [torch.from_numpy(a.copy()) for a in _inputs(5)[1:]]
    args[3].requires_grad_(True)
    bufs = (torch.zeros(B, C, D), torch.zeros(B, C, D), torch.zeros(B, C, D), torch.zeros(B, C))
    with torch.enable_grad(), pytest.raises(ValueError, match="out="):
        tdb.dag_block(0, *args, out=bufs)
    with torch.no_grad():
        outs = tdb.dag_block_reference(0, *args, residuals=True)
        cts = [torch.zeros_like(o) for o in outs[:4]]
        with pytest.raises(ValueError, match="dKw"):
            tdb.dag_block_backward(0, *args, *outs, *cts[:3], torch.zeros(B, C + 1))


# ------------------------------------------------------------------ K4's plan
BWD_PLANS = [  # (B, C, D, n_max) -> (variant, rows, n)
    ((16, 16, 300, 7), ("cluster", 3, 6)),  # DAG-ERC training: one wave of 6 clusters on a card that holds 7
    ((32, 16, 300, 7), ("cluster", 3, 11)),  # 5 rows do not fit: 3 rows a cluster, more clusters than the card holds
    ((16, 64, 300, 7), ("cluster", 1, 16)),  # --dag_chunk=64: one row's buffers still fit
    ((3, 5, 13, 8), ("cluster", 1, 3)),  # ragged: 4 columns a block, ranks 4-15 own none
    ((2, 16, 512, 7), ("stream", 1, 2)),  # rows of 32 columns do not fit a cluster, 2 rows not a block
    ((5, 4, 400, 7), ("stream", 2, 3)),  # streaming, two rows a block
    ((16, 128, 300, 7), ("global", 1, 16)),  # --dag_chunk=128: the stream buffers in device memory
    ((1, 128, 300, 7), ("global", 1, 1)),  # fits neither shared-memory variant (checked below)
]


@pytest.mark.parametrize("shape,want", BWD_PLANS, ids=[str(s) for s, _ in BWD_PLANS])
def test_bwd_plan(shape, want):
    B, C, D, n_max = shape
    p = tdb.bwd_plan(B, C, D, n_max)
    assert (p.variant, p.rows, p.n) == want
    assert p.rows * p.n >= B
    if p.variant == "cluster":
        assert p.cols == tdb.cluster_cols(D) and p.cols % 4 == 0 and p.cols * tdb.CLUSTER_BLOCKS >= D
        assert tdb.bwd_cluster_smem(p.rows, C, D, p.cols) <= tdb._MAX_SMEM
    else:
        assert tdb.bwd_cluster_smem(1, C, D, tdb.cluster_cols(D)) > tdb._MAX_SMEM
        fits = tdb.bwd_stream_smem(p.rows, C, D) <= tdb._MAX_SMEM
        assert fits == (p.variant == "stream")
        assert tdb.bwd_workspace(p, C, D) == (0 if fits else B * tdb.bwd_stream_smem(1, C, D) // 4)


@pytest.mark.parametrize("B,C,D,n_max", [(1, 64, 300, 0), (16, 16, 300, 0)])
def test_bwd_plan_refuses_what_fits_neither_variant(B, C, D, n_max):
    """A card that holds no cluster has no plan where the cluster variant
    fits (the error names its shared memory); every other shape has one, the
    global variant at the latest."""
    with pytest.raises(ValueError, match="shared memory") as err:
        tdb.bwd_plan(B, C, D, n_max)
    assert str(tdb.bwd_cluster_smem(1, C, D, tdb.cluster_cols(D))) in str(err.value)


@pytest.mark.parametrize("D", [13, 300, 512, 2000])
def test_bwd_plan_takes_every_block_k3_takes(D):
    """For every C up to 256 at which K3 has a plan, K4 has one too."""
    for C in range(1, 257):
        try:
            tdb.plan(16, C, D, 7)
        except ValueError:
            continue
        assert tdb.bwd_plan(16, C, D, 7).rows >= 1
