"""Port's K3 plain version (erc_tpu_torch.ops.kernels.dag_block), GRU cells
and DAG graphs ≡ the JAX package's.

K3: ``dag_block_reference`` and the wrapper's CPU route against the JAX
``_fwd_body`` and the Pallas kernel in interpret mode, on the three input
cases of tests/test_pallas_dag_block.py (prefix, first block, masked tail);
tolerance 1e-5 (float32, summation order only).  Graphs match exactly.  K4
and the gradients are in tests/test_torch_dag_block_bwd.py.  K3's launch
plan (``plan``: variant, rows, clusters) is pure Python and tested here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu.ops import graphs as jgraphs
from erc_tpu.ops import rnn as jrnn
from erc_tpu.ops.pallas import dag_block as dbk
from erc_tpu_torch.ops import graphs as tgraphs
from erc_tpu_torch.ops import rnn as trnn
from erc_tpu_torch.ops.kernels import dag_block as tdb

ATOL = 1e-5
B, C, D = 3, 4, 8
NAMES = ["h1", "V0w", "V1w", "Kw"]

torch.set_grad_enabled(False)


def _inputs(seed=0, with_prefix=True, all_masked_tail=False, B=B, C=C, D=D):
    """The input cases of tests/test_pallas_dag_block.py, as numpy arrays."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    adj = (r.random((B, C, C)) < 0.6) & (np.tril(np.ones((C, C)), -1) > 0)
    for c in range(1, C):
        adj[:, c, c - 1] = True
    if all_masked_tail:
        adj[:, -1, :] = False
    amw = (-(1.0 - adj.astype(f32)) * 1e30).astype(f32)
    smw = (r.random((B, C, C)) < 0.5).astype(f32)
    qb = r.normal(size=(B, C)).astype(f32)
    xcb = r.normal(size=(B, C, 3, D)).astype(f32)
    hppb = r.normal(size=(B, C, 3, D)).astype(f32)
    hb = r.normal(size=(B, C, D)).astype(f32)
    if with_prefix:
        num01 = r.normal(size=(B, C, D)).astype(f32)
        den_p = (r.random((B, C)) + 0.5).astype(f32)
        mp = r.normal(size=(B, C)).astype(f32)
    else:
        num01 = np.zeros((B, C, D), f32)
        den_p = np.zeros((B, C), f32)
        mp = np.full((B, C), np.finfo(f32).min / 2, f32)
    weights = [(r.normal(size=s) * sc).astype(f32) for s, sc in (
        ((3, D, D), 0.3), ((3, D), 0.1), ((3, D, D), 0.3), ((3, D), 0.1),
        ((D, D), 0.3), ((D, D), 0.3), ((D, 1), 0.3))]
    flag = np.array([0 if with_prefix else 1], np.int32)
    return [flag, qb, xcb, hppb, hb, num01, den_p, mp, amw, smw, *weights]


CASES = [(True, False), (False, False), (True, True)]
IDS = ["prefix", "first-block", "masked-tail"]


def _torch(args):
    return [torch.from_numpy(a.copy()) for a in args]


def _close(got, want, atol=ATOL):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("with_prefix,tail", CASES, ids=IDS)
def test_reference_matches_jax_fwd_body(with_prefix, tail):
    args = _inputs(0, with_prefix, tail)
    with jax.default_matmul_precision("highest"):
        want = dbk._fwd_body(*[jnp.asarray(a) for a in args])
    _close(tdb.dag_block_reference(*_torch(args)), want)


@pytest.mark.parametrize("with_prefix,tail", CASES, ids=IDS)
def test_cpu_route_matches_jax_kernel_interpret(with_prefix, tail):
    args = _inputs(0, with_prefix, tail)
    with jax.default_matmul_precision("highest"):
        want = dbk.dag_block(*[jnp.asarray(a) for a in args])
    tdb.reset_launches()
    _close(tdb.dag_block(*_torch(args)), want)
    assert tdb.launches["dag_block"] == 0  # CPU tensors take the plain version


def test_cpu_route_writes_strided_out_views():
    """out= as the model passes it: position slices of [B, L, D] buffers."""
    args = _torch(_inputs(1))
    L, s = 3 * C, C
    bufs = (torch.zeros(B, L, D), torch.zeros(B, L, D), torch.zeros(B, L, D), torch.zeros(B, L))
    views = tuple(b[:, s : s + C] for b in bufs)
    tdb.dag_block(*args, out=views)
    for name, b, w in zip(NAMES, bufs, tdb.dag_block_reference(*args)):
        assert torch.equal(b[:, s : s + C], w), name
        assert not b[:, :s].any() and not b[:, s + C :].any(), name


def test_wrapper_refuses_grad_and_bad_shapes():
    """With grad the wrapper takes the autograd Function (K3 forward, K4
    backward; here their plain versions) and refuses ``out=``."""
    args = _torch(_inputs(2))
    args[4].requires_grad_(True)  # hb
    with torch.enable_grad():
        got = tdb.dag_block(*args)
        assert got[0].grad_fn is not None
        with pytest.raises(ValueError, match="out="):
            tdb.dag_block(*args, out=tuple(torch.empty_like(g) for g in got))
        got[0].sum().backward()
    assert args[4].grad is not None and torch.isfinite(args[4].grad).all()
    _close(got, tdb.dag_block(*args))  # grad mode off: the same forward, no graph
    args[4].requires_grad_(False)
    with pytest.raises(ValueError, match="wkc"):
        tdb.dag_block(*args[:-1], torch.zeros(D, 2))
    with pytest.raises(ValueError, match="xcb"):
        tdb.dag_block(args[0], args[1], args[2][:, :, :2], *args[3:])


def test_flag_gates_position_zero_only():
    args = _torch(_inputs(3))  # a prefix, so M at position 0 is not 0 by itself
    on = tdb.dag_block_reference(torch.tensor([1], dtype=torch.int32), *args[1:])
    off = tdb.dag_block_reference(0, *args[1:])
    assert not torch.equal(on[0][:, 0], off[0][:, 0])
    with jax.default_matmul_precision("highest"):
        want = dbk._fwd_body(jnp.asarray([1], jnp.int32), *[jnp.asarray(a.numpy()) for a in args[1:]])
    _close(on, want)


# ------------------------------------------------------------------ K3's plan
PLANS = [  # (B, C, D, n_max) -> (variant, rows, n)
    ((32, 16, 300, 8), ("cluster", 4, 8)),  # DAG-ERC serving on 8 clusters of 16 blocks
    ((16, 16, 300, 8), ("cluster", 2, 8)),  # DAG-ERC training
    ((32, 16, 300, 7), ("cluster", 5, 7)),  # a card that holds 7 clusters
    ((1, 128, 300, 8), ("cluster", 1, 1)),  # the longest block: one row's slices still fit
    ((13, 16, 300, 8), ("cluster", 2, 7)),  # B not a multiple of R
    ((3, 5, 13, 8), ("cluster", 1, 3)),  # D < 16: 4 columns a block, ranks 4-15 own none
    ((64, 16, 300, 4), ("cluster", 6, 11)),  # 16 rows do not fit: 6 rows, more clusters than the card holds
    ((2, 16, 512, 8), ("stream", 2, 1)),  # a slice of 32 columns does not fit
    ((3, 64, 400, 8), ("stream", 1, 3)),  # streaming, one row a block
]


@pytest.mark.parametrize("shape,want", PLANS, ids=[str(s) for s, _ in PLANS])
def test_plan(shape, want):
    B, C, D, n_max = shape
    p = tdb.plan(B, C, D, n_max)
    assert (p.variant, p.rows, p.n) == want
    assert p.rows * p.n >= B
    if p.variant == "cluster":
        assert p.cols == tdb.cluster_cols(D) and tdb.cluster_smem(p.rows, C, D, p.cols) <= tdb._MAX_SMEM
        assert p.cols * tdb.CLUSTER_BLOCKS >= D
    else:
        assert tdb.stream_smem(p.rows, C, D) <= tdb._MAX_SMEM


@pytest.mark.parametrize("B,C,D,n_max", [(1, 256, 300, 8), (1, 128, 512, 8), (2, 16, 300, 0)])
def test_plan_refuses_what_fits_neither_variant(B, C, D, n_max):
    """C = 256 at D = 300 and C = 128 at D = 512 fit neither variant's shared
    memory; a card that holds no cluster has no plan at D = 300."""
    with pytest.raises(ValueError, match="shared memory"):
        tdb.plan(B, C, D, n_max)


# ------------------------------------------------------------------ GRU cells
def test_gru_cells_match_jax():
    r = np.random.default_rng(4)
    H, Bx = 6, 5
    x_proj, h_proj = (r.normal(size=(Bx, 3 * H)).astype(np.float32) for _ in range(2))
    h = r.normal(size=(Bx, H)).astype(np.float32)
    w_hh = r.normal(size=(3 * H, H)).astype(np.float32)
    b_hh = r.normal(size=(3 * H,)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        want = jrnn.gru_cell(jnp.asarray(x_proj), jnp.asarray(h), jnp.asarray(w_hh), jnp.asarray(b_hh))
        want_p = jrnn.gru_cell_proj(jnp.asarray(x_proj), jnp.asarray(h_proj), jnp.asarray(h))
    np.testing.assert_allclose(trnn.gru_cell(t(x_proj), t(h), t(w_hh), t(b_hh)).numpy(),
                               np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(trnn.gru_cell_proj(t(x_proj), t(h_proj), t(h)).numpy(),
                               np.asarray(want_p), rtol=0, atol=ATOL)
    # torch's own GRUCell agrees on the gate order r, z, n
    cell = torch.nn.GRUCell(H, H)
    xx = torch.from_numpy(r.normal(size=(Bx, H)).astype(np.float32))
    got = trnn.gru_cell(xx @ cell.weight_ih.T + cell.bias_ih, t(h), cell.weight_hh, cell.bias_hh)
    torch.testing.assert_close(got, cell(xx, t(h)), rtol=0, atol=ATOL)


# ------------------------------------------------------------------ DAG graphs
@pytest.mark.parametrize("windowp", [1, 2])
def test_dag_graphs_match_jax_exactly(windowp):
    r = np.random.default_rng(5 + windowp)
    L = 11
    speakers = r.integers(0, 3, (4, L)).astype(np.int32)
    lengths = np.asarray([11, 6, 1, 0], np.int32)
    want = np.asarray(jgraphs.dag_adjacency(jnp.asarray(speakers), jnp.asarray(lengths), L, windowp))
    got = tgraphs.dag_adjacency(torch.from_numpy(speakers), torch.from_numpy(lengths), L, windowp)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tgraphs.same_speaker_mask(torch.from_numpy(speakers)).numpy(),
        np.asarray(jgraphs.same_speaker_mask(jnp.asarray(speakers))),
    )
