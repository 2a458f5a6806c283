"""Port's plain K1/K2 (erc_tpu_torch.ops.kernels.banded) ≡ the JAX package's
Pallas band kernels (run in interpret mode on the CPU).

Tolerance 1e-5 absolute: float32, only the summation order differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erc_tpu.ops.pallas import banded as jbanded
from erc_tpu_torch.ops.kernels import banded as tbanded

ATOL = 1e-5

CASES = [
    # (B, L, D, offsets)
    (2, 24, 12, tuple(range(-5, 6))),  # COGMEN's full band
    (2, 24, 12, tuple(range(-5, 0))),  # RGCN backward sub-range
    (2, 24, 12, tuple(range(0, 6))),  # RGCN forward sub-range
    (1, 7, 13, tuple(range(-10, 11))),  # L < K
    (3, 13, 5, (-3, -1, 0, 2)),  # L not a multiple of 8, gapped taps
    (2, 1, 12, (-1, 0, 1)),  # L = 1: only the centre tap is in range
    (2, 9, 12, (2,)),  # K = 1, off the diagonal
    (1, 40, 8, tuple(range(-32, 32))),  # K = 64, the kernel's limit
]
IDS = ["full", "neg", "pos", "L<K", "L13-gapped", "L1", "K1", "K64"]


def _inputs(B, L, D, K, seed=0):
    rng = np.random.default_rng(seed)
    coef = rng.normal(size=(B, L, K)).astype(np.float32)
    src = rng.normal(size=(B, L, D)).astype(np.float32)
    other = rng.normal(size=(B, L, D)).astype(np.float32)
    return coef, src, other


@pytest.mark.parametrize("B,L,D,offsets", CASES, ids=IDS)
def test_gather_sum_matches_jax(B, L, D, offsets):
    coef, src, _ = _inputs(B, L, D, len(offsets))
    want = np.asarray(jbanded.banded_gather_sum(jnp.asarray(coef), jnp.asarray(src), offsets))
    got = tbanded.banded_gather_sum(torch.from_numpy(coef), torch.from_numpy(src), offsets)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("B,L,D,offsets", CASES, ids=IDS)
def test_dot_matches_jax(B, L, D, offsets):
    _, a, b = _inputs(B, L, D, len(offsets), seed=1)
    want = np.asarray(jbanded.banded_dot(jnp.asarray(a), jnp.asarray(b), offsets))
    got = tbanded.banded_dot(torch.from_numpy(a), torch.from_numpy(b), offsets)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_gather_sum_strided_src_matches_jax():
    """src as the model passes it: Ysel[:, :, s, t, :], a non-contiguous view."""
    B, L, S, D = 2, 19, 2, 7
    offsets = tuple(range(0, 6))
    rng = np.random.default_rng(2)
    ysel = rng.normal(size=(B, L, S, 2, D)).astype(np.float32)
    coef = rng.normal(size=(B, L, len(offsets))).astype(np.float32)
    view = torch.from_numpy(ysel)[:, :, 1, 0, :]
    assert not view.is_contiguous()
    want = np.asarray(jbanded.banded_gather_sum(jnp.asarray(coef), jnp.asarray(ysel[:, :, 1, 0, :]), offsets))
    got = tbanded.banded_gather_sum(torch.from_numpy(coef), view, offsets)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("D", [99, 100])
def test_strided_views_match_jax(D):
    """Both kernels on [B, L, 2, 2, D] views, D = 100 as COGMEN gives them (the
    16-byte instantiation on the card) and D = 99 (the 4-byte one)."""
    B, L = 2, 17
    rng = np.random.default_rng(D)
    ysel = rng.normal(size=(B, L, 2, 2, D)).astype(np.float32)
    view = torch.from_numpy(ysel)
    for offsets in (tuple(range(-5, 0)), tuple(range(0, 6)), tuple(range(-5, 6))):
        coef = rng.normal(size=(B, L, len(offsets))).astype(np.float32)
        for s, t in ((0, 1), (1, 0)):
            src = ysel[:, :, s, t, :]
            want = np.asarray(jbanded.banded_gather_sum(jnp.asarray(coef), jnp.asarray(src), offsets))
            got = tbanded.banded_gather_sum(torch.from_numpy(coef), view[:, :, s, t, :], offsets)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        want = np.asarray(jbanded.banded_dot(jnp.asarray(ysel[:, :, 0, 0, :]), jnp.asarray(ysel[:, :, 1, 1, :]),
                                             offsets))
        got = tbanded.banded_dot(view[:, :, 0, 0, :], view[:, :, 1, 1, :], offsets)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("s,t", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_vec4_taken_for_cogmen_ysel_views(s, t):
    """The RGCN's Ysel[:, :, s, t, :] views of [B, L, 2, 2, 100]: rows 400
    floats apart, bases 0/100/200/300 floats in, so 16-byte loads."""
    ysel = torch.zeros(32, 112, 2, 2, 100)
    view = ysel[:, :, s, t, :]
    assert not view.is_contiguous() and view.stride() == (44800, 400, 1)
    assert tbanded.vec4_ok(100, view)
    assert tbanded.vec4_ok(100, view, torch.zeros(32, 112, 100))  # with K2's contiguous q/k


VEC4_REFUSED = {
    "D13": lambda: torch.zeros(2, 7, 13),
    "D99-view": lambda: torch.zeros(2, 7, 100)[:, :, 1:],
    "offset-one-float": lambda: torch.zeros(2, 7, 104)[:, :, 1:101],
    "row-stride-101": lambda: torch.zeros(2, 7, 101)[:, :, :100],
    "batch-stride-701": lambda: torch.zeros(1401).as_strided((2, 7, 100), (701, 100, 1)),
}


@pytest.mark.parametrize("name", list(VEC4_REFUSED))
def test_vec4_refused_where_layout_forbids(name):
    t = VEC4_REFUSED[name]()
    D = t.shape[-1]
    assert not tbanded.vec4_ok(D, t)
    assert not tbanded.vec4_ok(D, torch.zeros(2, 7, D), t)  # one refused tensor is enough


def test_vec4_ignores_strides_of_unit_dims():
    one_row = torch.zeros(312).as_strided((3, 1, 100), (104, 7, 1))
    one_batch = torch.zeros(500).as_strided((1, 5, 100), (3, 100, 1))
    assert tbanded.vec4_ok(100, one_row) and tbanded.vec4_ok(100, one_batch)


def test_launch_args_cached_per_offsets():
    band = tbanded.launch_args(tuple(range(-5, 6)))
    for same in (list(range(-5, 6)), range(-5, 6), np.arange(-5, 6)):
        assert tbanded.launch_args(same) is band
    assert band.offsets == tuple(range(-5, 6)) and band.K == 11
    assert all(type(o) is int for o in band.offsets)
    assert list(band.c_offsets) == list(range(-5, 6))
    assert tbanded.launch_args((0, 2)) is not band


def test_band_offsets_match_jax():
    for wp, wf in ((5, 5), (10, 10), (3, 1), (0, 2)):
        assert tbanded.band_offsets(wp, wf) == jbanded.band_offsets(wp, wf)


def test_cpu_tensors_do_not_count_launches():
    tbanded.reset_launches()
    coef, src, other = _inputs(2, 16, 8, 11)
    tbanded.banded_gather_sum(torch.from_numpy(coef), torch.from_numpy(src), range(-5, 6))
    tbanded.banded_dot(torch.from_numpy(src), torch.from_numpy(other), range(-5, 6))
    assert tbanded.launches == {"banded_gather_sum": 0, "banded_dot": 0, "banded_gather_sum_t": 0}
    assert set(tbanded.variant_launches.values()) == {0}


def test_wrapper_rejects_shape_mismatch():
    with pytest.raises(ValueError):
        tbanded.banded_gather_sum(torch.zeros(2, 8, 2), torch.zeros(2, 8, 4), range(-1, 2))
    with pytest.raises(ValueError):
        tbanded.banded_dot(torch.zeros(2, 8, 4), torch.zeros(2, 9, 4), range(-1, 2))
