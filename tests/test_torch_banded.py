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
]
IDS = ["full", "neg", "pos", "L<K", "L13-gapped"]


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


def test_band_offsets_match_jax():
    for wp, wf in ((5, 5), (10, 10), (3, 1), (0, 2)):
        assert tbanded.band_offsets(wp, wf) == jbanded.band_offsets(wp, wf)


def test_cpu_tensors_do_not_count_launches():
    tbanded.reset_launches()
    coef, src, other = _inputs(2, 16, 8, 11)
    tbanded.banded_gather_sum(torch.from_numpy(coef), torch.from_numpy(src), range(-5, 6))
    tbanded.banded_dot(torch.from_numpy(src), torch.from_numpy(other), range(-5, 6))
    assert tbanded.launches == {"banded_gather_sum": 0, "banded_dot": 0}


def test_wrapper_rejects_shape_mismatch():
    with pytest.raises(ValueError):
        tbanded.banded_gather_sum(torch.zeros(2, 8, 2), torch.zeros(2, 8, 4), range(-1, 2))
    with pytest.raises(ValueError):
        tbanded.banded_dot(torch.zeros(2, 8, 4), torch.zeros(2, 9, 4), range(-1, 2))
