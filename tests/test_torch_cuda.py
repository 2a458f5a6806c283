"""The port's CUDA kernels and serving path on the card.

Marked ``cuda``: each test skips where no CUDA device is present.  On a GPU
machine (no JAX needed there, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

K1/K2 tolerance 1e-5 absolute (float32, only the summation order differs
from the plain version); K3 1e-4, since its recurrence compounds the
summation order over up to C positions; banded vs dense and kernel vs eager
logits 1e-4.
"""

import numpy as np
import pytest
import torch

from erc_tpu_torch.ops.kernels import banded as kb

pytestmark = pytest.mark.cuda

CASES = [
    (4, 112, 100, tuple(range(-5, 6))),
    (4, 112, 100, tuple(range(-5, 0))),
    (4, 112, 100, tuple(range(0, 6))),
    (2, 7, 13, tuple(range(-10, 11))),
    (3, 13, 200, (-3, -1, 0, 2)),  # two column tiles in K1
    (1, 1, 1, (0,)),
    (2, 5, 257, (-7, 0, 9)),  # taps past both ends; a 1-wide last column tile
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _randn(g, *shape):
    return torch.randn(*shape, generator=g, device="cuda")


@pytest.mark.parametrize("B,L,D,offsets", CASES)
def test_kernels_match_plain_versions(cuda, B, L, D, offsets):
    g = torch.Generator(device=cuda).manual_seed(0)
    K = len(offsets)
    coef, a, b = _randn(g, B, L, K), _randn(g, B, L, D), _randn(g, B, L, D)
    ysel = _randn(g, B, L, 2, 2, D)
    coef_view = _randn(g, B, L, K + 3)[:, :, 2 : 2 + K]  # strided rows, unit last stride
    for c, src in ((coef, a), (coef, ysel[:, :, 1, 0, :]), (coef_view, a)):
        got = kb.banded_gather_sum(c, src, offsets)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, kb.banded_gather_sum_reference(c, src, offsets),
                                   rtol=0, atol=1e-5)
    got = kb.banded_dot(a, b, offsets)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kb.banded_dot_reference(a, b, offsets), rtol=0, atol=1e-5)


def test_kernels_reject_other_dtypes(cuda):
    x = torch.zeros(1, 4, 3, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        kb.banded_dot(x, x, (0,))


def test_engine_banded_equals_dense_and_counts_launches(cuda):
    from erc_tpu_torch.data.synthetic import synthetic_erc
    from erc_tpu_torch.serve import InferenceEngine

    kw = dict(dataset="synthetic-cogmen-6", encoder_mode="chained", batch_size=4)
    banded = InferenceEngine.from_module("cogmen", graph_impl="banded", **kw)
    dense = InferenceEngine.from_module("cogmen", graph_impl="dense", **kw)
    dense.model.load_state_dict(banded.model.state_dict())
    batch = banded.batcher(synthetic_erc("iemocap-cogmen", 6, n_train=4, max_len=40))
    kb.reset_launches()
    got = banded.logits(batch)
    assert kb.launches == {"banded_gather_sum": 5, "banded_dot": 1}
    np.testing.assert_allclose(got, dense.logits(batch), rtol=0, atol=1e-4)


# ------------------------------------------------------------------ K3 dag_block
def _dag_inputs(g, B, C, D, prefix=True, pad_rows=0):
    """K3's arguments as DAGStack builds them: a causal within-block mask in
    which i-1 always precedes i, additive -1e30 masks, float32-min columns
    past the dialogue, and `pad_rows` trailing positions with no predecessor
    (padding); batch row 0 is an all-padding dialogue."""
    f32min = torch.finfo(torch.float32).min
    adj = (torch.rand(B, C, C, generator=g, device="cuda") < 0.6).float().tril(-1)
    adj[:, torch.arange(1, C), torch.arange(C - 1)] = 1.0
    adj[0] = 0.0
    colpad = torch.zeros(C, device="cuda")
    if pad_rows:
        adj[:, C - pad_rows :] = 0.0
        colpad[C - pad_rows :] = f32min
    amw = -(1.0 - adj) * 1e30 + colpad
    smw = (torch.rand(B, C, C, generator=g, device="cuda") < 0.5).float()
    r = lambda *s, scale=1.0: _randn(g, *s) * scale  # noqa: E731
    if prefix:
        num01, den_p, mp = r(B, C, D), torch.rand(B, C, generator=g, device="cuda") + 0.5, r(B, C)
    else:
        num01 = torch.zeros(B, C, D, device="cuda")
        den_p = torch.zeros(B, C, device="cuda")
        mp = torch.full((B, C), f32min / 2, device="cuda")
    s = 1.0 / D**0.5
    weights = (r(3, D, D, scale=s), r(3, D, scale=s), r(3, D, D, scale=s), r(3, D, scale=s),
               r(D, D, scale=s), r(D, D, scale=s), r(D, 1, scale=s))
    flag = 0 if prefix else 1
    return (flag, r(B, C), r(B, C, 3, D), r(B, C, 3, D), r(B, C, D), num01, den_p, mp, amw, smw,
            *weights)


K3_CASES = [  # (B, C, D, prefix, pad_rows)
    (32, 16, 300, True, 0),  # DAG-ERC's serving shape, a later block
    (32, 16, 300, False, 0),  # the first block: flag, no prefix
    (32, 16, 300, True, 5),  # a last block whose tail is padding
    (3, 5, 13, True, 2),  # ragged: C, D not multiples of 32 or 4
    (2, 1, 7, False, 0),  # C = 1
    (5, 40, 33, True, 3),  # C > 32: more columns than lanes
    (3, 64, 300, True, 0),  # two rows' buffers do not fit in shared memory: one row per block
]


@pytest.mark.parametrize("B,C,D,prefix,pad_rows", K3_CASES)
def test_dag_block_matches_plain_version(cuda, B, C, D, prefix, pad_rows):
    from erc_tpu_torch.ops.kernels import dag_block as kd

    g = torch.Generator(device=cuda).manual_seed(B * 100 + C)
    args = _dag_inputs(g, B, C, D, prefix, pad_rows)
    kd.reset_launches()
    got = kd.dag_block(*args)
    torch.cuda.synchronize()
    assert kd.launches["dag_block"] == 1
    for name, a, b in zip(("h1", "V0w", "V1w", "Kw"), got, kd.dag_block_reference(*args)):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4, msg=name)


def test_dag_block_takes_one_row_per_block_where_two_do_not_fit(cuda):
    from erc_tpu_torch.ops.kernels import dag_block as kd

    lib = kd._library()
    assert kd._pick_rows(lib, 16, 300) == kd.ROWS_PER_BLOCK == 2  # DAG-ERC's serving shape
    assert kd._pick_rows(lib, 64, 300) == 1
    with pytest.raises(ValueError, match="shared memory"):
        kd._pick_rows(lib, 128, 300)


def test_dag_block_writes_strided_buffer_views(cuda):
    from erc_tpu_torch.ops.kernels import dag_block as kd

    g = torch.Generator(device=cuda).manual_seed(7)
    B, C, D, L, s = 4, 6, 20, 18, 6
    args = _dag_inputs(g, B, C, D)
    bufs = (torch.zeros(B, L, D, device=cuda), torch.zeros(B, L, D, device=cuda),
            torch.zeros(B, L, D, device=cuda), torch.zeros(B, L, device=cuda))
    kd.dag_block(*args, out=tuple(b[:, s : s + C] for b in bufs))
    torch.cuda.synchronize()
    for b, want in zip(bufs, kd.dag_block_reference(*args)):
        torch.testing.assert_close(b[:, s : s + C], want, rtol=0, atol=1e-4)
        assert not b[:, :s].any() and not b[:, s + C :].any()


def test_dag_block_refuses_grad_and_other_dtypes(cuda):
    from erc_tpu_torch.ops.kernels import dag_block as kd

    args = list(_dag_inputs(torch.Generator(device=cuda).manual_seed(1), 2, 3, 8))
    args[4] = args[4].requires_grad_(True)
    with torch.enable_grad(), pytest.raises(RuntimeError, match="no backward"):
        kd.dag_block(*args)
    with torch.no_grad():
        kd.dag_block(*args)  # nothing to differentiate: the kernel runs
    args[4] = args[4].detach().double()
    with pytest.raises(TypeError):
        kd.dag_block(*args)
    too_long = _dag_inputs(torch.Generator(device=cuda).manual_seed(2), 1, 128, 300)
    with pytest.raises(ValueError, match="shared memory"):
        kd.dag_block(*too_long)


def test_dagerc_engine_kernel_equals_eager_and_counts_launches(cuda):
    from erc_tpu_torch.data.synthetic import synthetic_erc
    from erc_tpu_torch.ops.kernels import dag_block as kd
    from erc_tpu_torch.serve import InferenceEngine

    kw = dict(dataset="synthetic-cogmen-6", batch_size=4)
    kernel = InferenceEngine.from_module("dagerc", **kw)  # dag_impl=auto: K3 in eval
    eager = InferenceEngine.from_module("dagerc", dag_impl="eager", **kw)
    eager.model.load_state_dict(kernel.model.state_dict())
    batch = kernel.batcher(synthetic_erc("iemocap-cogmen", 6, n_train=3, max_len=40))
    Lp = batch["input_tensor"].shape[1]
    kd.reset_launches()
    got = kernel.logits(batch)
    assert kd.launches["dag_block"] == 4 * -(-Lp // 16)
    np.testing.assert_allclose(got, eager.logits(batch), rtol=0, atol=1e-4)
    assert kd.launches["dag_block"] == 4 * -(-Lp // 16)  # the eager form launches nothing
