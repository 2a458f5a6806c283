"""The port's CUDA kernels and serving path on the card.

Marked ``cuda``: each test skips where no CUDA device is present.  On a GPU
machine (no JAX needed there, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Kernel tolerance 1e-5 absolute (float32, only the summation order differs
from the plain version); banded vs dense logits 1e-4.
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
