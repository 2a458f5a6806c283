"""The graph families' bfloat16 train steps ≡ the JAX package's, on the CPU:
COGMEN (dense graph), DialogueGCN (dense graph) and MMGCN (both adjacency
forms), one step each from the same weights and batch, held by
``test_torch_precision.assert_bf16_step_matches`` (loss within 2e-2
relative; each gradient within 5e-2 of its norm beyond the JAX step's own
bfloat16 error for it, floored at 1e-3 of the global norm).  The banded
forms of COGMEN and DialogueGCN do not train in bfloat16 in either package
(``test_torch_precision.py``)."""

import pytest

from test_torch_precision import FAMILIES, assert_bf16_step_matches, no_flax_dropout  # noqa: F401 (a fixture)
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)


@pytest.mark.parametrize("name", ["cogmen", "dgcn", "mmgcn-dense", "mmgcn-structured"])
def test_bf16_step_matches_jax(name, no_flax_dropout):
    assert_bf16_step_matches(FAMILIES[name])
