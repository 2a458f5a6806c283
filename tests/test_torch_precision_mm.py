"""CIM's and the MMIN family's bfloat16 train steps ≡ the JAX package's, on
the CPU: CIM on synthetic-mosei-2 (its multitask loss in float32) and
``mmin_base``, ``mmin_miss`` (its frozen encoder's float32 weights lift the
bfloat16 batch to float32, as in JAX) and ``mmin_miss2`` on synthetic-mmin-4
at full width, one step each from the same weights and batch, held by
``test_torch_precision.assert_bf16_step_matches`` (loss within 2e-2
relative; each gradient within 5e-2 of its norm beyond the JAX step's own
bfloat16 error for it, floored at 1e-3 of the global norm)."""

import pytest

from test_torch_precision import FAMILIES, assert_bf16_step_matches, no_flax_dropout  # noqa: F401 (a fixture)
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)


@pytest.mark.parametrize("name", ["cim", "mmin_base", "mmin_miss", "mmin_miss2"])
def test_bf16_step_matches_jax(name, no_flax_dropout):
    assert_bf16_step_matches(FAMILIES[name])
