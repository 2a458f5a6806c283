"""The recurrent families' bfloat16 train steps ≡ the JAX package's, on the
CPU: DAG-ERC (its eager form, which ``dag_impl=auto`` trains), DialogueGCN v2
with the biLSTM and biGRU bases, and its DailyDialog token track, one step
each from the same weights and batch, held by
``test_torch_precision.assert_bf16_step_matches`` (loss within 2e-2
relative; each gradient within 5e-2 of its norm beyond the JAX step's own
bfloat16 error for it, floored at 1e-3 of the global norm).  DAG-ERC's
kernel form and DialogueGCN v2's DialogueRNN base do not train in bfloat16
in either package (``test_torch_precision.py``)."""

import pytest

from test_torch_precision import FAMILIES, assert_bf16_step_matches, no_flax_dropout  # noqa: F401 (a fixture)


@pytest.mark.parametrize("name", ["dagerc", "dgcnv2-LSTM", "dgcnv2-GRU", "dgcnv2_daily"])
def test_bf16_step_matches_jax(name, no_flax_dropout):
    assert_bf16_step_matches(FAMILIES[name])
