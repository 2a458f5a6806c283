"""FLOPs and parameter summaries of the port ≡ the JAX package's, on the CPU.

- ``core.flops.step_flops`` of one train step (forward and backward) of
  COGMEN (dense graph, chained encoder), MMGCN (dense, 4 GCNII layers in
  trips of 2 under ``gcn_remat=full``, so the scan's trip count and the
  recompute count) and DialogueGCN v2 with its biLSTM, at the small settings
  of ``test_torch_precision.py``, within 1 % of the JAX package's
  ``mxu_flops`` of the same step (the RNN counted, not 0).
- Recurrent layers are counted by formula at the rows the model needs: the
  same whether they run fused (oneDNN's LSTM here, cuDNN on the card) or
  decomposed, and once for the masked form's doubled rows.
- A step through the band kernels (COGMEN's ``graph_impl=banded``) is
  counted with ``lower_bound: True`` and without the kernels' work.
- ``core.summary.param_summary``: the total parameters and bytes of every
  family's model equal the JAX ``param_summary`` totals of its params tree.
"""

import types

import jax
import numpy as np
import pytest
import torch

from erc_tpu.core.flops import mxu_flops
from erc_tpu.core.summary import param_summary as jax_param_summary
from erc_tpu_torch.core import flops
from erc_tpu_torch.core.summary import param_summary
from erc_tpu_torch.data.loader import to_device
from test_torch_precision import FAMILIES, host_batch, jax_trainer, port_trainer
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

FLOP_RTOL = 1e-2
CASES = {
    "cogmen": types.SimpleNamespace(**{**vars(FAMILIES["cogmen"]),
                                       "argv": [*FAMILIES["cogmen"].argv, "--encoder_mode=chained"]}),
    "mmgcn-dense": FAMILIES["mmgcn-dense"],
    "dgcnv2-LSTM": FAMILIES["dgcnv2-LSTM"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_step_flops_match_mxu_flops(name):
    fam = CASES[name]
    trainer = port_trainer(fam)
    batch = host_batch(trainer)
    jtr, params, model_state = jax_trainer(fam, batch)

    def loss(p):
        return jtr.loss_and_metrics({"params": p, **model_state}, batch, jax.random.PRNGKey(3), train=True)[0]

    want = mxu_flops(jax.grad(loss), params)
    got = flops.step_flops(trainer.compute_grads, to_device(batch, trainer.device))
    print(f"{name}: step_flops {got['flops']:.6g}, mxu_flops {want['flops']:.6g}, "
          f"gap {got['flops'] / want['flops'] - 1:+.3%}")
    assert not got["lower_bound"] and not want["lower_bound"]
    assert got["flops"] == pytest.approx(want["flops"], rel=FLOP_RTOL)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_recurrent_layers_counted_alike_on_every_backend(cell):
    """A BiRNN step counts the same whether its layers run as one fused call
    (the CPU's oneDNN LSTM, cuDNN on the card: no formula in the counter) or
    decomposed into products (oneDNN off); the masked form's doubled rows
    count once, and the formula adds the input's gradient only where the
    input requires it."""
    from erc_tpu_torch.ops.rnn import BiRNN

    rnn = BiRNN(5, 7, num_layers=2, cell=cell)
    x, mask = torch.randn(3, 6, 5), torch.ones(3, 6)

    def step(*a):
        with torch.enable_grad():  # other test files turn grad mode off at import
            rnn(*a).sum().backward()

    counts = []
    for fused in (True, False):
        with torch.backends.mkldnn.flags(enabled=fused):
            counts.append(flops.step_flops(step, x, mask)["flops"])
    layer = rnn.layers[0]
    want = flops.rnn_flops(layer, 3, 6, False) + flops.rnn_flops(rnn.layers[1], 3, 6, True)
    assert counts == [want, want]
    assert flops.step_flops(step, x)["flops"] == want  # every step, no mask: B rows as well
    assert flops.rnn_flops(layer, 3, 6, True) - flops.rnn_flops(layer, 3, 6, False) == 2 * 2 * 18 * 5 * (
        4 if cell == "lstm" else 3) * 7


def test_step_through_the_band_kernels_is_a_lower_bound():
    dense = port_trainer(FAMILIES["cogmen"])
    banded = port_trainer(FAMILIES["cogmen"], "--graph_impl=banded")
    banded.model.load_state_dict(dense.model.state_dict())
    batch = to_device(host_batch(dense), dense.device)
    d = flops.step_flops(dense.compute_grads, batch)
    b = flops.step_flops(banded.compute_grads, batch)
    assert b["lower_bound"] and not d["lower_bound"] and 0 < b["flops"] < d["flops"]
    # the kernel wrappers are themselves again after the count
    from erc_tpu_torch.ops.kernels import banded as kb

    assert kb._gather.__name__ == "_gather" and kb._dot.__name__ == "_dot"


@pytest.mark.parametrize("name", list(FAMILIES))
def test_param_summary_totals_match_jax(name):
    fam = FAMILIES[name]
    trainer = port_trainer(fam)
    _, params, _ = jax_trainer(fam, host_batch(trainer))
    rows, jrows = param_summary(trainer.model), jax_param_summary(params)
    assert sum(r["n_params"] for r in rows) == sum(r["n_params"] for r in jrows)
    assert sum(r["bytes"] for r in rows) == sum(r["bytes"] for r in jrows)
    assert np.all([r["n_params"] > 0 for r in rows])
