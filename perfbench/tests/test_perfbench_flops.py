"""The model-FLOP formula (``perfbench/work/<config>.py``) against
``FlopCounterMode`` over the plain reference at a tiny size, one dialogue
at a time (so that no padding is counted).

The formula counts what the model needs; the reference computes its graph
densely.  So the test takes the count of the reference's dense graph
products from their shapes, checks that the rest of the count is the
formula's dense part exactly, and checks the formula's graph part against
the edges of the reference's own adjacency."""


import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.core import manifest, traffic, weights


def _counted(name, m, dialogue):
    ref = manifest.reference(name)
    w = weights.make({**ref.param_specs(m), **ref.buffer_specs(m)}, 5, "cpu")
    params = {n: w[n] for n in ref.param_specs(m)}
    buffers = {n: w[n] for n in ref.buffer_specs(m)}
    b = ref.plain.batch([dialogue], m["modality"], "cpu")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(params, buffers, b, m, training=True)
    return fc.get_total_flops(), b, ref


def _dialogues(n=3, L=11):
    spec = dict(manifest.mix("lognormal-120")["corpus"], count=n, utterances=n * L, min_len=L - 2, max_len=L + 3)
    return traffic.dialogues(spec, 2**31 + 5)


@pytest.mark.parametrize("i", range(3))
def test_dagerc_formula(i):
    m = dict(manifest.config("dagerc-iemocap")["model"], hidden_dim=8, gnn_layers=2)
    d = _dialogues()[i]
    counted, b, ref = _counted("dagerc-iemocap", m, d)
    spk = traffic.speaker_ids(d)
    terms = manifest.work("dagerc-iemocap").forward_terms(spk, m)
    L, D, layers = len(spk), m["hidden_dim"], m["gnn_layers"]
    # the reference's attention: two weighted sums over every earlier position, a layer
    assert counted - layers * 2 * D * L * (L - 1) == terms["dense"]
    edges = int(ref.predecessors(b["speakers"], b["lengths"], m["windowp"]).sum())
    assert terms["graph"] == layers * 2 * D * edges


def test_training_counts_three_forwards():
    """The metric's training count is the forward and twice it, nothing for recomputation."""
    src = (manifest.HERE / "metrics" / "train_mfu_pct.py").read_text()
    assert "3 * r.forward_flops(i)" in src
