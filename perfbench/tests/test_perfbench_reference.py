"""The plain reference against the port's CPU path at a tiny size: the
same weights (``perfbench/core/weights.py``) and dialogues, logits of every
real utterance, in the eval forward and in training mode."""

import os
import tempfile

import numpy as np
import pytest
import torch

from perfbench.core import manifest, program, traffic, weights
from perfbench.tests import tiny

CELLS = {"dagerc-iemocap": tiny.TRAIN}


@pytest.fixture(scope="module", params=sorted(CELLS))
def setup(request):
    os.environ["ERC_TPU_EXPROOT"] = tempfile.mkdtemp(prefix="perfbench-test-")
    _, _, cfg, mix = tiny.cell(*CELLS[request.param])
    ref = manifest.reference(request.param)
    m = cfg["model"]
    t = program.trainer(cfg, 11, "cpu")
    w = weights.make({**ref.param_specs(m), **ref.buffer_specs(m)}, 2**31 + 3, "cpu")
    t.model.load_state_dict(w, strict=True)
    data = traffic.dialogues(mix["corpus"], 2**31 + 3)[:5]
    return t, ref, m, w, data


@pytest.mark.parametrize("training", [False, True])
def test_reference_matches_the_port(setup, training):
    t, ref, m, w, data = setup
    from erc_tpu_torch.data.loader import to_device

    hb = t.batcher(8)(data)
    t.model.train(training)
    with torch.no_grad():
        got = t.model(to_device(hb, torch.device("cpu"))).numpy()
        params = {n: w[n] for n in ref.param_specs(m)}
        buffers = {n: w[n] for n in ref.buffer_specs(m)}
        want = ref.forward(params, buffers, ref.plain.batch(data, m["modality"], "cpu"), m, training=training).numpy()
    for i, d in enumerate(data):
        n = len(d["label"])
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=0, atol=2e-5)


def test_parameter_count(setup):
    t, ref, m, w, data = setup
    assert weights.count(ref.param_specs(m)) == sum(p.numel() for p in t.model.parameters())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_published_parameter_count(name):
    cfg = manifest.config(name)
    assert weights.count(manifest.reference(name).param_specs(cfg["model"])) == cfg["parameters"]


def test_weights_are_drawn_from_the_seed():
    ref = manifest.reference("dagerc-iemocap")
    specs = ref.param_specs(dict(manifest.config("dagerc-iemocap")["model"], hidden_dim=8, gnn_layers=1))
    a, b, c = (weights.make(specs, s, "cpu") for s in (2**31 + 1, 2**31 + 1, 2**31 + 2))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["fc1.weight"], c["fc1.weight"])
    assert float(a["fc1.weight"].abs().max()) <= (3.0 / 712) ** 0.5 and float(a["fc1.bias"].abs().max()) == 0.0


def _toy(params, buffers, batch, training=True, mm=None, relu=torch.relu):
    """One ReLU layer and a linear head, the reference forward's signature."""
    h = relu(batch["x"] @ params["w1"].T + params["b1"])
    return h @ params["w2"].T


def test_first_grads_takes_a_relu_input_at_zero_on_the_program_s_side():
    """A ReLU input within rounding of 0: the program's gradient took the
    other side there.  The plain first step misses it by that input's share;
    ``first_grads`` finds the input and takes the program's side."""
    plain = manifest.reference("dagerc-iemocap").plain
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 6, 8, generator=g)
    params = {"w1": torch.randn(4, 8, generator=g), "b1": torch.zeros(4), "w2": torch.randn(3, 4, generator=g)}
    params["b1"][1] = -float((x[0, 2] @ params["w1"][1]))  # input (position 2, unit 1) at 0 to rounding
    batch = {"x": x, "labels": torch.tensor([[0, 1, 2, 0, 1, 2]]), "mask": torch.ones(1, 6, dtype=torch.bool)}

    def other_side(z):
        keep = (z > 0).to(z.dtype)
        keep[0, 2, 1] = 1.0 - keep[0, 2, 1]
        return z * keep.detach()

    leaves = {n: p.clone().requires_grad_(True) for n, p in params.items()}
    loss = plain.masked_cross_entropy(_toy(leaves, {}, batch, relu=other_side), batch["labels"], batch["mask"])
    prog = {n: float(v.norm()) for n, v in zip(leaves, torch.autograd.grad(loss, list(leaves.values())))}
    optim = {"name": "AdamW", "lr": 1e-3, "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.0, "clip": 0.0}
    gap = lambda got: max(abs(prog[n] - got["grad_norms"][n]) / got["grad_norms"][n] for n in prog)  # noqa: E731
    assert gap(plain.train_readings(_toy, params, {}, [batch], optim)) > 1e-3
    got = plain.train_readings(_toy, params, {}, [batch], optim, target=prog)
    assert got["kinks"][1] == 1 and gap(got) < 1e-6
    # where the program took the reference's own side, nothing is changed
    same = plain.train_readings(_toy, params, {}, [batch], optim)
    again = plain.train_readings(_toy, params, {}, [batch], optim, target=same["grad_norms"])
    assert again["kinks"][0] >= 1 and again["kinks"][1] == 0 and again["grad_norms"] == same["grad_norms"]
