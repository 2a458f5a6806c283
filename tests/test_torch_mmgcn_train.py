"""The port's MMGCN training and GCNII stacks ≡ the JAX package's.

The second half of ``test_torch_mmgcn.py`` (whose docstring states the
sizes and tolerances; its helpers are imported from there):
``GCNIIStack`` and ``GCNIIStackStructured`` in the three remat modes against
JAX, and remat ``full`` / ``dots`` ≡ ``off`` with dropout 0.4 inside
checkpointed trips; remat and the two adjacency forms giving
the same gradients at dropout 0.4 from one generator seed, with no read of
the RNG state in a checkpointed trip; ``python -m erc_tpu_torch.train
--module=mmgcn --device=cpu`` for two steps that save and serve; ``main``
without CUDA raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu.ops import gnn as jgnn
from erc_tpu.ops import graphs as jgraphs
from erc_tpu_torch.data.loader import to_device
from erc_tpu_torch.models import mmgcn as tmmgcn
from erc_tpu_torch.ops import gnn as tgnn
from erc_tpu_torch.serve import InferenceEngine
from test_torch_mmgcn import (GRAD_RTOL, ROOT, SMALL, STACK_TOL, _assert_close_rel, _assert_grads_close, _feats,
                              _jax_vjp, _np_tree, _port_trainer, _t, _torch_vjp, _train_batches)
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)


STACKS = [("dense", 6, 3), ("structured", 4, 2)]  # (form, layers, chunk)
REMATS = ["off", "full", "dots"]


def _stack_inputs(form, nh=8):
    feats, valid = _feats()
    r = np.random.default_rng(5)
    if form == "dense":
        x = np.abs(r.normal(size=(3, 27, nh))).astype(np.float32)
        return x, (np.asarray(jgraphs.mmgcn_big_adjacency(feats, valid)),)
    x = np.abs(r.normal(size=(3, 3, 9, nh))).astype(np.float32)
    return x, tuple(np.asarray(a) for a in jgraphs.mmgcn_structured_adjacency(feats, valid))


@pytest.fixture(scope="module", params=[(f, n, c, m) for f, n, c in STACKS for m in REMATS],
                ids=[f"{f}-{m}" for f, _, _, in STACKS for m in REMATS])
def jax_stack_run(request):
    form, nlayers, chunk, remat = request.param
    x, adj = _stack_inputs(form)
    cls = jgnn.GCNIIStackStructured if form == "structured" else jgnn.GCNIIStack
    jm = cls(nlayers=nlayers, nhidden=8, remat=remat, chunk=chunk)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), x, *adj))["params"]
    out = _jax_vjp(lambda p, xx, *a: jm.apply({"params": p}, xx, *a), params, x, *adj)
    return request.param, x, adj, params, out


def test_gcnii_stack_matches_jax(jax_stack_run):
    (form, nlayers, chunk, remat), x, adj, params, (want, cots, grads) = jax_stack_run
    cls = tgnn.GCNIIStackStructured if form == "structured" else tgnn.GCNIIStack
    module = cls(nlayers, 8, remat=remat, chunk=chunk)
    assert module.chunk == chunk
    module.load_state_dict({"convs": torch.tensor(params["convs"])})

    def run(convs, xx, *a):
        return torch.func.functional_call(module, {"convs": convs}, (xx, *a))

    (got,), tgrads = _torch_vjp(run, cots, params["convs"], x, *adj)
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_TOL)
    _assert_close_rel(tgrads[0], grads[0]["convs"], STACK_TOL, "convs")
    for i, (t, g) in enumerate(zip(tgrads[1:], grads[1:])):
        _assert_close_rel(t, g, STACK_TOL, f"input {i}")


@pytest.mark.parametrize("form", ["dense", "structured"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_gcnii_remat_equals_off_with_dropout(form, remat):
    """Dropout 0.4 inside checkpointed trips: the masks are drawn before each
    trip, so the recompute reuses them and the generator advances as it
    does without remat."""
    x, adj = _stack_inputs(form)
    cls = tgnn.GCNIIStackStructured if form == "structured" else tgnn.GCNIIStack
    cots = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    runs = {}
    for mode in ("off", remat):
        module = cls(6, 8, dropout=0.4, remat=mode, chunk=3, generator=torch.Generator().manual_seed(0))
        module.dropout.generator = gen = torch.Generator().manual_seed(11)
        module.train()
        (out,), grads = _torch_vjp(module, [cots], x, *adj)
        runs[mode] = (out, grads, module.convs.grad, gen.get_state())
    (o0, g0, c0, s0), (o1, g1, c1, s1) = runs["off"], runs[remat]
    np.testing.assert_array_equal(o1, o0)
    assert torch.equal(s1, s0)  # no draw in the recompute
    for a, b in zip(g1, g0):
        _assert_close_rel(a, b, 1e-6, "input")
    _assert_close_rel(c1.numpy(), c0.numpy(), 1e-6, "convs")
    plain = cls(6, 8, remat="off", chunk=3, generator=torch.Generator().manual_seed(0))
    assert not np.allclose(plain(*(torch.tensor(a) for a in (x, *adj))).detach().numpy(), o0)  # dropout acted


# ------------------------------------------------------------------ training
def _grads_of(trainer, batch):
    trainer.compute_grads(batch)
    return {n: p.grad.clone() for n, p in trainer.model.named_parameters()}


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gradients_equal_off_with_dropout(remat):
    """The trainer at dropout 0.4, one generator seed: gradients with
    checkpointed GCNII trips ≡ without; and dropout acted."""
    batch = _t(_train_batches(1)[0])
    g_off = _grads_of(_port_trainer("--gcn_remat=off", drop_rate=0.4), batch)
    g_remat = _grads_of(_port_trainer(f"--gcn_remat={remat}", drop_rate=0.4), batch)
    _assert_grads_close(list(g_remat.items()), g_off, 1e-6)
    g_nodrop = _grads_of(_port_trainer("--gcn_remat=off"), batch)
    assert not torch.allclose(g_nodrop["gcnii.convs"], g_off["gcnii.convs"])


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_reads_no_rng_state(remat, monkeypatch):
    """A checkpointed GCNII trip neither saves nor restores the RNG state
    (on the card that read cannot be captured in a CUDA graph): the step's
    forward and backward run with the generator-state readers refused, and
    give the gradients of ``off`` from one generator state."""
    batch = _t(_train_batches(1)[0])
    g_off = _grads_of(_port_trainer("--gcn_remat=off", drop_rate=0.4), batch)
    trainer = _port_trainer(f"--gcn_remat={remat}", drop_rate=0.4)

    def refuse(*a, **k):
        raise AssertionError("the RNG state was read")

    monkeypatch.setattr(torch, "get_rng_state", refuse)
    monkeypatch.setattr(torch, "set_rng_state", refuse)
    _assert_grads_close(list(_grads_of(trainer, batch).items()), g_off, 1e-6)


def test_structured_gradients_equal_dense_with_dropout():
    """The two adjacency forms draw the same dropout masks (their tensors
    hold the same elements in the same order), so at dropout 0.4 from one
    seed their gradients agree."""
    batch = _t(_train_batches(1)[0])
    g_dense = _grads_of(_port_trainer("--adj_impl=dense", drop_rate=0.4), batch)
    g_struct = _grads_of(_port_trainer("--adj_impl=structured", drop_rate=0.4), batch)
    _assert_grads_close(list(g_struct.items()), g_dense, GRAD_RTOL)


def test_train_entry_point_runs_two_steps_saves_and_serves(tmp_path):
    args = [*SMALL, "--module=mmgcn", "--epoch=1", "--batch_count=2", "--max_seq_len=32", "--train.batch_size=4",
            "--test.batch_size=16", "--confusion_matrix=false", "--adj_impl=structured", f"--save_dir={tmp_path}"]
    code = ("import runpy, sys\n"
            f"sys.argv = {['erc_tpu_torch.train'] + args!r}\n"
            "runpy.run_module('erc_tpu_torch.train', run_name='__main__')\n"
            "bad = [n for n in sys.modules\n"
            "       if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'erc_tpu')]\n"
            "print('JAX modules:', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})  # one thread: the other workers share the cores
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "model MMGCNModule" in out and "e0 b0 Lall=" in out and "2 steps" in out and "test: acc=" in out, out
    assert "JAX modules: []" in out
    path = tmp_path / "model.last.ckpt"
    assert path.exists() and f"saved {path}" in out
    engine = InferenceEngine.from_module("mmgcn", str(path), dataset="synthetic-cogmen-6", batch_size=4,
                                         graph_hidden_size=8, gcn_layers=4, gcn_chunk=2, adj_impl="structured",
                                         device="cpu")
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 2
    model = tmmgcn.MMGCNModule(n_classes=6, graph_hidden_size=8, gcn_layers=4, gcn_chunk=2, adj_impl="dense")
    model.load_state_dict(saved["model"])
    batch = engine.batcher(j_synthetic_erc("iemocap-cogmen", 6, "test", n_train=4, max_len=20, seed=5)[:4])
    with torch.no_grad():
        want = model.eval()(to_device(batch, torch.device("cpu"))).numpy()
    np.testing.assert_allclose(engine.logits(batch), want, rtol=0, atol=1e-5)
    results = engine.predict(j_synthetic_erc("iemocap-cogmen", 6, "test", n_train=3, max_len=20, seed=6))
    assert all(np.isfinite(r["probs"]).all() and np.allclose(np.sum(r["probs"], -1), 1.0, atol=1e-5)
               for r in results)


def test_train_main_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmmgcn.main([a for a in SMALL if a != "--device=cpu"])
