"""The port's DialogueGCN (models.dgcn and its ops) ≡ the JAX package's.

On the CPU at small widths: input 24 (audio, text and visual 8 each),
hidden 16 (8 per LSTM direction), B = 3 with one all-padding dialogue,
L ≤ 24, where the band kernels run as their plain versions.  The same numpy
inputs and converted weights go through JAX (float32, matmul precision
highest, dropout off, Pallas in interpret mode) and the port.  Outputs
within 1e-5 absolute, gradients within 1e-5 of each parameter's gradient
norm (floored at 1e-8 of the global norm where the exact gradient is 0).

- ``masked_softmax`` in both modes, with an all-padding row;
- ``BiRNN`` (bidirectional LSTM, 1 and 2 layers) on ragged lengths with a
  zero-length row;
- ``DenseGraphConv``; ``EdgeAtt`` and ``BandedEdgeAtt`` at wp = 3, wf = 2
  (the source → target band remap), and the banded weights ≡ the dense ones;
- ``DGCNModule`` dense and banded at wp = 3, wf = 2 and at wp = wf = 10
  (K1 at K = 10, 11 and 21, K2 at K = 21), with the class-weighted loss;
- ``dgcn_state`` from the banded and the dense JAX trees (their GraphConv
  names differ), the convert CLI, and a JAX Saver file served by the port;
- a 3-step ``DGCNTrainer`` trajectory against JAX's train step;
- ``python -m erc_tpu_torch.train --module=dgcn --device=cpu`` for two
  steps that save and serve; ``main`` without CUDA raises.
"""

import re
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu.data.collate import ERCBatcher as JERCBatcher
from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu.models import dgcn as jdgcn
from erc_tpu.ops import attention as jattention
from erc_tpu.ops import gnn as jgnn
from erc_tpu.ops import rnn as jrnn
from erc_tpu.train import checkpoint as jcheckpoint
from erc_tpu.train import optim as joptim
from erc_tpu.train import trainer as jtrainer
from erc_tpu.train.trainer import TrainState
from erc_tpu_torch import convert
from erc_tpu_torch.models import dgcn as tdgcn
from erc_tpu_torch.ops import attention as tattention
from erc_tpu_torch.ops import gnn as tgnn
from erc_tpu_torch.ops import rnn as trnn
from erc_tpu_torch.ops.gnn_banded import BandedGraphConv
from erc_tpu_torch.ops.kernels import banded as kb
from erc_tpu_torch.serve import InferenceEngine
from erc_tpu_torch.train.trainer import masked_cross_entropy
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-5
DIMS = dict(text_dim=8, audio_dim=8, visual_dim=8)
SMALL = ["--dataset=synthetic-cogmen-6", "--hidden_size=16", "--device=cpu", "--graph_impl=banded"]


def _batch(seed=0, B=3, n=2, max_len=24):
    """B rows, n of them dialogues of 5..20 utterances, the rest padding."""
    batcher = JERCBatcher("atv", 6, 2, bucket=8, max_len=max_len, pad_batch_to=B)
    return batcher(j_synthetic_erc("custom", 6, "train", n_train=n, min_len=5, max_len=20, seed=seed, **DIMS))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if v is not None}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_grads_close(named, want, global_norm=None):
    """‖got − want‖ ≤ max(RTOL · ‖want‖, 1e-8 · global norm)."""
    if global_norm is None:
        global_norm = float(np.sqrt(sum(float((want[n].double() ** 2).sum()) for n, _ in named)))
    assert {n for n, _ in named} == set(want)
    for name, g in named:
        w = want[name].double()
        d = (g.double() - w).norm().item()
        assert d <= max(RTOL * w.norm().item(), 1e-8 * global_norm), (name, d, w.norm().item())


def _cotangent(shape, seed=9):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_vjp(fn, *primals):
    """fn(*primals) and its VJP of a seeded cotangent, jitted as one function
    (JAX at matmul precision highest); returns (value, cotangent, grads)."""
    cot = _cotangent(jax.eval_shape(fn, *primals).shape)

    def run(*p):
        out, vjp = jax.vjp(fn, *p)
        return out, vjp(jnp.asarray(cot))

    with jax.default_matmul_precision("highest"):
        out, grads = jax.jit(run)(*primals)
    return np.asarray(out), cot, _np_tree(grads)


def _grads(module, fn, cot):
    """fn(module)'s value and every parameter's gradient of <fn(module), cot>."""
    module.zero_grad()
    with torch.enable_grad():
        out = fn(module)
        out.backward(torch.from_numpy(cot))
    return out.detach(), [(n, p.grad) for n, p in module.named_parameters()]


# ------------------------------------------------------------------ masked_softmax
@pytest.mark.parametrize("mode", ["subtract", "where"])
def test_masked_softmax_matches_jax(mode):
    r = np.random.default_rng(0)
    scores = r.normal(size=(3, 5, 7)).astype(np.float32)
    mask = (r.uniform(size=(3, 5, 7)) < 0.6).astype(np.float32)
    mask[1, 2] = 0.0  # a row with no valid entry
    want = np.asarray(jattention.masked_softmax(jnp.asarray(scores), jnp.asarray(mask), axis=-1, mode=mode))
    got = tattention.masked_softmax(torch.from_numpy(scores), torch.from_numpy(mask), dim=-1, mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if mode == "where":
        assert np.all(got[1, 2] == 0.0) and np.isfinite(got).all()
    with pytest.raises(ValueError, match="unknown masked_softmax mode"):
        tattention.masked_softmax(torch.from_numpy(scores), torch.from_numpy(mask), mode="add")


# ------------------------------------------------------------------ BiRNN
@pytest.mark.parametrize("num_layers", [1, 2])
def test_birnn_matches_jax_on_ragged_lengths(num_layers):
    r = np.random.default_rng(1)
    B, L, D, H = 4, 9, 6, 5
    lengths = np.array([9, 0, 4, 1], np.int32)  # a full row, a padding row, ragged rows
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    x = (r.normal(size=(B, L, D)) * mask[..., None]).astype(np.float32)
    jm = jrnn.BiRNN(hidden_size=H, num_layers=num_layers, cell="lstm", bidirectional=True)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), x, mask))["params"]

    want, cot, (gp, gx) = _jax_vjp(lambda p, xx: jm.apply({"params": p}, xx, mask), params, x)
    module = trnn.BiRNN(D, H, num_layers=num_layers)
    module.load_state_dict(convert.birnn_state(params))
    xt = torch.from_numpy(x).requires_grad_()
    got, grads = _grads(module, lambda m: m(xt, torch.from_numpy(mask)), cot)  # the masked form
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert np.all(got.numpy()[1] == 0.0)
    _assert_grads_close(grads, convert.birnn_state(gp))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=ATOL)


def test_birnn_runs_cudnn_in_full_float32_and_restores_the_flags():
    cudnn = torch.backends.cudnn
    prev = cudnn.rnn.fp32_precision
    try:
        cudnn.rnn.fp32_precision = "tf32"
        with trnn.cudnn_rnn_full_fp32():
            assert cudnn.rnn.fp32_precision == "ieee"
        assert cudnn.rnn.fp32_precision == "tf32"
    finally:
        cudnn.rnn.fp32_precision = prev


def test_rnn_backward_node_runs_in_full_float32():
    """cuDNN reads the TF32 flag when the backward runs: the hooks put the
    full-precision setting around the cuDNN node (here a stand-in of that
    name) and restore the flag after."""
    cudnn = torch.backends.cudnn
    seen = []

    class CudnnRnnBackwardStandIn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            seen.append(cudnn.rnn.fp32_precision)
            return g * 2

    prev = cudnn.rnn.fp32_precision
    try:
        cudnn.rnn.fp32_precision = "tf32"
        x = torch.ones(3, requires_grad=True)
        with torch.enable_grad():
            y = CudnnRnnBackwardStandIn.apply(x)
            trnn._backward_in_full_fp32(y.view(3, 1))  # found above a view
            y.sum().backward()
        assert seen == ["ieee"] and cudnn.rnn.fp32_precision == "tf32"
        assert torch.equal(x.grad, torch.full((3,), 2.0))
    finally:
        cudnn.rnn.fp32_precision = prev


# ------------------------------------------------------------------ graph layers
def _graph_inputs(seed=2, B=3, L=11, D=6):
    r = np.random.default_rng(seed)
    lengths = np.array([L, 0, 7], np.int32)[:B]
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    x = (r.normal(size=(B, L, D)) * mask[..., None]).astype(np.float32)
    return x, mask, lengths


def test_dense_graph_conv_matches_jax():
    x, mask, lengths = _graph_inputs()
    from erc_tpu.ops import graphs as jgraphs

    adj = np.asarray(jgraphs.window_adjacency(jnp.asarray(lengths), x.shape[1], 3, 2))
    jm = jgnn.DenseGraphConv(5)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), x, adj))["params"]
    want, cot, (gp,) = _jax_vjp(lambda p: jm.apply({"params": p}, x, adj), params)
    module = tgnn.DenseGraphConv(6, 5)
    sd = {**convert._prefixed("lin_rel", convert.linear_state(params["lin_rel"])),
          **convert._prefixed("lin_root", convert.linear_state(params["lin_root"]))}
    module.load_state_dict(sd)
    got, grads = _grads(module, lambda m: m(torch.from_numpy(x), torch.from_numpy(adj)), cot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    _assert_grads_close(grads, {**convert._prefixed("lin_rel", convert.linear_state(gp["lin_rel"])),
                                **convert._prefixed("lin_root", convert.linear_state(gp["lin_root"]))})
    # the banded form (one K1 over the full band) on the window graph
    banded = BandedGraphConv(6, 5, 3, 2)
    banded.load_state_dict(sd)
    np.testing.assert_allclose(banded(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy(),
                               module(torch.from_numpy(x), torch.from_numpy(adj)).detach().numpy(),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("banded", [False, True], ids=["dense", "banded"])
def test_edge_att_matches_jax_with_wp_ne_wf(banded):
    wp, wf = 3, 2
    x, mask, lengths = _graph_inputs(D=8)
    jm = (jdgcn.BandedEdgeAtt if banded else jdgcn.EdgeAtt)(wp, wf)
    arg = mask if banded else lengths
    params = _np_tree(jm.init(jax.random.PRNGKey(1), x, arg))["params"]
    want, cot, (gp, gx) = _jax_vjp(lambda p, xx: jm.apply({"params": p}, xx, arg), params, x)
    module = (tdgcn.BandedEdgeAtt if banded else tdgcn.EdgeAtt)(8, wp, wf)
    module.load_state_dict(convert.as_is_state(params))
    xt = torch.from_numpy(x).requires_grad_()
    got, grads = _grads(module, lambda m: m(xt, torch.from_numpy(arg)), cot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    _assert_grads_close(grads, convert.as_is_state(gp))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=ATOL)
    if banded:  # tap k of target v is the dense weight of edge (v + o_k) → v
        dense = tdgcn.EdgeAtt.forward(module, torch.from_numpy(x), torch.from_numpy(lengths)).detach().numpy()
        B, L, K = got.shape
        for k, o in enumerate(kb.band_offsets(wp, wf)):
            for v in range(L):
                u = v + o
                expect = dense[:, u, v] if 0 <= u < L else np.zeros(B, np.float32)
                np.testing.assert_allclose(got.numpy()[:, v, k], expect, rtol=0, atol=ATOL)


# ------------------------------------------------------------------ DGCNModule
KW = dict(input_size=24, hidden_size=16, n_speakers=2, n_classes=6, drop_rate=0.0)
WINDOWS = [(3, 2), (10, 10)]
WEIGHTS = np.asarray(jdgcn.IEMOCAP6_LOSS_WEIGHTS, np.float32)


def _jax_loss(model, batch):
    """The class-weighted masked CE of the flax module's logits, and the logits."""
    def loss(params):
        logits = model.apply({"params": params}, batch, deterministic=True)
        weights = jnp.asarray(WEIGHTS)
        return jtrainer.masked_cross_entropy(logits, batch["label"], batch["attention_mask"], weights), logits

    return loss


@pytest.fixture(scope="module", params=WINDOWS, ids=[f"wp{a}-wf{b}" for a, b in WINDOWS])
def jax_module_run(request):
    """(wp, wf, batch, per impl: its flax tree, logits and gradients).  The
    two trees hold the same weights under each module's names."""
    wp, wf = request.param
    batch = _batch()
    dense = _np_tree(jdgcn.DGCNModule(wp=wp, wf=wf, graph_impl="dense", **KW).init(jax.random.PRNGKey(0), batch))
    trees = {"dense": dense["params"]}
    trees["banded"] = {k: v for k, v in trees["dense"].items() if k != "conv2"}
    trees["banded"].update({f"conv2_{k}": v for k, v in trees["dense"]["conv2"].items()})
    out = {}
    for impl, params in trees.items():
        model = jdgcn.DGCNModule(wp=wp, wf=wf, graph_impl=impl, **KW)
        with jax.default_matmul_precision("highest"):
            (_, logits), grads = jax.jit(jax.value_and_grad(_jax_loss(model, batch), has_aux=True))(params)
        out[impl] = (params, np.asarray(logits), _np_tree(grads))
    return wp, wf, batch, out


@pytest.mark.parametrize("impl", ["dense", "banded"])
def test_dgcn_module_matches_jax(jax_module_run, impl):
    wp, wf, batch, out = jax_module_run
    params, logits, grads = out[impl]
    module = tdgcn.DGCNModule(wp=wp, wf=wf, graph_impl=impl, **KW)
    module.load_state_dict(convert.dgcn_state(params))
    tb = _t(batch)
    got = module.eval()(tb).detach().numpy()
    np.testing.assert_allclose(got, logits, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, out["dense" if impl == "banded" else "banded"][1], rtol=0, atol=ATOL)
    module.train()
    with torch.enable_grad():
        loss = masked_cross_entropy(module(tb), tb["label"], tb["attention_mask"], torch.from_numpy(WEIGHTS))
        loss.backward()
    _assert_grads_close([(n, p.grad) for n, p in module.named_parameters()], convert.dgcn_state(grads))


def test_dgcn_banded_band_calls(monkeypatch):
    """The banded forward's band calls (those the card launches): the RGCN's
    4 K1 at K = wf and wp + 1 over D = 100, GraphConv's K1 and EdgeAtt's K2
    at K = wp + wf + 1; each with its tap-count instantiation."""
    calls = []
    real_gather, real_dot = kb._gather, kb._dot

    def gather(name, coef, src, args):
        calls.append((name, args.K, src.shape[-1], args.tap_key[name]))
        return real_gather(name, coef, src, args)

    def dot(a, b, args):
        calls.append(("banded_dot", args.K, b.shape[-1], args.tap_key["banded_dot"]))
        return real_dot(a, b, args)

    monkeypatch.setattr(kb, "_gather", gather)
    monkeypatch.setattr(kb, "_dot", dot)
    module = tdgcn.DGCNModule(wp=10, wf=10, graph_impl="banded", **KW)
    with torch.no_grad():
        module.eval()(_t(_batch()))
    assert sorted(calls) == sorted([
        ("banded_dot", 21, 16, "banded_dot/kt21"),
        *[("banded_gather_sum", 10, 100, "banded_gather_sum/kt0")] * 2,
        *[("banded_gather_sum", 11, 100, "banded_gather_sum/kt11")] * 2,
        ("banded_gather_sum", 21, 100, "banded_gather_sum/kt21")])


def test_unrolled_tap_counts_match_the_cuda_source():
    src = (ROOT / "erc_tpu_torch" / "csrc" / "banded.cu").read_text()
    assert tuple(int(k) for k in re.findall(r"case (\d+): Kernel<VEC, \1>::launch", src)) == kb.UNROLLED_TAPS
    assert set(kb.tap_launches) == {f"{n}/kt{k}" for n in kb.launches for k in (0, *kb.UNROLLED_TAPS)}


def test_class_weighted_loss_matches_jax():
    r = np.random.default_rng(4)
    logits = r.normal(size=(3, 7, 6)).astype(np.float32)
    labels = r.integers(0, 6, size=(3, 7)).astype(np.int32)
    mask = (r.uniform(size=(3, 7)) < 0.7).astype(np.float32)
    labels[mask == 0] = -1
    want = float(jtrainer.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
                                               jnp.asarray(WEIGHTS)))
    got = masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask),
                               torch.tensor(tdgcn.IEMOCAP6_LOSS_WEIGHTS))
    np.testing.assert_allclose(got.item(), want, rtol=RTOL)


# ------------------------------------------------------------------ weights from JAX
def test_dgcn_state_loads_the_banded_and_the_dense_tree(jax_module_run, tmp_path):
    wp, wf, batch, out = jax_module_run
    banded, dense = convert.dgcn_state(out["banded"][0]), convert.dgcn_state(out["dense"][0])
    assert banded.keys() == dense.keys()
    assert all(torch.equal(banded[k], dense[k]) for k in banded)
    for impl in ("banded", "dense", "auto"):
        tdgcn.DGCNModule(wp=wp, wf=wf, graph_impl=impl, **KW).load_state_dict(banded)
    # the convert CLI from a flat npz of the banded tree
    flat = {"params/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(out["banded"][0])[0]}
    np.savez(tmp_path / "v.npz", **flat)
    convert.main(["--module=dgcn", str(tmp_path / "v.npz"), str(tmp_path / "sd.pt")])
    sd = torch.load(tmp_path / "sd.pt", weights_only=True)
    assert sd.keys() == banded.keys() and all(torch.equal(sd[k], banded[k]) for k in sd)


def test_jax_checkpoint_serves_through_the_port(jax_module_run, tmp_path):
    """The JAX Saver's file of the banded model (its GraphConv named at the
    top level) → ``load_model_state`` → the engine's logits ≡ JAX's."""
    wp, wf, batch, out = jax_module_run
    params, logits, _ = out["banded"]
    tx = joptim.build_optim(joptim.create_optim("Adam", lr=3e-4, weight_decay=0))
    state = TrainState(params=params, opt_state=tx.init(params), model_state={}, step=jnp.asarray(3))
    path = jcheckpoint.Saver(str(tmp_path)).save_model("last", state, meta={"eidx": 1})
    p = tdgcn.DGCNParams()
    p.finalize(["--module=dgcn", "--dataset=synthetic-cogmen-6", "--device=cpu"])
    model = tdgcn.DGCNModule(wp=wp, wf=wf, graph_impl="banded", **KW)
    engine = InferenceEngine(model, p, torch.device("cpu"), path, batch_size=3)
    np.testing.assert_allclose(engine.logits(batch), logits, rtol=0, atol=ATOL)
    results = engine.predict(j_synthetic_erc("custom", 6, "test", n_train=2, max_len=20, seed=5, **DIMS)[:2])
    assert all(np.isfinite(r["probs"]).all() and np.allclose(np.sum(r["probs"], -1), 1.0, atol=1e-5)
               for r in results)


# ------------------------------------------------------------------ training
def _port_trainer(*extra):
    p = tdgcn.DGCNParams()
    p.finalize(SMALL + list(extra))
    p.drop_rate = 0.0
    trainer = tdgcn.DGCNTrainer(p)
    trainer.log = lambda msg: None
    trainer.initialize()
    return trainer


def test_three_step_trajectory_matches_jax():
    """Adam 3e-4 with no weight decay and the IEMOCAP-6 class weights, on the
    full input width (712) of synthetic-cogmen-6."""
    batcher = JERCBatcher("atv", 6, 2, bucket=16, max_len=16, pad_batch_to=3)
    batches = [batcher(j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=2, min_len=5, max_len=16, seed=s))
               for s in range(3)]
    trainer = _port_trainer()
    assert trainer.grad_clip_norm is None and trainer.lr_sche is None
    np.testing.assert_array_equal(trainer.class_weights.numpy(), WEIGHTS)
    jp = jdgcn.DGCNParams()
    jm = jdgcn.DGCNModule(input_size=712, hidden_size=16, n_classes=6, drop_rate=0.0, graph_impl="dense")
    params = _np_tree(jm.init(jax.random.PRNGKey(0), batches[0]))["params"]
    trainer.model.load_state_dict(convert.dgcn_state(params))
    tx = joptim.build_optim(jp.optim)

    @jax.jit
    def step(params, opt_state, batch):  # Trainer._make_raw_train_step's composition
        (value, _), grads = jax.value_and_grad(_jax_loss(jm, batch), has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, value, grads, optax.global_norm(grads)

    opt_state = tx.init(params)
    for i, batch in enumerate(batches):
        with jax.default_matmul_precision("highest"):
            params, opt_state, loss, grads, gnorm = step(params, opt_state, batch)
        mets = trainer.train_step(_t(batch))
        np.testing.assert_allclose(mets["Lall"].item(), float(loss), rtol=RTOL, err_msg=f"loss {i}")
        np.testing.assert_allclose(mets["gnorm"].item(), float(gnorm), rtol=RTOL, err_msg=f"gnorm {i}")
        if i == 0:
            _assert_grads_close([(n, p.grad) for n, p in trainer.model.named_parameters()],
                                convert.dgcn_state(_np_tree(grads)), float(gnorm))
    want = convert.dgcn_state(_np_tree(params))
    for name, t in trainer.model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_dropout_draws_from_the_seeded_generator():
    a, b = _port_trainer("--seed=3"), _port_trainer("--seed=3")
    for t in (a, b):
        drops = [m for m in t.model.modules() if type(m).__name__ == "Dropout"]
        assert len(drops) == 2  # between the LSTM layers, and in the head
        for m in drops:
            m.p = 0.4
            assert m.generator is not None
        t.model.train()
    batch = _t(JERCBatcher("atv", 6, 2, bucket=16, max_len=16, pad_batch_to=3)(
        j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=3, min_len=5, max_len=16)))
    torch.manual_seed(0)
    la = a.model(batch)
    torch.manual_seed(1)  # the global RNG plays no part
    np.testing.assert_array_equal(la.detach().numpy(), b.model(batch).detach().numpy())
    assert not torch.equal(la, a.model(batch))  # the stream moves on


def test_train_entry_point_runs_two_steps_saves_and_serves(tmp_path):
    args = [*SMALL, "--module=dgcn", "--epoch=1", "--batch_count=2", "--max_seq_len=32", "--train.batch_size=4",
            "--test.batch_size=16", "--confusion_matrix=false", f"--save_dir={tmp_path}"]
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
    assert "model DGCNModule" in out and "e0 b0 Lall=" in out and "2 steps" in out and "test: acc=" in out, out
    assert "JAX modules: []" in out
    path = tmp_path / "model.last.ckpt"
    assert path.exists() and f"saved {path}" in out
    engine = InferenceEngine.from_module("dgcn", str(path), dataset="synthetic-cogmen-6", batch_size=4,
                                         hidden_size=16, graph_impl="banded", device="cpu")
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 2
    model = tdgcn.DGCNModule(input_size=712, hidden_size=16, n_classes=6, graph_impl="dense")
    model.load_state_dict(saved["model"])
    batch = engine.batcher(j_synthetic_erc("iemocap-cogmen", 6, "test", n_train=4, max_len=20, seed=5)[:4])
    with torch.no_grad():
        want = model.eval()(_t(batch)).numpy()
    np.testing.assert_allclose(engine.logits(batch), want, rtol=0, atol=1e-5)


def test_train_main_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdgcn.main([a for a in SMALL if a != "--device=cpu"])
