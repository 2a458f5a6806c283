"""The port's MMGCN (models.mmgcn and its ops) ≡ the JAX package's.

On the CPU at small size: graph hidden 8, 4 or 6 GCNII layers in trips of
2 or 3 (``gcn_chunk``), B = 3 with one all-padding dialogue, ragged L ≤ 16,
inputs 8 wide, speakers 2 and 9.  The node width stays 200 (the JAX
module's ``n_dim``): its text biLSTM is 100 a direction whatever ``n_dim``
is (mmgcn.py:127), and the text nodes sit beside the audio and visual ones
in one graph.  The same numpy
inputs and converted weights go through JAX (float32, matmul precision
highest, dropout off) and the port.  Tolerances:

- the adjacency (dense and structured) ≤ 1e-5 absolute; its gradients, as
  every gradient below, ≤ 1e-4 of their norm: a self-cosine just under the
  clip has a slope of about 224 there, so the rounding of the cosines in the
  summation order of each library reaches the gradient magnified;
- the GCNII stack given the same adjacency ≤ 1e-5, its gradients ≤ 1e-5 of
  each gradient's norm;
- logits ≤ 1e-4 absolute: the arccos' slope near the clip, about 224,
  magnifies float32 rounding of the cosines;
- gradients ≤ 1e-4 of each parameter's gradient norm (floored at 1e-8 of the
  global norm where the exact gradient is 0).

Covered here: each graph function with gradients through padded rows and a
self-cosine on the clip (the clip splits a tie's gradient as ``jnp.clip``);
``MMGCNModule`` dense and structured, packed and unpacked LSTM, modalities
``atv`` and ``at``, with its loss; ``mmgcn_state`` from the JAX trees of both
``adj_impl``s, the convert CLI and a JAX Saver file served by the port; a
3-step ``MMGCNTrainer`` trajectory against JAX's train step.
``test_torch_mmgcn_train.py`` (its helpers imported from here) covers
``GCNIIStack`` and ``GCNIIStackStructured`` in the three remat modes and the
rest of the training: ``python -m erc_tpu_torch.train --module=mmgcn
--device=cpu`` for two steps that save and serve; ``main`` without CUDA
raises; and remat ``full`` / ``dots`` ≡ ``off`` gradients with dropout 0.4
from one generator seed (a checkpoint's recompute must not draw new masks).
The two files split the suite's longest file in two of about equal time.
"""

from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu.data.collate import ERCBatcher as JERCBatcher
from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu.models import mmgcn as jmmgcn
from erc_tpu.ops import gnn as jgnn
from erc_tpu.ops import graphs as jgraphs
from erc_tpu.train import checkpoint as jcheckpoint
from erc_tpu.train import optim as joptim
from erc_tpu.train import trainer as jtrainer
from erc_tpu.train.trainer import TrainState
from erc_tpu_torch import convert
from erc_tpu_torch.models import mmgcn as tmmgcn
from erc_tpu_torch.ops import gnn as tgnn
from erc_tpu_torch.ops import graphs as tgraphs
from erc_tpu_torch.serve import InferenceEngine
from erc_tpu_torch.train.trainer import masked_cross_entropy
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
ADJ_TOL = 1e-5
STACK_TOL = 1e-5
LOGIT_TOL = 1e-4
GRAD_RTOL = 1e-4
DIMS = dict(text_dim=8, audio_dim=8, visual_dim=8)
SMALL = ["--dataset=synthetic-cogmen-6", "--graph_hidden_size=8", "--gcn_layers=4", "--gcn_chunk=2",
         "--device=cpu"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_grads_close(named, want, rtol, global_norm=None):
    """‖got − want‖ ≤ max(rtol · ‖want‖, 1e-8 · global norm)."""
    if global_norm is None:
        global_norm = float(np.sqrt(sum(float((want[n].double() ** 2).sum()) for n, _ in named)))
    assert {n for n, _ in named} == set(want)
    for name, g in named:
        w = want[name].double()
        d = (g.double() - w).norm().item()
        assert d <= max(rtol * w.norm().item(), 1e-8 * global_norm), (name, d, w.norm().item())


def _assert_close_rel(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), what
    d = np.linalg.norm(got - want)
    assert d <= rtol * max(np.linalg.norm(want), 1e-30), (what, d, np.linalg.norm(want))


def _jax_vjp(fn, *primals, seed=9):
    """fn(*primals) and its VJP of a seeded cotangent, jitted as one function
    at matmul precision highest; returns (values, cotangents, grads), the
    output a tuple or one array."""
    shapes = jax.eval_shape(fn, *primals)
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    r = np.random.default_rng(seed)
    cots = [r.normal(size=s.shape).astype(np.float32) for s in leaves]

    def run(*p):
        out, vjp = jax.vjp(fn, *p)
        return out, vjp(jax.tree_util.tree_unflatten(treedef, [jnp.asarray(c) for c in cots]))

    with jax.default_matmul_precision("highest"):
        out, grads = jax.jit(run)(*primals)
    return _np_tree(out), cots, _np_tree(grads)


def _torch_vjp(fn, cots, *inputs):
    """fn(*inputs) (a tuple or one tensor) and the inputs' gradients of
    Σ <out_i, cot_i>."""
    ts = [torch.from_numpy(np.array(x)).requires_grad_() for x in inputs]
    with torch.enable_grad():
        out = fn(*ts)
        outs = out if isinstance(out, tuple) else (out,)
        torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return [o.detach().numpy() for o in outs], [t.grad.numpy() for t in ts]


# ------------------------------------------------------------------ graph functions
def _feats(M=3, B=3, L=9, D=6, seed=0):
    """M modalities' node features [B, L, D] with row 1 all padding, row 2
    ragged, zeros on padded positions, and a node whose self-cosine is
    exactly 1 (a power-of-two multiple of a basis vector), where the clip's
    tie splits the gradient."""
    r = np.random.default_rng(seed)
    lengths = np.array([L, 0, 5], np.int32)[:B]
    valid = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    feats = [(r.normal(size=(B, L, D)) * valid[..., None]).astype(np.float32) for _ in range(M)]
    for f in feats:
        f[0, 3] = 0.0
        f[0, 3, 1] = 2.0
    return feats, valid


def test_clip_splits_a_tie_as_jax():
    """At x = 0.99999 jnp.clip passes half the gradient; torch.clamp all of it.
    arccos' slope there (1 − x² ≈ 2e-5) rounds differently in the two
    libraries' float32 formulas, by about 3e-6 relative."""
    x = np.float32(0.99999)
    want = float(jax.grad(lambda v: jnp.arccos(jnp.clip(v, -0.99999, 0.99999)))(x))
    for v in (x, -x):
        t = torch.tensor(v, requires_grad=True)
        with torch.enable_grad():
            torch.arccos(tgraphs._clip(t)).backward()
        want_v = float(jax.grad(lambda u: jnp.arccos(jnp.clip(u, -0.99999, 0.99999)))(v))
        np.testing.assert_allclose(t.grad.item(), want_v, rtol=1e-5)
    clamp = torch.tensor(x, requires_grad=True)
    with torch.enable_grad():
        torch.arccos(torch.clamp(clamp, -0.99999, 0.99999)).backward()
    np.testing.assert_allclose(clamp.grad.item(), 2 * want, rtol=1e-5)  # the trap the port avoids


def test_angular_similarity_matches_jax():
    (x, *_), valid = _feats()
    want, cots, (gx,) = _jax_vjp(lambda a: jgraphs.angular_similarity(a, jnp.asarray(valid)), x)
    assert float(np.asarray(jgraphs.angular_similarity(x, valid))[0, 3, 3]) == pytest.approx(
        1 - np.arccos(np.float32(0.99999)) / np.pi, abs=1e-6)  # the node on the clip
    (got,), (tx,) = _torch_vjp(lambda a: tgraphs.angular_similarity(a, torch.from_numpy(valid)), cots, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=ADJ_TOL)
    assert np.isfinite(tx).all() and np.all(tx[1] == 0.0)
    _assert_close_rel(tx, gx, GRAD_RTOL, "x")


def test_cross_modal_diag_similarity_matches_jax():
    (x, y, _), valid = _feats()
    y[0, 3] = x[0, 3]  # cos exactly 1 across the pair too
    want, cots, (gx, gy) = _jax_vjp(lambda a, b: jgraphs.cross_modal_diag_similarity(a, b, jnp.asarray(valid)), x, y)
    (got,), (tx, ty) = _torch_vjp(
        lambda a, b: tgraphs.cross_modal_diag_similarity(a, b, torch.from_numpy(valid)), cots, x, y)
    np.testing.assert_allclose(got, want, rtol=0, atol=ADJ_TOL)
    for t, g in ((tx, gx), (ty, gy)):
        _assert_close_rel(t, g, GRAD_RTOL, "x, y")


def test_degree_normalize_sym_matches_jax():
    r = np.random.default_rng(3)
    adj = r.uniform(size=(2, 7, 7)).astype(np.float32)
    adj[0, 4, :] = 0.0  # a node of degree 0
    adj[1] = 0.0  # a graph with no edge
    want, cots, (ga,) = _jax_vjp(jgraphs.degree_normalize_sym, adj)
    (got,), (ta,) = _torch_vjp(tgraphs.degree_normalize_sym, cots, adj)
    np.testing.assert_allclose(got, want, rtol=0, atol=ADJ_TOL)
    _assert_close_rel(ta, ga, GRAD_RTOL, "adj")


@pytest.mark.parametrize("M", [3, 2])
def test_mmgcn_big_adjacency_matches_jax(M):
    feats, valid = _feats(M=M)
    want, cots, grads = _jax_vjp(lambda *f: jgraphs.mmgcn_big_adjacency(list(f), jnp.asarray(valid)), *feats)
    (got,), tgrads = _torch_vjp(lambda *f: tgraphs.mmgcn_big_adjacency(list(f), torch.from_numpy(valid)), cots, *feats)
    np.testing.assert_allclose(got, want, rtol=0, atol=ADJ_TOL)
    for i, (t, g) in enumerate(zip(tgrads, grads)):
        _assert_close_rel(t, g, GRAD_RTOL, f"feature {i}")


@pytest.mark.parametrize("M", [3, 2])
def test_mmgcn_structured_adjacency_matches_jax_and_the_dense_form(M):
    feats, valid = _feats(M=M)
    want, cots, grads = _jax_vjp(lambda *f: jgraphs.mmgcn_structured_adjacency(list(f), jnp.asarray(valid)), *feats)
    (intra, cross), tgrads = _torch_vjp(
        lambda *f: tgraphs.mmgcn_structured_adjacency(list(f), torch.from_numpy(valid)), cots, *feats)
    assert intra.shape == (M, 3, 9, 9) and cross.shape == (M, M, 3, 9)
    np.testing.assert_allclose(intra, want[0], rtol=0, atol=ADJ_TOL)
    np.testing.assert_allclose(cross, want[1], rtol=0, atol=ADJ_TOL)
    assert all(np.all(cross[m, m] == 0.0) for m in range(M))
    for i, (t, g) in enumerate(zip(tgrads, grads)):
        _assert_close_rel(t, g, GRAD_RTOL, f"feature {i}")
    # the blocks assembled are the dense adjacency
    dense = tgraphs.mmgcn_big_adjacency([torch.from_numpy(f) for f in feats], torch.from_numpy(valid)).numpy()
    L = valid.shape[1]
    for m in range(M):
        for n in range(M):
            block = dense[:, m * L : (m + 1) * L, n * L : (n + 1) * L]
            expect = intra[m] if m == n else np.stack([np.diag(c) for c in cross[m, n]])
            np.testing.assert_allclose(block, expect, rtol=0, atol=ADJ_TOL)


def test_structured_adj_matmul_matches_jax():
    feats, valid = _feats()
    intra, cross = (np.asarray(a) for a in jgraphs.mmgcn_structured_adjacency(feats, valid))
    x = np.random.default_rng(4).normal(size=(3, 3, 9, 5)).astype(np.float32)
    want, cots, grads = _jax_vjp(jgraphs.structured_adj_matmul, intra, cross, x)
    (got,), tgrads = _torch_vjp(tgraphs.structured_adj_matmul, cots, intra, cross, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=ADJ_TOL)
    for i, (t, g) in enumerate(zip(tgrads, grads)):
        _assert_close_rel(t, g, GRAD_RTOL, f"input {i}")


# ------------------------------------------------------------------ GCNII stacks
def test_chunk_of_matches_jax():
    for n in range(1, 70):
        for want in (1, 2, 3, 8, 100):
            assert tgnn._chunk_of(n, want) == jgnn._chunk_of(n, want), (n, want)


def test_gcnii_convs_layout_and_init():
    a = tgnn.GCNIIStack(6, 8, generator=torch.Generator().manual_seed(0))
    b = tgnn.GCNIIStack(6, 8, generator=torch.Generator().manual_seed(0))
    assert list(a.state_dict()) == ["convs"] and a.convs.shape == (6, 16, 8)
    assert torch.equal(a.convs, b.convs) and a.convs.abs().max().item() <= 1 / np.sqrt(8)
    thetas = np.asarray(jnp.log(0.5 / jnp.arange(1, 7) + 1.0))
    np.testing.assert_allclose([t for t, _ in a.thetas], thetas, rtol=3e-7)  # numpy's and XLA's log: an ulp apart
    np.testing.assert_allclose([r for _, r in a.thetas], 1.0 - thetas, rtol=1e-6)


# ------------------------------------------------------------------ MMGCNModule
CASES = [("packed", "atv", 2), ("unpacked", "atv", 9), ("packed", "at", 9)]  # (lstm_mode, modals, speakers)


def _kw(modals, n_speakers, lstm_mode):
    return dict(n_speakers=n_speakers, n_classes=6, modals=modals, graph_hidden_size=8, gcn_layers=6,
                gcn_chunk=3, drop_rate=0.0, lstm_mode=lstm_mode)


def _batch(modals, n_speakers, seed=0, B=3, n=2):
    """B rows, n of them dialogues of 5..16 utterances, the rest padding."""
    prefix = "meld-mmgcn" if n_speakers == 9 else "iemocap-cogmen"
    samples = j_synthetic_erc(prefix, 6, "train", n_train=n, min_len=5, max_len=16, seed=seed, **DIMS)
    return JERCBatcher(modals, 6, n_speakers, speaker_onehot=True, bucket=8, max_len=16, pad_batch_to=B)(samples)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if v is not None}


def _jax_loss(model, batch):
    def loss(params):
        logits = model.apply({"params": params}, batch, deterministic=True)
        return jtrainer.masked_cross_entropy(logits, batch["label"], batch["attention_mask"]), logits

    return loss


def _port_module(modals, n_speakers, lstm_mode, adj_impl, gcn_remat="full"):
    return tmmgcn.MMGCNModule(hidden_text=8, hidden_audio=8, hidden_visual=8, adj_impl=adj_impl,
                              gcn_remat=gcn_remat, **_kw(modals, n_speakers, lstm_mode))


@pytest.fixture(scope="module", params=CASES, ids=[f"{a}-{b}-s{c}" for a, b, c in CASES])
def jax_module_run(request):
    """(case, batch, its flax tree, per adj_impl: logits, loss and gradients)."""
    lstm_mode, modals, n_speakers = request.param
    batch = _batch(modals, n_speakers)
    kw = _kw(modals, n_speakers, lstm_mode)
    params = _np_tree(jmmgcn.MMGCNModule(adj_impl="dense", **kw).init(jax.random.PRNGKey(0), batch))["params"]
    out = {}
    for impl in ("dense", "structured"):
        model = jmmgcn.MMGCNModule(adj_impl=impl, **kw)
        with jax.default_matmul_precision("highest"):
            (loss, logits), grads = jax.jit(jax.value_and_grad(_jax_loss(model, batch), has_aux=True))(params)
        out[impl] = (np.asarray(logits), float(loss), _np_tree(grads))
    return request.param, batch, params, out


@pytest.mark.parametrize("impl", ["dense", "structured"])
def test_mmgcn_module_matches_jax(jax_module_run, impl):
    (lstm_mode, modals, n_speakers), batch, params, out = jax_module_run
    logits, loss, grads = out[impl]
    module = _port_module(modals, n_speakers, lstm_mode, impl)
    module.load_state_dict(convert.mmgcn_state(params))
    tb = _t(batch)
    got = module.eval()(tb).detach().numpy()
    assert got.shape == (3, batch["attention_mask"].shape[1], 6)
    np.testing.assert_allclose(got, logits, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got, out["dense" if impl == "structured" else "structured"][0], rtol=0,
                               atol=LOGIT_TOL)
    module.train()
    with torch.enable_grad():
        tloss = masked_cross_entropy(module(tb), tb["label"], tb["attention_mask"])
        tloss.backward()
    np.testing.assert_allclose(tloss.item(), loss, rtol=GRAD_RTOL)
    _assert_grads_close([(n, p.grad) for n, p in module.named_parameters()], convert.mmgcn_state(grads), GRAD_RTOL)


@pytest.mark.parametrize("modals", ["atv", "av", "at", "tv", "a", "v", "t"])
def test_every_modality_subset_structured_equals_dense(modals):
    """Each subset of atv builds, orders its nodes [a, v, t], and gives the
    same logits through both adjacency forms from one set of weights."""
    batch = _t(_batch(modals, 2))
    dense = _port_module(modals, 2, "packed", "dense")
    structured = _port_module(modals, 2, "packed", "structured")
    structured.load_state_dict(dense.state_dict())
    assert dense.order == [m for m in "avt" if m in modals]
    assert dense.smax_fc.weight.shape == (6, len(modals) * (200 + 8))
    with torch.no_grad():
        got, want = structured.eval()(batch).numpy(), dense.eval()(batch).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


def test_unpacked_lstm_consumes_the_padding(jax_module_run):
    """'unpacked' differs from 'packed' on a ragged batch (the backward
    direction starts in the padding), and is JAX's at lstm_mode='unpacked'."""
    (lstm_mode, modals, n_speakers), batch, params, out = jax_module_run
    other = "packed" if lstm_mode == "unpacked" else "unpacked"
    module = _port_module(modals, n_speakers, other, "dense")
    module.load_state_dict(convert.mmgcn_state(params))
    with torch.no_grad():
        got = module.eval()(_t(batch)).numpy()
    valid = batch["attention_mask"] > 0
    assert np.abs(got - out["dense"][0])[valid].max() > 1e-3


def test_parameter_count_at_full_width():
    """MMGCNParams on synthetic-cogmen-6: 712 inputs, 64 GCNII layers of 200,
    the same parameter count as the JAX module's tree."""
    p = tmmgcn.MMGCNParams()
    p.finalize(["--dataset=synthetic-cogmen-6", "--device=cpu"])
    model = tmmgcn.build(p, generator=torch.Generator().manual_seed(0))
    n = sum(t.numel() for t in model.parameters())
    batch = JERCBatcher("atv", 6, 2, speaker_onehot=True, max_len=8)(
        j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=2, min_len=4, max_len=8))
    jm = jmmgcn.MMGCNModule(n_speakers=2, n_classes=6)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))["params"]
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n == want == 5_794_006
    assert model.gcnii.convs.shape == (64, 400, 200) and model.smax_fc.weight.shape == (6, 1200)
    sd = convert.mmgcn_state(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_bad_options_raise():
    with pytest.raises(ValueError, match="adj_impl"):
        _port_module("atv", 2, "packed", "sparse")
    with pytest.raises(ValueError, match="lstm_mode"):
        _port_module("atv", 2, "masked", "dense")
    with pytest.raises(ValueError, match="remat"):
        tgnn._remat(lambda h: h, "some")


# ------------------------------------------------------------------ weights from JAX
def test_mmgcn_state_loads_both_trees(jax_module_run, tmp_path):
    (lstm_mode, modals, n_speakers), batch, params, out = jax_module_run
    kw = _kw(modals, n_speakers, lstm_mode)
    trees = {impl: _np_tree(jmmgcn.MMGCNModule(adj_impl=impl, **kw).init(jax.random.PRNGKey(1), batch))["params"]
             for impl in ("dense", "structured")}
    sds = {impl: convert.mmgcn_state(t) for impl, t in trees.items()}
    assert sds["dense"].keys() == sds["structured"].keys()
    for impl, sd in sds.items():
        for target in ("dense", "structured"):
            _port_module(modals, n_speakers, lstm_mode, target).load_state_dict(sd)  # strict
    flat = {"params/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(trees["structured"])[0]}
    np.savez(tmp_path / "v.npz", **flat)
    convert.main(["--module=mmgcn", str(tmp_path / "v.npz"), str(tmp_path / "sd.pt")])
    sd = torch.load(tmp_path / "sd.pt", weights_only=True)
    assert sd.keys() == sds["structured"].keys() and all(torch.equal(sd[k], sds["structured"][k]) for k in sd)


def test_jax_checkpoint_serves_through_the_port(jax_module_run, tmp_path):
    """The JAX Saver's file → ``load_model_state`` → the engine's logits ≡ JAX's."""
    (lstm_mode, modals, n_speakers), batch, params, out = jax_module_run
    tx = joptim.build_optim(joptim.create_optim("Adam", lr=3e-4, weight_decay=3e-5))
    state = TrainState(params=params, opt_state=tx.init(params), model_state={}, step=jnp.asarray(3))
    path = jcheckpoint.Saver(str(tmp_path)).save_model("last", state, meta={"eidx": 1})
    p = tmmgcn.MMGCNParams()
    p.finalize(["--module=mmgcn", "--dataset=synthetic-cogmen-6", "--device=cpu", f"--modality={modals}"])
    model = _port_module(modals, n_speakers, lstm_mode, "structured")
    engine = InferenceEngine(model, p, torch.device("cpu"), path, batch_size=3)
    np.testing.assert_allclose(engine.logits(batch), out["structured"][0], rtol=0, atol=LOGIT_TOL)


# ------------------------------------------------------------------ training
def _port_trainer(*extra, drop_rate=0.0):
    p = tmmgcn.MMGCNParams()
    p.finalize(SMALL + list(extra))
    p.drop_rate = drop_rate
    trainer = tmmgcn.MMGCNTrainer(p)
    trainer.log = lambda msg: None
    trainer.initialize()
    return trainer


def _train_batches(n=3):
    batcher = JERCBatcher("atv", 6, 2, speaker_onehot=True, bucket=16, max_len=16, pad_batch_to=3)
    return [batcher(j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=2, min_len=5, max_len=16, seed=s))
            for s in range(n)]


@pytest.mark.parametrize("impl", ["dense", "structured"])
def test_three_step_trajectory_matches_jax(impl):
    """Adam 3e-4 with L2 3e-5 in the gradient, no clip and no class weights,
    on the full input width (712) of synthetic-cogmen-6."""
    batches = _train_batches()
    trainer = _port_trainer(f"--adj_impl={impl}")
    assert trainer.grad_clip_norm is None and trainer.lr_sche is None and trainer.class_weights is None
    jp = jmmgcn.MMGCNParams()
    assert (jp.optim.lr, jp.optim.weight_decay) == (trainer.params.optim.lr, trainer.params.optim.weight_decay)
    jm = jmmgcn.MMGCNModule(n_speakers=2, n_classes=6, graph_hidden_size=8, gcn_layers=4, gcn_chunk=2,
                            drop_rate=0.0, adj_impl=impl)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), batches[0]))["params"]
    trainer.model.load_state_dict(convert.mmgcn_state(params))
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
        np.testing.assert_allclose(mets["Lall"].item(), float(loss), rtol=GRAD_RTOL, err_msg=f"loss {i}")
        np.testing.assert_allclose(mets["gnorm"].item(), float(gnorm), rtol=GRAD_RTOL, err_msg=f"gnorm {i}")
        if i == 0:
            _assert_grads_close([(n, p.grad) for n, p in trainer.model.named_parameters()],
                                convert.mmgcn_state(_np_tree(grads)), GRAD_RTOL, float(gnorm))
    want = convert.mmgcn_state(_np_tree(params))
    for name, t in trainer.model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-5, err_msg=name)
