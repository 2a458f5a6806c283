"""Port's DAG-ERC (erc_tpu_torch.models.dagerc) ≡ the JAX package's.

Small widths (D 8, chunk 4, 2 layers; B 3 with an all-padding dialogue and
L not a multiple of the chunk): DAGLayer, DAGStack in both tails (eager, and
K3 through its plain version on CPU tensors) against JAX's DAGStack with
impl='xla' and with impl_eval='pallas' (interpret mode), and
AttentiveNodeFeatures; tolerance 1e-5.  Full width (712 → 300, 4 layers,
chunk 16; B 3, L 32, two blocks) against JAX impl='xla' within 1e-4.  The
serving path: flax tree → npz → ``python -m erc_tpu_torch.convert
--module=dagerc`` → InferenceEngine on the CPU, against the JAX engine.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from erc_tpu.data.collate import ERCBatcher as JERCBatcher
from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu.models import dagerc as jdagerc
from erc_tpu.ops import graphs as jgraphs
from erc_tpu_torch import convert
from erc_tpu_torch.models import dagerc as tdagerc
from erc_tpu_torch.ops.kernels import dag_block as tdb
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
ATOL_FULL = 1e-4

torch.set_grad_enabled(False)


def _graph_inputs(B=3, L=10, D=8, lengths=(10, 7, 0), seed=0):
    """H0 [B, L, D], adj, s_mask as numpy; dialogue 2 is all padding."""
    r = np.random.default_rng(seed)
    H0 = r.normal(size=(B, L, D)).astype(np.float32)
    spk = r.integers(0, 2, (B, L)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    adj = np.asarray(jgraphs.dag_adjacency(jnp.asarray(spk), jnp.asarray(lengths), L, 1))
    s_mask = np.asarray(jgraphs.same_speaker_mask(jnp.asarray(spk)))
    return H0, adj, s_mask


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _state(params, prefix=""):
    return {prefix + k: _t(v) for k, v in params.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_dag_layer_matches_jax():
    H0, adj, sm = _graph_inputs()
    jl = jdagerc.DAGLayer(8)
    variables = jl.init(jax.random.PRNGKey(0), H0, adj, sm)
    with jax.default_matmul_precision("highest"):
        want = jl.apply(variables, H0, adj, sm)
    tl = tdagerc.DAGLayer(8)
    tl.load_state_dict(_state(variables["params"]))
    _close(tl(_t(H0), _t(adj), _t(sm)), want)


@pytest.fixture(scope="module")
def stack_case():
    """(inputs, flax params) of a 2-layer DAGStack, D 8, chunk 4, L 10."""
    H0, adj, sm = _graph_inputs()
    params = jdagerc.DAGStack(8, 2, chunk=4, impl="xla").init(jax.random.PRNGKey(1), H0, adj, sm)
    return (H0, adj, sm), params


@pytest.mark.parametrize("jax_eval", ["", "pallas"], ids=["jax-xla", "jax-pallas-interpret"])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_dag_stack_matches_jax(stack_case, impl, jax_eval):
    (H0, adj, sm), variables = stack_case
    with jax.default_matmul_precision("highest"):
        want = jdagerc.DAGStack(8, 2, chunk=4, impl="xla", impl_eval=jax_eval).apply(
            variables, H0, adj, sm, deterministic=True)
    stack = tdagerc.DAGStack(8, 2, chunk=4, impl=impl).eval()
    stack.load_state_dict(_state(variables["params"]))
    tdb.reset_launches()
    got = stack(_t(H0), _t(adj), _t(sm))
    assert tdb.launches["dag_block"] == 0  # CPU tensors: the plain version
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (3, 10, 8)
        _close(g, w)


def test_dag_stack_equals_chained_layers_in_port(stack_case):
    """The blockwise form ≡ the per-step oracle on the same weights."""
    (H0, adj, sm), variables = stack_case
    stack = tdagerc.DAGStack(8, 2, chunk=4, impl="kernel").eval()
    stack.load_state_dict(_state(variables["params"]))
    h = _t(H0)
    for l, got in enumerate(stack(h, _t(adj), _t(sm))):
        layer = tdagerc.DAGLayer(8)
        layer.load_state_dict({k[len(f"layer_{l}_"):]: v for k, v in stack.state_dict().items()
                               if k.startswith(f"layer_{l}_")})
        h = layer(h, _t(adj), _t(sm))
        _close(got, h.numpy())


def test_dag_stack_training_form_is_eager_and_differentiable(stack_case):
    """Both training forms differentiate: the eager form through autograd, the
    kernel form through K3/K4 (their plain versions on CPU tensors), with the
    same gradients; remat changes none.  The loss reads only the dialogues'
    positions (lengths 10, 7, 0), as DAG-ERC's masked loss does: K4's
    gradient contract leaves padding rows, which have no predecessor, out."""
    (H0, adj, sm), variables = stack_case
    valid = _t((np.arange(10)[None] < np.asarray([10, 7, 0])[:, None]).astype(np.float32))
    weight = _t(np.random.default_rng(7).normal(size=(3, 10, 8)).astype(np.float32)) * valid[..., None]

    def grads(impl, remat):
        stack = tdagerc.DAGStack(8, 2, chunk=4, impl=impl, impl_eval="kernel", remat=remat).train()
        stack.load_state_dict(_state(variables["params"]))
        with torch.enable_grad():
            sum((o * weight).sum() for o in stack(_t(H0), _t(adj), _t(sm))).backward()
        return {n: p.grad for n, p in stack.named_parameters()}

    want = grads("eager", False)
    assert all(g is not None and torch.isfinite(g).all() for g in want.values())
    for impl, remat in (("kernel", False), ("kernel", True), ("eager", True)):
        got = grads(impl, remat)
        for name, g in want.items():
            np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=0,
                                       atol=ATOL * max(1.0, g.abs().max().item()), err_msg=name)


@pytest.mark.parametrize("kind", ["global", "past"])
def test_attentive_node_features_match_jax(kind):
    r = np.random.default_rng(3)
    feats = r.normal(size=(3, 6, 10)).astype(np.float32)
    mask = (np.arange(6)[None] < np.asarray([6, 2, 0])[:, None]).astype(np.float32)
    jm = jdagerc.AttentiveNodeFeatures()
    variables = jm.init(jax.random.PRNGKey(2), feats, mask, kind)
    with jax.default_matmul_precision("highest"):
        want = jm.apply(variables, feats, mask, kind)
    tm = tdagerc.AttentiveNodeFeatures(10)
    tm.transform.load_state_dict(convert.linear_state(variables["params"]["transform"]))
    _close(tm(_t(feats), _t(mask), kind), want)


def _batch(B, max_len, seed, bucket=16):
    samples = j_synthetic_erc("iemocap-cogmen", 6, n_train=B, min_len=5, max_len=max_len, seed=seed)
    return JERCBatcher("atv", 6, 2, speaker_onehot=True, bucket=bucket, max_len=max_len)(samples)


def _t_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if v is not None}


SMALL = dict(emb_dim=712, n_classes=6, gnn_layers=2, hidden_dim=8, chunk=4)


@pytest.mark.parametrize("fused,nodal", [(True, "global"), (False, "past")])
def test_dagerc_module_small_matches_jax(fused, nodal):
    batch = _batch(3, 14, seed=4, bucket=0)
    tm = tdagerc.DAGERCModule(fused=fused, impl="kernel", nodal_att_type=nodal,
                              generator=torch.Generator().manual_seed(3), **SMALL).eval()
    params = _flax_params(tm.state_dict())
    converted = convert.dagerc_state(params)  # the converter round-trips
    assert all(torch.equal(converted[k], v) for k, v in tm.state_dict().items())
    jm = jdagerc.DAGERCModule(fused=fused, impl="xla", nodal_att_type=nodal, **SMALL)
    with jax.default_matmul_precision("highest"):
        want = jm.apply({"params": params}, batch, deterministic=True)
    _close(tm(_t_batch(batch)), want)


def _flax_params(state):
    """The flax params of a DAGERCModule from the port's state dict (the
    inverse of convert.dagerc_state)."""
    tree = {}
    for key, v in state.items():
        *path, leaf = key.split(".")
        a = v.numpy()
        if path[0] == "layers":  # layers.{l}.name → layer_{l}/name
            path = [f"layer_{path[1]}"]
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if path[0] == "stack" or path[0].startswith("layer_"):
            node[leaf] = a
        else:  # Linear {weight [out, in], bias} → Dense {kernel [in, out], bias}
            node["kernel" if leaf == "weight" else "bias"] = a.T if leaf == "weight" else a
    return tree


def _full_width_port(tail):
    """DAGERCParams at synthetic-cogmen-6: 712 → 300, 4 layers, chunk 16; in
    eval the block tail is K3 (``tail='kernel'``: dag_impl=auto) or its plain
    version (``'eager'``)."""
    p = tdagerc.DAGERCParams()
    p.dataset, p.dag_impl = "synthetic-cogmen-6", {"kernel": "auto", "eager": "eager"}[tail]
    p.iparams()
    return tdagerc.build(p, generator=torch.Generator().manual_seed(4)).eval()


@pytest.fixture(scope="module")
def full_width():
    """(batch, port weights, JAX logits) at full width; B 3, L 32 (two blocks)."""
    batch = _batch(3, 32, seed=5)
    assert batch["input_tensor"].shape[:2] == (3, 32)
    state = _full_width_port("kernel").state_dict()
    jm = jdagerc.DAGERCModule(emb_dim=712, n_classes=6, impl="xla")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply({"params": _flax_params(state)}, batch, deterministic=True))
    return batch, state, want


@pytest.mark.parametrize("impl", ["kernel", "eager"])
def test_dagerc_full_width_matches_jax(full_width, impl):
    batch, state, want = full_width
    tm = _full_width_port(impl)
    assert sum(x.numel() for x in tm.parameters()) == 6_026_710
    converted = convert.dagerc_state(_flax_params(state))  # the converter round-trips
    assert converted.keys() == state.keys() and all(torch.equal(converted[k], state[k]) for k in state)
    tm.load_state_dict(converted)
    got = tm(_t_batch(batch)).numpy()
    assert got.shape == want.shape == (3, 32, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_FULL)


def test_params_and_dag_impl_match_jax():
    for ds, reimpl in (("synthetic-cogmen-6", False), ("iemocap-cogmen-6", True), ("meld-mmgcn-7", True),
                       ("dailydialog-x-7", True)):
        j, t = jdagerc.DAGERCParams(), tdagerc.DAGERCParams()
        for p in (j, t):
            p.from_args([f"--dataset={ds}", f"--reimplement={reimpl}"])
            p.iparams()
        for key in ("hidden_all", "n_speakers", "class_names", "gnn_layers", "hidden_dim", "windowp",
                    "dag_chunk", "dropout", "speaker_onehot", "optim.lr", "optim.name",
                    "train.batch_size", "epoch", "nodal_att_type"):
            assert t[key] == j[key], (ds, key)
    assert tdagerc.resolve_dag_impl("auto") == ("eager", "kernel")
    assert jdagerc.resolve_dag_impl("auto", "tpu", 1) == ("xla", "pallas")
    assert tdagerc.resolve_dag_impl("eager") == ("eager", "eager")
    # `kernel` is the port's name for JAX's `pallas`: K3/K4 in training and eval
    assert tdagerc.resolve_dag_impl("kernel") == ("kernel", "kernel")
    assert jdagerc.resolve_dag_impl("pallas", "tpu", 1) == ("pallas", "pallas")
    p = tdagerc.DAGERCParams()
    p.from_args(["--dag_impl=kernel"])
    assert p.dag_impl == "kernel" and p.dag_remat is True and jdagerc.DAGERCParams().dag_remat is True
    with pytest.raises(ValueError):
        tdagerc.DAGERCParams().from_args(["--dag_impl=pallas"])
    with pytest.raises(ValueError):
        tdagerc.resolve_dag_impl("pallas")


def test_npz_conversion_serves_jax_engine_weights(tmp_path):
    """JAX engine → flat npz → `python -m erc_tpu_torch.convert --module=dagerc`
    → the port's engine on the CPU: the same preds, logits within 1e-5."""
    from erc_tpu.serve import InferenceEngine as JInferenceEngine
    from erc_tpu_torch.serve import InferenceEngine

    kw = dict(dataset="synthetic-cogmen-6", max_seq_len=16, hidden_dim=8, gnn_layers=2, dag_chunk=4,
              nodal_att_type="global")
    old = os.environ.get("ERC_TPU_EXPROOT")
    os.environ["ERC_TPU_EXPROOT"] = str(tmp_path / "exp")
    try:
        jeng = JInferenceEngine.from_module("dagerc", heartbeat=False, matmul_precision="highest", **kw)
    finally:
        if old is None:
            os.environ.pop("ERC_TPU_EXPROOT", None)
        else:
            os.environ["ERC_TPU_EXPROOT"] = old
    params = jax.tree_util.tree_map(np.asarray, {"params": jeng.trainer.state.params})
    np.savez(tmp_path / "vars.npz", **traverse_util.flatten_dict(params, sep="/"))
    res = subprocess.run([sys.executable, "-m", "erc_tpu_torch.convert", "--module=dagerc",
                          str(tmp_path / "vars.npz"), str(tmp_path / "dagerc.pt")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    teng = InferenceEngine.from_module("dagerc", str(tmp_path / "dagerc.pt"), batch_size=jeng.batch_size,
                                       device="cpu", **kw)
    dialogues = lambda: j_synthetic_erc("iemocap-cogmen", 6, n_train=3, min_len=4, max_len=12, seed=6)  # noqa: E731
    want, got = jeng.predict(dialogues()), teng.predict(dialogues())
    for g, w in zip(got, want):
        assert g["pred"] == w["pred"] and g["labels"] == w["labels"]
        np.testing.assert_allclose(np.asarray(g["probs"]), np.asarray(w["probs"]), rtol=0, atol=ATOL)
    batch = teng.batcher(dialogues())
    jlogits = np.asarray(jeng.trainer._eval_fn(jeng.trainer.state, batch))
    np.testing.assert_allclose(teng.logits(batch), jlogits, rtol=0, atol=ATOL)
