"""The port's MMIN data layer and building blocks ≡ the JAX package's.

Data: ``synthetic_mmin`` array for array per split, ``MMINBatcher`` batch
for batch with the Missing patterns drawn from the same
``numpy_rng("missing")`` generator (``*_reverse`` and ``missing_type``
included), and ``iemocap_mmin_4`` on a fabricated h5/npy tree.

Components at small size (audio [4, 12, 16], visual [4, 10, 20], text
[4, 8, 32]; flax infers the widths, the port is given them): ``TextCNN``,
``LSTMEncoder`` in its three readouts, ``Classifier`` and ``ResidualAE``.
The same numpy inputs and converted weights (drawn from a seed in the
flax tree's shapes, no bias zero) go through JAX (float32, matmul
precision highest, ``deterministic=True``) and the port (dropout off):
outputs within 1e-5 absolute, and the gradients of a fixed random
projection of the outputs within 1e-5 of max(1, max |g|) per parameter.
The three modules are held the same way in ``test_torch_mmin_train.py``
and ``test_torch_mmin_miss.py``.  Here also: the full-width parameter
counts against the JAX trees' (from shapes only), the converters from the
flat ``.npz`` and the convert CLI, and ``BiRNN``'s one-direction unpacked
mode against ``nn.LSTM``.
"""

import numpy as np
import pytest
import torch

import jax
from flax import traverse_util

from erc_tpu.data import mmin as jmmin
from erc_tpu.models import mmin_models as jm
from erc_tpu_torch import convert
from erc_tpu_torch.core.seed import RngPool
from erc_tpu_torch.data import mmin as tmmin
from erc_tpu_torch.data.registry import dataset_has_val, pick_datas
from erc_tpu_torch.models import mmin_models as tm
from erc_tpu_torch.ops.rnn import BiRNN
from test_torch_mmin_train import draw_params
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-5
NARROW = {"audio_feature": (12, 16), "visual_feature": (10, 20), "text_feature": (8, 32)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {"/".join(k): v for k, v in traverse_util.flatten_dict(tree).items()}


def _assert_grads_close(got: dict, want: dict):
    """Every gradient within 1e-5 of max(1, max |want|), elementwise."""
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        g = g.numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * max(1.0, float(np.abs(w).max())), err_msg=name)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_synthetic_mmin_matches_jax(split):
    got, want = tmmin.synthetic_mmin(4, split, n_train=6, n_test=5), jmmin.synthetic_mmin(4, split, n_train=6,
                                                                                           n_test=5)
    assert len(got) == len(want) == (6 if split == "train" else 5)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["label"] == w["label"] and g["name"] == w["name"]
        for key in ("visual_feature", "text_feature", "audio_feature"):
            assert g[key].dtype == np.float32
            np.testing.assert_array_equal(g[key], w[key])
    # the registry's name gives the same utterances, with MMIN's real val split
    assert dataset_has_val("synthetic-mmin-4") and dataset_has_val("iemocap-mmin-4")
    full = pick_datas(None, "synthetic-mmin-4", split=split)
    assert len(full) == (256 if split == "train" else 64)
    np.testing.assert_array_equal(full[0]["text_feature"], jmmin.synthetic_mmin(4, split)[0]["text_feature"])


@pytest.mark.parametrize("has_miss,pad_to,max_audio_len", [(True, 8, 64), (False, None, 40), (True, None, 128)])
def test_batcher_matches_jax_batch_for_batch(has_miss, pad_to, max_audio_len):
    """Three batches from one generator each side (the generator advances
    batch by batch): every key equal, the Missing patterns included."""
    samples = jmmin.synthetic_mmin(4, "train", n_train=18)
    pool = RngPool(3)
    kw = dict(max_audio_len=max_audio_len, has_miss=has_miss, pad_batch_to=pad_to)
    tb = tmmin.MMINBatcher(rng=pool.numpy_rng("missing"), **kw)
    jb = jmmin.MMINBatcher(rng=pool.numpy_rng("missing"), **kw)
    for s in range(0, 18, 6):
        got, want = tb(samples[s: s + 6]), jb(samples[s: s + 6])
        assert got.keys() == want.keys()
        assert ("missing_type" in got) == has_miss and ("audio_feature_reverse" in got) == has_miss
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(tmmin.MISSING_TYPES, jmmin.MISSING_TYPES)


def test_iemocap_mmin_4_reader_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    base = tmp_path / "MMIN2021" / "IEMOCAP_features_2021"
    r = np.random.default_rng(0)
    names = {"trn": ["Ses01F_a", "Ses01F_b", "Ses01M_c"], "val": ["Ses02F_d"], "tst": ["Ses03M_e", "Ses03M_f"]}
    every = [n for v in names.values() for n in v]
    for rel, shape in (("V/denseface.h5", (50, 6)), ("A/comparE.h5", None), ("L/bert_large.h5", (22, 5))):
        (base / rel).parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(base / rel, "w") as f:
            for i, n in enumerate(every):
                f[n] = r.normal(size=shape or (20 + i, 4)).astype(np.float32)
    (base / "target" / "1").mkdir(parents=True)
    for tag, ns in names.items():
        np.save(base / "target" / "1" / f"{tag}_label.npy", np.eye(4, dtype=np.float32)[r.integers(0, 4, len(ns))])
        np.save(base / "target" / "1" / f"{tag}_int2name.npy", np.array([[n.encode()] for n in ns]))
    for split in ("train", "val", "test"):
        got = pick_datas(str(tmp_path), "iemocap-mmin-4", split=split)
        want = jmmin.iemocap_mmin_4(str(tmp_path), split)
        assert [g["name"] for g in got] == [w["name"] for w in want] == names[{"train": "trn", "val": "val",
                                                                               "test": "tst"}[split]]
        for g, w in zip(got, want):
            assert g["label"] == w["label"]
            for key in ("visual_feature", "text_feature", "audio_feature"):
                np.testing.assert_array_equal(g[key], w[key])


# ------------------------------------------------------------------ components
def _inputs(seed=0, B=4):
    r = np.random.default_rng(seed)
    return {k: r.normal(size=(B, *s)).astype(np.float32) for k, s in NARROW.items()}


def _held(jmodule, tmodule, to_state, x, n_out=1):
    """Forward ≡ JAX (deterministic) and the gradients of Σ R·outputs ≡ jax.grad."""
    params = draw_params(jmodule, x, 1)
    proj = np.random.default_rng(7)

    def outputs(p):
        out = jmodule.apply({"params": p}, x, deterministic=True)
        return out if isinstance(out, tuple) else (out,)

    shapes = [o.shape for o in jax.eval_shape(outputs, params)]
    weights = [proj.normal(size=s).astype(np.float32) for s in shapes]

    def loss(p):
        outs = outputs(p)
        return sum((o * w).sum() for o, w in zip(outs, weights)), outs

    with jax.default_matmul_precision("highest"):
        (_, outs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tmodule.load_state_dict(to_state(params))
    tmodule.train()  # dropout is off: train mode runs the same math
    with torch.enable_grad():
        got = tmodule(torch.from_numpy(x))
        got = got if isinstance(got, tuple) else (got,)
        sum((g * torch.from_numpy(w)).sum() for g, w in zip(got, weights)).backward()
    assert len(got) == len(outs) == n_out
    for g, o in zip(got, outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(o), rtol=0, atol=ATOL)
    _assert_grads_close({n: p.grad for n, p in tmodule.named_parameters()}, to_state(_np_tree(grads)))
    return params, outs


def _off(module):
    for m in module.modules():
        if hasattr(m, "p") and isinstance(m.p, float):
            m.p = 0.0
    return module


def test_text_cnn_matches_jax():
    x = _inputs()["text_feature"]
    _held(jm.TextCNN(128), _off(tm.TextCNN(32, 128)), lambda p: {
        **{f"conv{k}.{n}": v for k in (3, 4, 5) for n, v in convert.conv1d_state(p[f"conv{k}"]).items()},
        **{f"embd.{n}": v for n, v in convert.linear_state(p["embd"]).items()}}, x)


@pytest.mark.parametrize("embd_method", ["maxpool", "last", "attention"])
def test_lstm_encoder_matches_jax_in_every_readout(embd_method):
    """One direction over every step, the zero-padded tail included (rows 1–3
    end in zeros); the attention readout's weights over its size-1 axis are
    all 1, so its parameters get zero gradients in both packages."""
    x = _inputs()["audio_feature"]
    x[1:, 7:] = 0.0

    def to_state(p):
        sd = {f"rnn.{k}": v for k, v in convert.birnn_state(p["rnn"]).items()}
        if "attention_layer" in p:
            sd.update({f"attention_layer.{k}": v for k, v in convert.linear_state(p["attention_layer"]).items()})
            sd["attention_vector_weight"] = torch.from_numpy(np.asarray(p["attention_vector_weight"]).copy())
        return sd

    module = tm.LSTMEncoder(16, 24, embd_method)
    params, (out,) = _held(jm.LSTMEncoder(24, embd_method), module, to_state, x)
    if embd_method == "attention":
        assert float(module.attention_layer.weight.grad.abs().max()) == 0.0
        assert float(module.attention_vector_weight.grad.abs().max()) == 0.0
        assert tuple(module.attention_vector_weight.shape) == (24, 1)


def test_classifier_matches_jax():
    x = np.random.default_rng(2).normal(size=(4, 24)).astype(np.float32)
    params, _ = _held(jm.Classifier((16, 8), 4), _off(tm.Classifier(24, (16, 8), 4)), convert.dense_tree_state,
                      x, n_out=2)
    assert set(params) == {"fc0", "fc1", "fc_out"}


def test_residual_ae_matches_jax():
    x = np.random.default_rng(3).normal(size=(4, 24)).astype(np.float32)
    params, (_, latents) = _held(jm.ResidualAE((32, 16, 8), 3, 24), tm.ResidualAE((32, 16, 8), 3, 24),
                                 convert.dense_tree_state, x, n_out=2)
    assert latents.shape == (4, 3 * 8)
    assert {"enc2_2", "dec2_2", "trans0", "trans1"} <= set(params)


def test_birnn_one_direction_unpacked_is_plain_lstm():
    rnn = BiRNN(6, 5, cell="lstm", bidirectional=False, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 7, 6, generator=torch.Generator().manual_seed(1))
    want, _ = rnn.layers[0](x)
    assert torch.equal(rnn(x), want) and want.shape == (3, 7, 5)
    assert set(dict(rnn.named_parameters())) == {f"layers.0.{k}_l0" for k in ("weight_ih", "weight_hh", "bias_ih",
                                                                               "bias_hh")}


# ------------------------------------------------------------------ full width
FULL = {"audio_feature": (128, 130), "visual_feature": (50, 342), "text_feature": (22, 1024)}


@pytest.mark.parametrize("name,want", [("MMINBaseModule", 2_063_620), ("MMINMissModule", 5_444_228),
                                       ("MMINMiss2Module", 4_127_240)])
def test_parameter_counts_at_full_width(name, want, tmp_path):
    """The JAX tree's count (from shapes only), the port's, and the converted
    state dict's shapes; the converter from the flat ``.npz`` and the CLI."""
    batch = {k: np.zeros((2, *s), np.float32) for k, s in FULL.items()}
    batch.update({f"{k}_reverse": v for k, v in batch.items()})
    shapes = jax.eval_shape(lambda: getattr(jm, name)(n_classes=4).init(jax.random.PRNGKey(0), batch))["params"]
    module = getattr(tm, name)(4, generator=torch.Generator().manual_seed(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)) == want
    assert sum(t.numel() for t in module.parameters()) == want
    key = {"MMINBaseModule": "mmin_base", "MMINMissModule": "mmin_miss", "MMINMiss2Module": "mmin_miss2"}[name]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = convert.STATES[key]({"params": zeros})
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in module.state_dict().items()}
    np.savez(tmp_path / "v.npz", **{f"params/{k}": v for k, v in _flat(zeros).items()})
    convert.main([f"--module={key}", str(tmp_path / "v.npz"), str(tmp_path / "sd.pt")])
    module.load_state_dict(torch.load(tmp_path / "sd.pt", weights_only=True))
    assert not any(t.detach().any() for t in module.parameters())
