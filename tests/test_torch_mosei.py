"""The port's MOSEI data layer ≡ the JAX package's: ``synthetic_mosei``, the
readers (``mosei_adapted``, ``mosei_cim``) on dumps fabricated in
``tmp_path``, the registry's ``mosei-*`` names and the params grammar for
each, ``ERCBatcher``'s multitask labels, ``mosei_multilabel_summary`` (the
JAX package's calls sklearn: within 1e-12) and the ``cogmen_mosei`` alias
(logits within 1e-5 at every position on ``synthetic-mosei-6`` batches of
L ≤ 9, hidden 8, from the module and through ``InferenceEngine``).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from erc_tpu.data import readers as jreaders
from erc_tpu.data import registry as jregistry
from erc_tpu.data.collate import ERCBatcher as JERCBatcher
from erc_tpu.data.synthetic import synthetic_mosei as j_synthetic_mosei
from erc_tpu.models import cogmen as jcogmen
from erc_tpu.models import cogmen_mosei as jcogmen_mosei
from erc_tpu.train import metrics as jmetrics
from erc_tpu_torch import convert
from erc_tpu_torch.data import readers as treaders
from erc_tpu_torch.data import registry as tregistry
from erc_tpu_torch.data.collate import ERCBatcher
from erc_tpu_torch.data.synthetic import synthetic_mosei
from erc_tpu_torch.models import cogmen_mosei as tcogmen_mosei
from erc_tpu_torch.models.base import MMBaseParams
from erc_tpu_torch.serve import InferenceEngine
from erc_tpu_torch.train import metrics as tmetrics
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

MOSEI_VIEWS = ("mosei-text-any-7", "mosei-interval-any-7")  # extraction views: maps for preprocessing
MOSEI_NAMES = sorted(n for n in jregistry.regist_data if n.startswith("mosei-") and n not in MOSEI_VIEWS)


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


# ------------------------------------------------------------------ synthetic
@pytest.mark.parametrize("n_classes", [2, 6, 7])
@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_mosei_matches_jax(n_classes, split, seed):
    kw = dict(n_train=4, n_test=3, min_len=3, max_len=9)
    _assert_samples_equal(synthetic_mosei(n_classes, split, seed, **kw), j_synthetic_mosei(n_classes, split, seed, **kw))


def test_registry_synthetic_mosei_matches_jax():
    for split in ("train", "val", "test"):
        got = tregistry.pick_datas(None, "synthetic-mosei-2", split)
        assert len(got) == {"train": 120, "val": 31, "test": 31}[split]
        _assert_samples_equal(got[:3], jregistry.pick_datas(None, "synthetic-mosei-2", split)[:3])
    assert tregistry.dataset_has_val("synthetic-mosei-2") and tregistry.dataset_has_val("mosei-cim-2")
    # synthetic-mmin-N resolves to MMIN's generator (not MOSEI's), as in JAX
    got, want = (m.pick_datas(None, "synthetic-mmin-4", "val")[0] for m in (tregistry, jregistry))
    assert got["name"] == want["name"] == "utt_val_0" and (got["audio_feature"] == want["audio_feature"]).all()


# ------------------------------------------------------------------ readers
def _mk_adapted(root):
    """MOSEI.adpated.pkl (13-tuple) and its side files: 4 train videos, 2
    test, 2 valid; video t1 has no non-zero sentiment (sent_2+ drops it),
    v0 some zeros, t0 an utterance with no emotion (class 6)."""
    rng = np.random.default_rng(7)
    ids = {"train": ["t0", "t1", "t2", "t3"], "test": ["s0", "s1"], "valid": ["v0", "v1"]}
    keys = [k for v in ids.values() for k in v]
    lens = {k: int(rng.integers(2, 6)) for k in keys}
    emo = {}
    for k in keys:
        e = np.zeros((lens[k], 7))
        e[:, 0] = np.round(rng.uniform(-3, 3, lens[k]) * 2) / 2  # sentiment, including exact bin edges
        e[:, 1:] = rng.integers(0, 2, (lens[k], 6)) * rng.uniform(0.3, 3, (lens[k], 6))
        emo[k] = e
    emo["t1"][:, 0] = 0.0
    emo["v0"][0, 0] = 0.0
    emo["t0"][1, 1:] = 0.0
    feats = lambda d: {k: rng.normal(size=(lens[k], d)).astype(np.float32) for k in keys}  # noqa: E731
    pkl = (ids["train"], ids["test"], ids["valid"], {k: [[0.0, 1.0]] * lens[k] for k in keys}, emo, feats(74),
           feats(300), feats(35), {k: [f"{k} utt {i}" for i in range(lens[k])] for k in keys}, [], [], [], [])
    side = {"MOSEI.adpated.pkl": pkl, "sbert_map.pkl": feats(768), "fbank480.pkl": feats(640),
            "MOSEI.is10.pkl": feats(1584), "balanced_train_id.pkl": ["t2", "t0"]}
    for name, obj in side.items():
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(obj, f)


def _mk_cim(root, valid_ids=True):
    """CIM/{text,video,audio}.npz: 3 videos a split, padded to 6 utterances,
    of lengths 4, 6 and 2 (as tests/test_readers.py builds them, with ragged
    lengths); without ``valid_idName`` where valid_ids is False."""
    rng = np.random.default_rng(3)
    os.makedirs(os.path.join(root, "CIM"), exist_ok=True)
    n, Lmax = 3, 6
    text = {}
    for tag in ("train", "valid", "test"):
        text.update({f"{tag}_length": np.array([4, 6, 2]),
                     f"{tag}EmoLabel": rng.integers(0, 2, (n, Lmax, 6)).astype(float),
                     f"{tag}SentiLabel": np.round(rng.uniform(-3, 3, (n, Lmax, 1)) * 2) / 2,
                     f"{tag}_data": rng.normal(size=(n, Lmax, 300)).astype(np.float32)})
        if tag != "valid" or valid_ids:
            text[f"{tag}_idName"] = np.array([f"{tag}{i}" for i in range(n)])
    np.savez(os.path.join(root, "CIM/text.npz"), **text)
    for name, d in (("video", 35), ("audio", 74)):
        np.savez(os.path.join(root, f"CIM/{name}.npz"),
                 **{f"{t}_data": rng.normal(size=(n, Lmax, d)).astype(np.float64) for t in ("train", "valid", "test")})


@pytest.mark.parametrize("label_type", ["emo", "multi", "sent_2", "sent_2+", "sent_7"])
@pytest.mark.parametrize("audio, text, balance", [(None, None, False), (None, "sbert", False),
                                                  ("fbank", "sbert", True), ("is10", "sbert", False)])
def test_mosei_adapted_matches_jax(tmp_path, label_type, audio, text, balance):
    _mk_adapted(str(tmp_path))
    for split in ("train", "val", "test"):
        kw = dict(audio=audio, text=text, label_type=label_type, balance=balance)
        got = treaders.mosei_adapted(str(tmp_path), split, **kw)
        _assert_samples_equal(got, jreaders.mosei_adapted(str(tmp_path), split, **kw))
        if split == "train":
            assert len(got) == (3 if label_type == "sent_2+" else 4) + (2 if balance else 0)
    with pytest.raises(NotImplementedError):
        treaders.mosei_adapted(str(tmp_path), "train", label_type="sent_3")


@pytest.mark.parametrize("valid_ids", [True, False], ids=["valid_idName", "train_idName fallback"])
@pytest.mark.parametrize("audio", [None, "pad80"])
def test_mosei_cim_matches_jax(tmp_path, valid_ids, audio):
    _mk_cim(str(tmp_path), valid_ids)
    for split in ("train", "val", "test"):
        got = treaders.mosei_cim(str(tmp_path), split, audio=audio)
        _assert_samples_equal(got, jreaders.mosei_cim(str(tmp_path), split, audio=audio))
        assert [s["audio"].shape for s in got] == [(n, 80 if audio else 74) for n in (4, 6, 2)]
    assert treaders.mosei_cim(str(tmp_path), "val")[0]["ids"] == ("valid0" if valid_ids else "train0")
    with pytest.raises(NotImplementedError):
        treaders.mosei_cim(str(tmp_path), "dev")


def test_registry_mosei_names_match_jax(tmp_path, monkeypatch):
    """The same names with the same reader arguments; read through
    ``get_root`` (``ERC_TPU_DATA_ROOT``/mosei) they give JAX's samples."""
    root = tmp_path / "mosei"
    root.mkdir()
    _mk_adapted(str(root))
    _mk_cim(str(root))
    monkeypatch.setenv("ERC_TPU_DATA_ROOT", str(tmp_path))
    assert sorted(n for n in tregistry.regist_data if n.startswith("mosei-")) == MOSEI_NAMES
    assert len(MOSEI_NAMES) == 14
    for name in MOSEI_NAMES:
        t, j = tregistry.regist_data[name], jregistry.regist_data[name]
        assert getattr(t, "keywords", {}) == getattr(j, "keywords", {}), name
        assert tregistry.get_root(name) == str(root) and tregistry.dataset_has_val(name)
        for split in ("train", "val", "test"):
            _assert_samples_equal(tregistry.pick_datas(str(root), name, split),
                                  jregistry.pick_datas(str(root), name, split))
    for name in MOSEI_VIEWS:  # the extraction views: the adapted pickle's sentence and interval maps
        assert name in tregistry.extraction_views and tregistry.get_root(name) == str(root)
        got, want = tregistry.pick_datas(str(root), name), jregistry.pick_datas(str(root), name)
        assert list(got) == list(want) == ["t0", "t1", "t2", "t3", "s0", "s1", "v0", "v1"]
        for k in want:
            assert got[k] == want[k], (name, k)


@pytest.mark.parametrize("name", MOSEI_NAMES + ["synthetic-mosei-2", "synthetic-mosei-6", "mosei-cim-pad80-2"])
def test_params_grammar_matches_jax(name):
    from erc_tpu.models.base import MMBaseParams as JParams

    j, t = JParams(), MMBaseParams()
    for p in (j, t):
        p.from_args([f"--dataset={name}"])
        p.iparams()
    for key in ("hidden_text", "hidden_audio", "hidden_visual", "hidden_all", "class_names", "n_speakers",
                "mosei_metric", "select_on", "eval_val"):
        assert t[key] == j[key], (name, key)
    assert t.n_classes == j.n_classes


# ------------------------------------------------------------------ batching
def test_batcher_multitask_labels_match_jax(tmp_path):
    """emo_label / senti2_label of MOSEI samples, cut at max_len and padded
    with 0 / -1 on padding rows; batches without them keep their keys."""
    samples = j_synthetic_mosei(2, "train", n_train=3, min_len=3, max_len=12)
    for kw in (dict(max_len=8, pad_batch_to=5), dict(bucket=16, max_len=32, pad_batch_to=3)):
        got = ERCBatcher("atv", 2, 1, **kw)(samples)
        want = JERCBatcher("atv", 2, 1, **kw)(samples)
        assert got.keys() == want.keys() and {"emo_label", "senti2_label"} <= set(got)
        for k in want:
            if want[k] is None:
                assert got[k] is None
                continue
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    plain = [{k: v for k, v in s.items() if k not in ("emo_label", "senti2_label")} for s in samples]
    assert not {"emo_label", "senti2_label"} & set(ERCBatcher("atv", 2, 1, pad_batch_to=4)(plain))


def test_batcher_gives_speaker_0_for_mosei_cim_rows(tmp_path):
    """``mosei_cim`` writes one speaker entry, ``[0]``, for a whole video.
    The port's batcher broadcasts it: speaker 0 at every utterance and on
    padding (the JAX batcher's native packer reads past the one-entry row
    instead)."""
    _mk_cim(str(tmp_path))
    samples = treaders.mosei_cim(str(tmp_path), "train")
    assert all(s["speakers"] == [0] for s in samples)
    batch = ERCBatcher("atv", 2, 1, max_len=8, pad_batch_to=4)(samples)
    assert batch["speaker_ids"].shape == (4, 8) and not batch["speaker_ids"].any()
    onehot = ERCBatcher("atv", 2, 1, speaker_onehot=True, max_len=8, pad_batch_to=4)(samples)["speaker_tensor"]
    np.testing.assert_array_equal(onehot[..., 0], batch["attention_mask"])


# ------------------------------------------------------------------ metrics
def test_mosei_multilabel_summary_matches_sklearn():
    r = np.random.default_rng(0)
    for trial in range(6):
        n = int(r.integers(1, 40))
        true = r.integers(0, 2, (n, 7))
        pred = r.random((n, 7))
        true[:, 3] = 1  # a column with a single class in the truth
        true[:, 4] = 0
        pred[:, 5] = 0.5  # exactly at the threshold: not above it
        pred[:, 6] = np.where(trial % 2, 0.9, 0.1)  # a column with a single predicted class
        got, want = tmetrics.mosei_multilabel_summary(true, pred), jmetrics.mosei_multilabel_summary(true, pred)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)
        for i in range(7):
            col = (pred[:, i] > 0.5).astype(int)
            assert tmetrics.weighted_accuracy(true[:, i], col) == jmetrics.weighted_accuracy(true[:, i], col)
    y = r.integers(0, 3, 30)  # labels other than 0/1 count as negatives, as the reference counts them
    assert tmetrics.weighted_accuracy(y, y % 2) == jmetrics.weighted_accuracy(y, y % 2)


# ------------------------------------------------------------------ cogmen_mosei
def test_cogmen_mosei_matches_jax():
    """COGMEN's module at cogmen_mosei's params (one speaker) on
    synthetic-mosei-6 batches: the same logits as JAX's, every position."""
    p, jp = tcogmen_mosei.COGMENMoseiParams(), jcogmen_mosei.COGMENMoseiParams()
    for q in (p, jp):
        q.from_args(["--dataset=synthetic-mosei-6", "--hidden_size=8", "--device=cpu"])
        q.iparams()
    assert (p.n_speakers, p.hidden_all, jcogmen_mosei.ParamsType().dataset) == (1, 409, "mosei-emo-sbert-6")
    assert (jp.n_speakers, jp.hidden_all, tcogmen_mosei.ParamsType().dataset) == (1, 409, "mosei-emo-sbert-6")
    samples = j_synthetic_mosei(6, "train", n_train=2, min_len=4, max_len=9)
    batch = JERCBatcher("atv", 6, 1, max_len=9, pad_batch_to=3)(samples)
    kw = dict(input_size=409, hidden_size=8, num_head=p.num_heads, n_speakers=1, n_classes=6, wp=p.wp, wf=p.wf,
              graph_impl="dense")
    jm = jcogmen.COGMENModule(**kw)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: jm.init(k, batch, deterministic=True))(
        jax.random.PRNGKey(0)))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v: jm.apply(v, batch, deterministic=True))(variables))
    p.graph_impl = "dense"
    model = tcogmen_mosei.build(p).eval()
    model.load_state_dict(convert.STATES["cogmen_mosei"](variables))
    tb = {k: torch.from_numpy(v) for k, v in batch.items() if v is not None}
    with torch.no_grad():
        got = model(tb).numpy()
    assert got.shape == (3, 9, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    engine = InferenceEngine.from_module("cogmen_mosei", dataset="synthetic-mosei-6", batch_size=3, hidden_size=8,
                                         graph_impl="dense", device="cpu")
    engine.model.load_state_dict(model.state_dict())
    np.testing.assert_allclose(engine.logits(batch), want, rtol=0, atol=1e-5)
