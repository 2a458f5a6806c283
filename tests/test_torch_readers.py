"""The port's IEMOCAP-COGMEN and MELD-MMGCN readers and the real half of its
registry ≡ the JAX package's.

The test writes the reference-format pickles itself (no dataset is
downloaded): the 9-tuple COGMEN dump for 6 and 4 classes and the sbert,
robert, tsn and tsnss replacement maps; the 10-tuple MMGCN MELD dump (float64
features, 9 one-hot speakers) and its sbert map.  Every ``iemocap-cogmen-*`` name
is read by both packages and compared exactly; a missing dump raises the
same FileNotFoundError with the same hint; the data root resolves alike
(``ERC_TPU_DATA_ROOT``); the port's trainer reads a real name through it.
"""

import pickle

import numpy as np
import pytest

from erc_tpu.data import readers as jreaders
from erc_tpu.data import registry as jregistry
from erc_tpu_torch.data import readers as treaders
from erc_tpu_torch.data import registry as tregistry
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)

NAMES = sorted(n for n in tregistry.regist_data if n.startswith("iemocap-cogmen"))
MELD_NAMES = ("meld-mmgcn-7", "meld-mmgcn-sbert-7")


def _dump(n_dialogues, dims, seed):
    """(the 9-tuple, dialogue ids) of a small COGMEN dump."""
    r = np.random.default_rng(seed)
    ids = [f"Ses0{i}_dlg" for i in range(n_dialogues)]
    lens = {k: int(r.integers(2, 9)) for k in ids}
    feats = {m: {k: r.normal(size=(lens[k], d)).astype(np.float32) for k in ids} for m, d in dims.items()}
    spk = {k: [str(s) for s in r.choice(["M", "F"], lens[k])] for k in ids}
    labels = {k: r.integers(0, 6, lens[k]).tolist() for k in ids}
    sentences = {k: [f"utterance {j}" for j in range(lens[k])] for k in ids}
    vids = {k: f"{k}.avi" for k in ids}
    return (vids, spk, labels, feats["text"], feats["audio"], feats["visual"], sentences, ids[:3], ids[3:]), ids


def _write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """An IEMOCAP root with both dumps and every replacement map."""
    root = tmp_path_factory.mktemp("erc_data") / "iemocap"  # get_root's layout under the data root
    r = np.random.default_rng(9)
    for sub, pkl, seed in (("iemocap", "IEMOCAP_features.pkl", 0), ("iemocap_4", "IEMOCAP_features_4.pkl", 1)):
        tup, ids = _dump(5, {"text": 7, "audio": 5, "visual": 6}, seed)
        d = root / "cogmen" / sub
        _write(d / pkl, tup)
        lens = {k: len(v) for k, v in tup[3].items()}
        for name, dim in (("sbert_map.pkl", 8), ("robert_map.pkl", 9), ("tsn_vfeat.pkl", 4), ("tsn_vfeat_ss.pkl", 3)):
            _write(d / name, {k: r.normal(size=(lens[k], dim)).astype(np.float32) for k in ids})
    return str(root)


@pytest.mark.parametrize("name", NAMES)
def test_reader_matches_jax(data_root, name):
    assert name in jregistry.regist_data
    for split in ("train", "test"):
        got = tregistry.pick_datas(data_root, name, split)
        want = jregistry.pick_datas(data_root, name, split)
        assert len(got) == len(want) == (3 if split == "train" else 2)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                if isinstance(w[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} {k}")
                else:
                    assert g[k] == w[k], (name, k)


def test_every_cogmen_name_of_the_jax_registry_is_ported():
    want = {n for n in jregistry.regist_data if n.startswith("iemocap-cogmen") and "text" not in n
            and "video" not in n}
    assert set(NAMES) == want and len(NAMES) == 24


@pytest.mark.parametrize("reader", ["iemocap_cogmen_6", "iemocap_cogmen_4", "meld_mmgcn_7"])
def test_missing_dump_raises_the_same_hint(tmp_path, reader):
    with pytest.raises(FileNotFoundError) as want:
        getattr(jreaders, reader)(str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        getattr(treaders, reader)(str(tmp_path))
    assert str(got.value) == str(want.value) and "ERC_TPU_DATA_ROOT" in str(got.value)


def test_data_root_resolves_as_in_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("ERC_TPU_DATA_ROOT", str(tmp_path))
    for name in ("iemocap-cogmen-6", "meld-mmgcn-7", "synthetic-cogmen-6"):
        assert tregistry.get_root(name) == jregistry.get_root(name)
    assert tregistry.default_roots() == jregistry.default_roots()
    assert tregistry.cfg_get("data_root", env="ERC_TPU_DATA_ROOT") == str(tmp_path)


def test_trainer_reads_a_real_dataset(data_root, monkeypatch):
    """--dataset=iemocap-cogmen-6 under ERC_TPU_DATA_ROOT: the loader's batches
    carry the dump's dialogues and features."""
    from erc_tpu_torch.models import cogmen

    monkeypatch.setenv("ERC_TPU_DATA_ROOT", str(data_root).rsplit("/", 1)[0])
    p = cogmen.COGMENParams()
    p.finalize(["--dataset=iemocap-cogmen-6", "--device=cpu", "--train.batch_size=2"])
    batches = list(cogmen.COGMENTrainer(p).make_loader("train"))
    assert sum(int((b["text_length"] > 0).sum()) for b in batches) == 3
    assert all(b["input_tensor"].shape[-1] == 7 + 5 + 6 for b in batches)


MELD_DIMS = {"text": 600, "audio": 300, "visual": 342}  # the MMGCN dump's widths (models/base.py)


@pytest.fixture(scope="module")
def meld_root(tmp_path_factory):
    """A MELD root (get_root's ``meld/``) with the MMGCN dump and its sbert map."""
    root = tmp_path_factory.mktemp("erc_data") / "meld"
    r = np.random.default_rng(11)
    ids = [f"dia{i}" for i in range(6)]
    lens = {k: int(r.integers(1, 8)) for k in ids}
    feats = {m: {k: r.normal(size=(lens[k], d)) for k in ids} for m, d in MELD_DIMS.items()}  # float64
    spk = {k: np.eye(9, dtype=int)[r.integers(0, 9, lens[k])].tolist() for k in ids}
    labels = {k: r.integers(0, 7, lens[k]).tolist() for k in ids}
    sentences = {k: [f"line {j}" for j in range(lens[k])] for k in ids}
    vids = {k: f"{k}.mp4" for k in ids}
    _write(root / "MMGCN" / "MELD_features_raw.pkl",
           (vids, spk, labels, feats["text"], feats["audio"], feats["visual"], sentences, ids[:4], ids[4:], None))
    _write(root / "MMGCN" / "sbert_map.pkl", {k: r.normal(size=(lens[k], 768)) for k in ids})
    return str(root)


@pytest.mark.parametrize("name", MELD_NAMES)
def test_meld_reader_matches_jax(meld_root, name):
    assert name in jregistry.regist_data and name in tregistry.regist_data
    for split in ("train", "test"):
        got = tregistry.pick_datas(meld_root, name, split)
        want = jregistry.pick_datas(meld_root, name, split)
        assert len(got) == len(want) == (4 if split == "train" else 2)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                if isinstance(w[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype == np.float32
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} {k}")
                else:
                    assert g[k] == w[k], (name, k)
            assert g["text"].shape[1] == (768 if "sbert" in name else 600)


def test_mmgcn_trainer_reads_meld(meld_root, monkeypatch):
    """--dataset=meld-mmgcn-7 under ERC_TPU_DATA_ROOT: 9 speakers, 7 classes,
    the dump's widths, and MMGCN's forward on a batch of it."""
    import torch

    from erc_tpu_torch.data.loader import to_device
    from erc_tpu_torch.models import mmgcn

    monkeypatch.setenv("ERC_TPU_DATA_ROOT", str(meld_root).rsplit("/", 1)[0])
    p = mmgcn.MMGCNParams()
    p.finalize(["--dataset=meld-mmgcn-7", "--device=cpu", "--train.batch_size=4", "--gcn_layers=2",
                "--graph_hidden_size=8", "--reimplement"])
    assert (p.n_speakers, p.n_classes, p.optim.lr, p.optim.weight_decay) == (9, 7, 0.0001, 0)
    trainer = mmgcn.MMGCNTrainer(p)
    batches = list(trainer.make_loader("train"))
    assert sum(int((b["text_length"] > 0).sum()) for b in batches) == 4
    b = batches[0]
    assert (b["text_feature"].shape[-1], b["audio_feature"].shape[-1], b["visual_feature"].shape[-1]) == (600, 300, 342)
    model = mmgcn.build(p, generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        logits = model(to_device(b, torch.device("cpu")))
    assert logits.shape == (*b["attention_mask"].shape, 7) and torch.isfinite(logits).all()
