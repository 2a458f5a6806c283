"""The port's text features (``erc_tpu_torch/preprocess/lexical.py``) held
against the JAX package's on the CPU.

A tiny RoBERTa (vocabulary 100, width 16, 2 layers, 2 heads) as
``transformers``' ``FlaxRobertaModel`` for the JAX package and its torch
``RobertaModel`` carrying the same weights (converted by name), a
stand-in tokenizer that pads with RoBERTa's pad id 1.  Both modes (sBERT's
mean pooling, RoBERTa's pooler output), the static-batch padding of the last
batch, the per-dialogue maps and the extraction flow (``from_pretrained``
patched) agree within 1e-5 absolute.
"""

import os
import pickle
import sys

os.environ.setdefault("USE_TF", "0")  # transformers would otherwise import TensorFlow where it is installed

import numpy as np
import pytest
import torch

from erc_tpu.preprocess import lexical as jlex
from erc_tpu_torch.preprocess import lexical as tlex
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5


class Tokenizer:
    """``transformers``' call convention: ids in [4, 100) for each word, RoBERTa's
    pad id 1 and mask 0 after the sentence, truncated at ``max_length``."""

    def __call__(self, sentences, padding, truncation, max_length, return_tensors):
        assert padding == "max_length" and truncation and return_tensors == "np"
        ids = np.ones((len(sentences), max_length), np.int64)
        am = np.zeros((len(sentences), max_length), np.int64)
        for i, s in enumerate(sentences):
            toks = [4 + sum(map(ord, w)) % 96 for w in s.split()][:max_length]
            ids[i, : len(toks)], am[i, : len(toks)] = toks, 1
        return {"input_ids": ids, "attention_mask": am}


@pytest.fixture(scope="module")
def models():
    """(FlaxRobertaModel, RobertaModel) with the same weights."""
    from transformers import FlaxRobertaModel, RobertaConfig, RobertaModel

    import jax

    cfg = RobertaConfig(vocab_size=100, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=32, max_position_embeddings=64)
    flax_model = FlaxRobertaModel(cfg, seed=0)
    sd = {}
    for path, v in jax.tree_util.tree_flatten_with_path(flax_model.params)[0]:
        *names, leaf = [p.key for p in path]
        v = np.asarray(v)
        sd[".".join(names) + "." + {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(leaf, leaf)] = (
            torch.from_numpy(np.array(v.T if leaf == "kernel" else v)))
    torch_model = RobertaModel(cfg).eval()
    missing, unexpected = torch_model.load_state_dict(sd, strict=False)
    assert not unexpected and all("position_ids" in k or "token_type_ids" in k for k in missing), missing
    return flax_model, torch_model


SENTENCES = ["hello there", "how are you doing today my friend", "fine", "I am not sure what to say about it",
             "yes", "no no no", "a much longer sentence that the tokenizer will cut at eight tokens for sure"]


@pytest.mark.parametrize("mode", ["sbert", "robert"])
def test_text_encoder_equals_jax(models, mode):
    flax_model, torch_model = models
    kw = dict(mode=mode, max_tokens=8, batch_size=3)
    want = jlex.TextEncoder(flax_model, Tokenizer(), **kw).encode(SENTENCES)
    enc = tlex.TextEncoder(torch_model, Tokenizer(), device="cpu", **kw)
    got = enc.encode(SENTENCES)
    assert got.shape == want.shape == (7, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the padded last batch gives the rows a full batch gives
    np.testing.assert_allclose(got[6:], enc.encode(SENTENCES[6:]), rtol=0, atol=TOL)
    if mode == "sbert":  # mean pooling over the valid tokens only
        ids = Tokenizer()(SENTENCES[:1], "max_length", True, 8, "np")
        with torch.no_grad():
            h = torch_model(input_ids=torch.from_numpy(ids["input_ids"]),
                            attention_mask=torch.from_numpy(ids["attention_mask"])).last_hidden_state
        np.testing.assert_allclose(got[0], h[0, :2].mean(0).numpy(), rtol=0, atol=TOL)


def test_encode_dialogues_equals_jax(models):
    flax_model, torch_model = models
    dialogues = {"d1": SENTENCES[:4], "d2": SENTENCES[4:5], "d3": SENTENCES}
    want = jlex.TextEncoder(flax_model, Tokenizer(), max_tokens=8, batch_size=4).encode_dialogues(dialogues)
    got = tlex.TextEncoder(torch_model, Tokenizer(), max_tokens=8, batch_size=4,
                           device="cpu").encode_dialogues(dialogues)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL)
    h = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 4)).astype(np.float32))
    m = torch.tensor([[1, 1, 0], [0, 0, 0]])
    np.testing.assert_allclose(tlex.mean_pool(h, m).numpy(), np.asarray(jlex.mean_pool(h.numpy(), m.numpy())),
                               rtol=0, atol=1e-7)


def _cogmen_root(base):
    """A COGMEN dump under ``base``/iemocap with 4 dialogues (2 train, 2 test)."""
    rel = os.path.join(base, "iemocap", "cogmen", "iemocap_4")
    os.makedirs(rel)
    sent = {"d0": SENTENCES[:3], "d1": SENTENCES[3:5], "d2": SENTENCES[5:], "d3": ["ok"]}
    feats = {k: np.zeros((len(v), 2), np.float32) for k, v in sent.items()}
    with open(os.path.join(rel, "IEMOCAP_features_4.pkl"), "wb") as f:
        pickle.dump(({k: k for k in sent}, {k: ["M"] * len(v) for k, v in sent.items()},
                     {k: [0] * len(v) for k, v in sent.items()}, feats, feats, feats, sent, ["d0", "d1"],
                     ["d2", "d3"]), f)


@pytest.mark.parametrize("dataset", ["iemocap-cogmen-text-4", "iemocap-cogmen-4"])
def test_extract_text_features_equals_jax(models, tmp_path, monkeypatch, dataset):
    """The flow through the registry: an extraction view, and a training
    name whose samples' sentences are collected; ``from_pretrained`` patched
    to the test's models (nothing is read from disk or downloaded)."""
    from erc_tpu_torch.preprocess import entry

    flax_model, torch_model = models
    _cogmen_root(str(tmp_path))
    monkeypatch.setenv("ERC_TPU_DATA_ROOT", str(tmp_path))
    seen = []

    def patched(package, model):
        def from_pretrained(path, mode="sbert", **kw):
            seen.append((package, path, mode))
            return (tlex if package == "port" else jlex).TextEncoder(model, Tokenizer(), mode, max_tokens=8,
                                                                     batch_size=4, **kw)
        return from_pretrained

    monkeypatch.setattr(jlex.TextEncoder, "from_pretrained", staticmethod(patched("jax", flax_model)))
    monkeypatch.setattr(tlex.TextEncoder, "from_pretrained", staticmethod(patched("port", torch_model)))
    want_path = jlex.extract_text_features(dataset, "robert", "/models/roberta", str(tmp_path / "jax.pkl"))
    got_path = entry.main(["text", f"--dataset={dataset}", "--mode=robert", "--model_path=/models/roberta",
                           f"--out={tmp_path / 'port.pkl'}", "--device=cpu"])
    assert seen == [("jax", "/models/roberta", "robert"), ("port", "/models/roberta", "robert")]
    with open(want_path, "rb") as f, open(got_path, "rb") as g:
        want, got = pickle.load(f), pickle.load(g)
    assert list(got) == list(want) and len(got) == 4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL)
    # the default output path and model name, as in JAX
    tlex.extract_text_features(dataset, "sbert", device="cpu")
    assert seen[-1] == ("port", "sentence-transformers/paraphrase-distilroberta-base-v1", "sbert")
    assert os.path.exists(tmp_path / "iemocap" / "sbert_map.pkl")


def test_from_pretrained_without_transformers_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tlex.TextEncoder.from_pretrained("/models/none", device="cpu")
