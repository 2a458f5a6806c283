"""Port's serving path ≡ the JAX package's: synthetic data, batching, params
grammar and InferenceEngine.predict on carried-over weights (pred equal,
probs within 1e-5); HTTP round trip; device rule; import isolation."""

import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from erc_tpu.data.collate import ERCBatcher as JERCBatcher, bucket_length as j_bucket_length
from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu_torch import convert
from erc_tpu_torch.data.collate import ERCBatcher, bucket_length
from erc_tpu_torch.data.synthetic import synthetic_erc
from erc_tpu_torch.serve import InferenceEngine, make_http_server
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
PROBS_ATOL = 1e-5


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("prefix,split,seed", [("iemocap-cogmen", "train", 0),
                                               ("meld-mmgcn", "test", 5),
                                               ("custom", "val", 2)])
def test_synthetic_erc_matches_jax(prefix, split, seed):
    kw = dict(n_train=4, n_test=3, min_len=3, max_len=9, seed=seed)
    if prefix == "custom":
        kw.update(text_dim=7, audio_dim=5, visual_dim=3)
    want = j_synthetic_erc(prefix, 6, split, **kw)
    got = synthetic_erc(prefix, 6, split, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k]


@pytest.mark.parametrize("modality,bucket,pad_to", [("atv", 16, 5), ("at", 0, None)])
def test_batcher_matches_jax(modality, bucket, pad_to):
    samples = j_synthetic_erc("iemocap-cogmen", 6, n_train=4, min_len=3, max_len=20, seed=1)
    samples[1]["speakers"] = np.asarray([s.index(1) for s in samples[1]["speakers"]])  # 1-D ids
    kw = dict(modality=modality, n_classes=6, n_speakers=2, bucket=bucket, max_len=18,
              pad_batch_to=pad_to)
    want = JERCBatcher(**kw)(samples)
    got = ERCBatcher(**kw)(samples)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w is None:
            assert got[k] is None
            continue
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    for L in (1, 15, 16, 17, 200):
        assert bucket_length(L, 16, 128) == j_bucket_length(L, 16, 128)
        assert bucket_length(L, 0, 128) == j_bucket_length(L, 0, 128)


@pytest.mark.parametrize("dataset", ["synthetic-cogmen-6", "iemocap-cogmen-4", "meld-mmgcn-7",
                                     "mosei-sbert-6", "iemocap-tsn-v+-4"])
def test_params_grammar_matches_jax(dataset):
    from erc_tpu.models.cogmen import COGMENParams as JParams
    from erc_tpu_torch.models.cogmen import COGMENParams

    j, t = JParams(), COGMENParams()
    for p in (j, t):
        p.from_args([f"--dataset={dataset}", "--modality=atv", "--train.batch_size=4"])
        p.iparams()
    for key in ("hidden_text", "hidden_audio", "hidden_visual", "hidden_all", "n_speakers",
                "class_names", "length_bucket", "max_seq_len", "num_heads", "graph_impl",
                "encoder_mode", "wp", "wf", "hidden_size", "train.batch_size"):
        assert t[key] == j[key], key
    assert t.n_classes == j.n_classes
    with pytest.raises(ValueError):
        t.from_args(["--graph_impl=sparse"])


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine on the CPU) with the JAX engine's weights."""
    from erc_tpu.serve import InferenceEngine as JInferenceEngine

    old = os.environ.get("ERC_TPU_EXPROOT")
    os.environ["ERC_TPU_EXPROOT"] = str(tmp_path_factory.mktemp("exp"))
    try:
        kw = dict(dataset="synthetic-cogmen-6", max_seq_len=16, graph_impl="banded",
                  encoder_mode="chained")
        jeng = JInferenceEngine.from_module("cogmen", heartbeat=False,
                                            matmul_precision="highest", **kw)
    finally:
        if old is None:
            os.environ.pop("ERC_TPU_EXPROOT", None)
        else:
            os.environ["ERC_TPU_EXPROOT"] = old
    state = jeng.trainer.state
    tree = jax.tree_util.tree_map(np.asarray, {"params": state.params, **state.model_state})
    teng = InferenceEngine.from_module("cogmen", batch_size=jeng.batch_size, device="cpu", **kw)
    teng.model.load_state_dict(convert.cogmen_state(tree["params"], tree["batch_stats"]))
    return jeng, teng


def _dialogues(n=3, seed=0):
    return synthetic_erc("iemocap-cogmen", 6, n_train=n, min_len=4, max_len=12, seed=seed)


def test_predict_matches_jax_engine(engines):
    jeng, teng = engines
    want = jeng.predict(_dialogues(3))
    got = teng.predict(_dialogues(3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["pred"] == w["pred"]
        assert g["labels"] == w["labels"]
        np.testing.assert_allclose(np.asarray(g["probs"]), np.asarray(w["probs"]), rtol=0,
                                   atol=PROBS_ATOL)


def test_http_round_trip(engines):
    _, teng = engines
    srv = make_http_server(teng, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        d = _dialogues(1, seed=4)[0]
        payload = {"dialogues": [{"text": d["text"].tolist(), "audio": d["audio"].tolist(),
                                  "visual": d["visual"].tolist(), "speakers": d["speakers"]}]}
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert out["results"][0]["pred"] == teng.predict([d])[0]["pred"]


def test_from_module_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine.from_module("cogmen", dataset="synthetic-cogmen-6")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine.from_module("cogmen", dataset="synthetic-cogmen-6", device="cuda:0")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import erc_tpu_torch\n"
        "import erc_tpu_torch.models.dgcn\n"
        "import erc_tpu_torch.models.mmgcn\n"
        "for m in pkgutil.walk_packages(erc_tpu_torch.__path__, 'erc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'erc_tpu')]\n"
        "print(len([n for n in sys.modules if n.startswith('erc_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 15, res.stdout
