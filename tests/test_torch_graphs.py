"""The eval path that the port captures in CUDA graphs, on the CPU.

- ``BiRNN``'s masked form (the form the card captures: lengths read from the
  mask on the device, no host sync) ≡ the JAX ``BiRNN``'s masked scan within
  1e-5 (LSTM and GRU, one and two layers, both directions and one, a batch
  with rows of length 0, 1 and L), and ≡ the port's packed form within 1e-6;
- DialogueGCN, whose biLSTM takes the masked form, served by
  ``InferenceEngine(device="cpu")`` ≡ the JAX engine (pred equal, probs
  within 1e-5, as ``tests/test_torch_serve.py`` holds COGMEN);
- the keys that the capture stages are the ones the forward read, which
  leaves out the raw modality features, the labels and the speaker tensor;
- the CPU engine runs eagerly: it builds no ``CapturedForward`` and calls
  nothing of ``torch.cuda``;
- the val and test stages' batches carry no host lengths;
- ``_tap_valid`` as one window of the padded mask ≡ the per-tap form it
  replaced, bit for bit.

JAX runs in float32 at matmul precision highest.  Replay on the card is held
against the eager forward in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax

from erc_tpu.ops import rnn as jrnn
from erc_tpu_torch import convert
from erc_tpu_torch.core import cuda_graphs
from erc_tpu_torch.data.loader import to_device
from erc_tpu_torch.data.synthetic import synthetic_erc
from erc_tpu_torch.ops import rnn as trnn
from erc_tpu_torch.ops.gnn_banded import _tap_valid
from erc_tpu_torch.ops.kernels.banded import band_offsets
from erc_tpu_torch.serve import InferenceEngine

ATOL = 1e-5
PACKED_ATOL = 1e-6
PROBS_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def highest_precision():
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", prev)


def _ragged(B=4, L=7, D=5, seed=0):
    """Rows of length L, 0, 1 and 4: x zero at padded steps, its mask, lengths."""
    r = np.random.default_rng(seed)
    lengths = np.array([L, 0, 1, 4], np.int64)[:B]
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    x = (r.normal(size=(B, L, D)) * mask[..., None]).astype(np.float32)
    return x, mask, lengths


RNN_CASES = [(cell, layers, bi) for cell in ("lstm", "gru") for layers in (1, 2) for bi in (True, False)]
RNN_IDS = [f"{c}-{n}layer-{'bi' if b else 'uni'}" for c, n, b in RNN_CASES]


@pytest.mark.parametrize("cell,num_layers,bidirectional", RNN_CASES, ids=RNN_IDS)
def test_birnn_masked_form_matches_jax(cell, num_layers, bidirectional):
    x, mask, _ = _ragged()
    H = 4
    jm = jrnn.BiRNN(hidden_size=H, num_layers=num_layers, cell=cell, bidirectional=bidirectional)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3), x, mask))["params"]
    want = np.asarray(jm.apply({"params": params}, x, mask))
    module = trnn.BiRNN(x.shape[-1], H, num_layers=num_layers, cell=cell, bidirectional=bidirectional).eval()
    module.load_state_dict(convert.birnn_state(params))
    with torch.no_grad():
        got = module(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.all(got[1] == 0.0) and np.all(got[2, 1:] == 0.0) and np.all(got[3, 4:] == 0.0)


@pytest.mark.parametrize("cell,num_layers,bidirectional", RNN_CASES, ids=RNN_IDS)
def test_birnn_masked_form_matches_the_packed_form(cell, num_layers, bidirectional):
    x, mask, lengths = _ragged(L=9, D=6, seed=1)
    module = trnn.BiRNN(6, 5, num_layers=num_layers, cell=cell, bidirectional=bidirectional,
                        generator=torch.Generator().manual_seed(2)).eval()
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        masked = module(xt, mt)
        packed = module(xt, mt, torch.from_numpy(lengths))
    np.testing.assert_allclose(masked.numpy(), packed.numpy(), rtol=0, atol=PACKED_ATOL)


def test_birnn_masked_form_reads_no_host_lengths(monkeypatch):
    """The masked form never packs (packing needs the lengths on the host)."""
    x, mask, _ = _ragged()

    def refuse(*a, **k):
        raise AssertionError("packed")

    monkeypatch.setattr(trnn, "pack_padded_sequence", refuse)
    module = trnn.BiRNN(5, 3, num_layers=2).eval()
    with torch.no_grad():
        out = module(torch.from_numpy(x), torch.from_numpy(mask))
    assert out.shape == (4, 7, 6)


# ------------------------------------------------------------------ engine
def _dialogues(n=3, seed=0):
    return synthetic_erc("iemocap-cogmen", 6, n_train=n, min_len=4, max_len=12, seed=seed)


DGCN_KW = dict(dataset="synthetic-cogmen-6", max_seq_len=16, hidden_size=16)


@pytest.fixture(scope="module")
def dgcn_engines(tmp_path_factory):
    """(JAX engine, port engine on the CPU) for DialogueGCN with the JAX weights."""
    from erc_tpu.serve import InferenceEngine as JInferenceEngine

    old = os.environ.get("ERC_TPU_EXPROOT")
    os.environ["ERC_TPU_EXPROOT"] = str(tmp_path_factory.mktemp("exp"))
    try:
        jeng = JInferenceEngine.from_module("dgcn", heartbeat=False, matmul_precision="highest", **DGCN_KW)
    finally:
        if old is None:
            os.environ.pop("ERC_TPU_EXPROOT", None)
        else:
            os.environ["ERC_TPU_EXPROOT"] = old
    params = jax.tree_util.tree_map(np.asarray, jeng.trainer.state.params)
    teng = InferenceEngine.from_module("dgcn", batch_size=jeng.batch_size, device="cpu", **DGCN_KW)
    teng.model.load_state_dict(convert.dgcn_state(params))
    return jeng, teng


def test_dgcn_engine_on_the_masked_lstm_matches_jax_engine(dgcn_engines):
    jeng, teng = dgcn_engines
    want = jeng.predict(_dialogues(3))
    got = teng.predict(_dialogues(3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["pred"] == w["pred"]
        np.testing.assert_allclose(np.asarray(g["probs"]), np.asarray(w["probs"]), rtol=0, atol=PROBS_ATOL)


def test_capture_stages_only_the_keys_the_model_reads(dgcn_engines):
    """The capture's warm-up reads through a ``_ReadLog``: the keys it logs are
    the static inputs, and the host batch's others are never copied."""
    _, teng = dgcn_engines
    batch = teng.batcher(_dialogues(2))
    full = {k: torch.from_numpy(v) for k, v in batch.items() if v is not None}
    log = cuda_graphs._ReadLog(full)
    with torch.inference_mode():
        out = teng._forward(log)
    assert out.shape[:2] == batch["attention_mask"].shape
    assert log.read == {"input_tensor", "attention_mask", "text_length", "speaker_ids"}
    assert {"label", "audio_feature", "text_feature", "visual_feature", "speaker_tensor"} & full.keys()
    assert not log.read & {"label", "audio_feature", "text_feature", "visual_feature", "speaker_tensor"}


def test_read_log_counts_iteration_and_membership():
    log = cuda_graphs._ReadLog({"a": 1, "b": 2, "c": 3})
    assert log.get("z") is None and "z" not in log and not log.read
    assert log.get("a") == 1 and "b" in log
    assert log.read == {"a", "b"}
    list(log.items())
    assert log.read == {"a", "b", "c"}


def test_cpu_engine_is_eager_and_never_touches_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch.cuda touched on the CPU route")

    for name in ("CUDAGraph", "Stream", "graph", "graph_pool_handle", "current_stream", "synchronize",
                 "is_available", "device_count", "get_device_name", "stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(cuda_graphs, "CapturedForward", refuse)
    engine = InferenceEngine.from_module("dgcn", batch_size=2, device="cpu", **DGCN_KW)
    assert engine.captured is None
    results = engine.predict(_dialogues(3))
    assert len(results) == 3 and all(np.isfinite(r["probs"]).all() for r in results)


def test_captured_forward_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_graphs.CapturedForward(lambda b: b, torch.device("cpu"))


def test_eval_batches_carry_no_host_lengths():
    batch = InferenceEngine.from_module("dgcn", batch_size=2, device="cpu", **DGCN_KW).batcher(_dialogues(2))
    assert "text_length_host" in to_device(batch, torch.device("cpu"))
    assert "text_length_host" not in to_device(batch, torch.device("cpu"), host_lengths=False)


def test_host_array_takes_floats_to_float32():
    assert cuda_graphs.host_array(np.zeros(3, np.float64)).dtype == np.float32
    assert cuda_graphs.host_array(np.zeros(3, np.int32)).dtype == np.int32


# ------------------------------------------------------------------ _tap_valid
def _tap_valid_per_tap(mask, offsets):
    """The form ``_tap_valid`` replaced: a roll, a range test and two
    products a tap."""
    B, L = mask.shape
    v = torch.arange(L, device=mask.device)
    cols = []
    for off in offsets:
        rolled = torch.roll(mask, -off, dims=1)
        inrange = ((v + off) >= 0) & ((v + off) < L)
        cols.append(rolled * inrange[None, :])
    return torch.stack(cols, -1) * mask[..., None]


@pytest.mark.parametrize("offsets", [band_offsets(10, 10), band_offsets(5, 5), band_offsets(0, 3),
                                     band_offsets(2, 0), (-1, 0, 2), (3, 4), (-4, -2), (2, -1, 0)],
                         ids=["band10", "band5", "future3", "past2", "gapped", "right", "left", "unsorted"])
def test_tap_valid_equals_the_per_tap_form(offsets):
    g = torch.Generator().manual_seed(4)
    for L in (1, 3, 16, 40):
        lengths = torch.randint(0, L + 1, (5,), generator=g)
        mask = (torch.arange(L)[None] < lengths[:, None]).to(torch.float32)
        want = _tap_valid_per_tap(mask, offsets)
        got = _tap_valid(mask, offsets)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)
