"""The eval path that the port captures in CUDA graphs, on the CPU.

- ``BiRNN``'s masked form (the form the card captures: lengths read from the
  mask on the device, no host sync) ≡ the JAX ``BiRNN``'s masked scan within
  1e-5 (LSTM and GRU, one and two layers, both directions and one, a batch
  with rows of length 0, 1 and L), in eval mode, and in training mode at
  dropout 0 its output, input gradient and weight gradients ≡ ``jax.grad``
  of the JAX module within 1e-5;
- DialogueGCN, whose biLSTM takes the masked form, served by
  ``InferenceEngine(device="cpu")`` ≡ the JAX engine (pred equal, probs
  within 1e-5, as ``tests/test_torch_serve.py`` holds COGMEN);
- the keys that the capture stages are the ones the forward read, which
  leaves out the raw modality features, the labels and the speaker tensor;
- the CPU engine runs eagerly: it builds no ``CapturedForward`` and calls
  nothing of ``torch.cuda``;
- ``to_device`` carries no host lengths;
- ``CapturedStep``, like ``CapturedForward``, refuses the CPU, and shares
  its bucket key and its watch of addresses (in-place writes pass, a
  replaced tensor raises); ``--optim.name=SGD`` builds the port's ``Sgd``,
  capturable when built for the card, and a trainer whose optimizer cannot
  be captured (a hand-set ``torch.optim.SGD``) raises where the captured step
  is asked for; the CPU trainer steps eagerly and touches nothing of
  ``torch.cuda``;
- ``_tap_valid`` as one window of the padded mask ≡ the per-tap form it
  replaced, bit for bit.

JAX runs in float32 at matmul precision highest.  Replay on the card is held
against the eager forward in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import inspect
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
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-5
GRAD_ATOL = 1e-5
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
def test_birnn_masked_form_gradients_match_jax(cell, num_layers, bidirectional):
    """Training mode at dropout 0: the output and the gradients of
    sum(out · cotangent) with respect to the input and every weight ≡
    ``jax.grad`` of the JAX ``BiRNN``, within 1e-5."""
    x, mask, _ = _ragged(L=9, D=6, seed=1)
    H = 5
    jm = jrnn.BiRNN(hidden_size=H, num_layers=num_layers, cell=cell, bidirectional=bidirectional)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4), x, mask))["params"]
    cot = np.random.default_rng(2).normal(size=(4, 9, (2 if bidirectional else 1) * H)).astype(np.float32)

    def loss(p, xx):
        out = jm.apply({"params": p}, xx, mask)
        return (out * cot).sum(), out

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
    module = trnn.BiRNN(6, H, num_layers=num_layers, cell=cell, bidirectional=bidirectional).train()
    module.load_state_dict(convert.birnn_state(params))
    xt = torch.from_numpy(x).requires_grad_()
    with torch.enable_grad():
        out = module(xt, torch.from_numpy(mask))
        (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=GRAD_ATOL)
    want_grads = convert.birnn_state(jax.tree_util.tree_map(np.asarray, gp))
    assert want_grads.keys() == dict(module.named_parameters()).keys()
    for name, t in module.named_parameters():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grads[name]), rtol=0, atol=GRAD_ATOL, err_msg=name)


def test_birnn_masked_form_reads_no_host_lengths(monkeypatch):
    """The masked form never packs (packing needs the lengths on the host),
    in eval mode or in training."""
    x, mask, _ = _ragged()

    def refuse(*a, **k):
        raise AssertionError("packed")

    monkeypatch.setattr(torch.nn.utils.rnn, "pack_padded_sequence", refuse)
    module = trnn.BiRNN(5, 3, num_layers=2)
    with torch.no_grad():
        out = module.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    with torch.enable_grad():
        module.train()(torch.from_numpy(x), torch.from_numpy(mask)).sum().backward()
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
    """No batch carries host lengths: ``to_device`` copies the arrays it is
    given (None left out) and adds none."""
    batch = InferenceEngine.from_module("dgcn", batch_size=2, device="cpu", **DGCN_KW).batcher(_dialogues(2))
    out = to_device(batch, torch.device("cpu"))
    assert out.keys() == {k for k, v in batch.items() if v is not None}
    assert "host_lengths" not in inspect.signature(to_device).parameters


def test_captured_step_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_graphs.CapturedStep(lambda b: {}, torch.device("cpu"))


def test_captured_step_shares_the_bucket_key():
    """A bucket is the (key, shape, dtype) of every array, in key order, for
    the step as for the forward."""
    assert cuda_graphs.CapturedStep._bucket_key is cuda_graphs.CapturedForward._bucket_key
    key = cuda_graphs.CapturedStep._bucket_key
    a = {"m": np.zeros((2, 3), np.float32), "ids": np.zeros((2, 3), np.int64)}
    assert key(a) == (("ids", (2, 3), "<i8"), ("m", (2, 3), "<f4"))
    assert key(a) == key(dict(reversed(list(a.items()))))
    assert key(a) != key({**a, "m": np.zeros((2, 4), np.float32)})
    assert key(a) != key({**a, "ids": np.zeros((2, 3), np.int32)})


def test_address_watch_passes_in_place_writes_and_raises_on_a_replaced_tensor():
    """The watch both captured kinds use: addresses taken at the first
    capture; writing in place (an optimizer step, the LR's fill_) passes,
    replacing a watched tensor raises, and a reset takes them anew."""
    p = torch.nn.Parameter(torch.ones(3))
    lr = torch.tensor(1e-3)
    held = {"p": p, "lr": lr}
    watch = cuda_graphs._Watch(lambda: [held["p"], held["lr"]])
    watch.check()  # nothing recorded yet
    watch.record()
    with torch.no_grad():
        p.add_(1.0)
    lr.fill_(1e-4)
    watch.check()
    assert watch.unchanged()
    held["lr"] = torch.tensor(1e-4)
    assert not watch.unchanged()
    with pytest.raises(RuntimeError, match="replaced"):
        watch.check()
    watch.addresses = None
    watch.record()
    watch.check()


def _dgcn_sgd_trainer():
    from erc_tpu_torch.models import dgcn

    p = dgcn.DGCNParams()
    p.finalize(["--dataset=synthetic-cogmen-6", "--device=cpu", "--hidden_size=8", "--max_seq_len=16",
                "--optim.name=SGD", "--optim.momentum=0.9", "--optim.nesterov=true"])
    trainer = dgcn.DGCNTrainer(p)
    trainer.log = lambda msg: None
    trainer.initialize()
    return trainer


def test_trainer_with_sgd_builds_a_capturable_optimizer(monkeypatch):
    """``--optim.name=SGD`` builds the port's ``Sgd``; built for a CUDA device its groups are capturable with a
    0-d tensor LR, and the trainer then hands its step to ``CapturedStep`` (both stubbed: nothing of
    ``torch.cuda`` is touched)."""
    from erc_tpu_torch.train import optim as toptim
    from erc_tpu_torch.train import trainer as ttrainer

    trainer = _dgcn_sgd_trainer()
    assert type(trainer.optimizer) is toptim.Sgd and not trainer.optimizer.param_groups[0]["capturable"]
    monkeypatch.setattr(toptim, "lr_tensor", lambda lr, device: torch.tensor(lr))
    opt = toptim.build_optim(trainer.params.optim, trainer.model.named_parameters(), device=torch.device("cuda"))
    assert type(opt) is toptim.Sgd and all(g["capturable"] for g in opt.param_groups)
    assert all(isinstance(g["lr"], torch.Tensor) and g["lr"].ndim == 0 for g in opt.param_groups)
    assert opt.defaults["momentum"] == 0.9 and opt.defaults["nesterov"] and not opt.state  # traces made at step 1
    made = []
    monkeypatch.setattr(ttrainer, "CapturedStep", lambda *a, **k: made.append(k) or "captured")
    trainer.optimizer = opt
    assert trainer.captured_step == "captured" and len(made) == 1


def test_trainer_with_sgd_refuses_the_captured_step():
    """A hand-set optimizer that cannot be captured (torch's SGD, whose LR is a Python number) is refused where
    the captured step is asked for."""
    trainer = _dgcn_sgd_trainer()
    trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=0.1, momentum=0.9)
    with pytest.raises(NotImplementedError, match="train_graphs = False"):
        trainer.captured_step


def test_cpu_trainer_steps_eagerly_and_never_touches_cuda(monkeypatch):
    from erc_tpu_torch.models import dgcn
    from erc_tpu_torch.train import trainer as ttrainer

    def refuse(*a, **k):
        raise AssertionError("torch.cuda touched on the CPU route")

    for name in ("CUDAGraph", "Stream", "Event", "graph", "graph_pool_handle", "current_stream", "synchronize",
                 "is_available", "device_count", "get_device_name", "stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(ttrainer, "CapturedStep", refuse)
    monkeypatch.setattr(ttrainer, "CapturedForward", refuse)
    p = dgcn.DGCNParams()
    p.finalize(["--dataset=synthetic-cogmen-6", "--device=cpu", "--hidden_size=8", "--max_seq_len=16",
                "--train.batch_size=4", "--test.batch_size=4", "--epoch=1", "--batch_count=2",
                "--confusion_matrix=false"])
    trainer = dgcn.DGCNTrainer(p)
    trainer.log = lambda msg: None
    (rec,) = trainer.train()
    assert rec["steps"] == 2 and trainer.global_steps == 2 and np.isfinite(rec["Lall"])
    assert trainer._captured_step is None and trainer._captured is None


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


# ------------------------------------------------------------------ the TextCNNs' convolutions
@pytest.mark.parametrize("widths,C,F,W", [((3, 4, 5), 7, 5, 9), ((3,), 4, 6, 3), ((2, 5), 3, 2, 11)])
def test_conv1d_gemm_equals_conv1d(widths, C, F, W):
    """``conv1d_gemm`` ≡ the ``nn.Conv1d`` layers it computes (VALID, stride
    1, K up to W), outputs and the gradients of the input, weights and biases
    within 1e-5."""
    from erc_tpu_torch.ops.conv import conv1d_gemm

    g = torch.Generator().manual_seed(len(widths) + C)
    convs = [torch.nn.Conv1d(C, F, k) for k in widths]
    with torch.no_grad():
        for c in convs:
            c.weight.copy_(torch.randn(c.weight.shape, generator=g))
            c.bias.copy_(torch.randn(c.bias.shape, generator=g))
    x = torch.randn(4, W, C, generator=g)
    cots = [torch.randn(4, W - k + 1, F, generator=g) for k in widths]
    runs = []
    for gemm in (False, True):
        xx = x.clone().requires_grad_()
        for c in convs:
            c.zero_grad(set_to_none=True)
        with torch.enable_grad():
            outs = conv1d_gemm(xx, convs) if gemm else [c(xx.transpose(1, 2)).transpose(1, 2) for c in convs]
            sum((o * t).sum() for o, t in zip(outs, cots)).backward()
        runs.append([o.detach() for o in outs] + [xx.grad] + [p.grad.clone() for c in convs for p in c.parameters()])
    assert [tuple(o.shape) for o in runs[1][:len(widths)]] == [(4, W - k + 1, F) for k in widths]
    for got, want in zip(runs[1], runs[0]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
