"""The port's DialogueGCN v2 (models.dgcnv2, models.dgcnv2_daily and their
ops and data) ≡ the JAX package's.

On the CPU at small size: B = 3 with one all-padding dialogue, ragged
L ≤ 9, inputs 12 wide (audio, text and visual 4 each) or the full 712 in the
trainer trajectory, hidden 4 or 8, D_g = D_p ≤ 8, vocabulary 50, 6 words an
utterance, embedding 8.  The same numpy inputs and converted weights go
through JAX (float32, matmul precision highest, dropout off) and the port.
Outputs within 1e-5 absolute at every position, padding included;
gradients within 1e-5 of each gradient's norm (floored at 1e-8 of the
global norm where the exact gradient is 0); losses within 1e-5 relative.

Covered: ``synthetic_daily``, ``DailyBatcher`` and the DailyDialog reader in
its three layouts with a malformed line, and the registry's DailyDialog
names; ``BiRNN``'s GRU form (1 and 2 layers, masked and over every padded
step); ``DialogueRNNScan`` with 2 and 3 parties; ``reverse_padded``,
``MaskedEdgeAttentionDense`` and ``CNNFeatureExtractor``; ``DGCNV2Module``
for each base encoder and ``lstm_mode`` and for the token track, with the
class-weighted loss; the full-width parameter counts; ``dgcnv2_state`` and
the convert CLI; JAX Saver files of both tracks served or loaded by the
port; 3-step ``DGCNV2Trainer`` (DialogRNN) and ``DGCNV2DailyTrainer``
trajectories; the seeded dropout; both entry points for two steps that save
and serve; and each entry point without CUDA raises.
"""

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

from erc_tpu.data import dailydialog as jdd
from erc_tpu.data import registry as jregistry
from erc_tpu.data.collate import ERCBatcher as JERCBatcher
from erc_tpu.data.synthetic import synthetic_daily as j_synthetic_daily
from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu.models import dgcnv2 as jdgcnv2
from erc_tpu.ops import graphs as jgraphs
from erc_tpu.ops import rnn as jrnn
from erc_tpu.train import checkpoint as jcheckpoint
from erc_tpu.train import optim as joptim
from erc_tpu.train import trainer as jtrainer
from erc_tpu.train.trainer import TrainState
from erc_tpu_torch import convert
from erc_tpu_torch.data import dailydialog as tdd
from erc_tpu_torch.data import registry as tregistry
from erc_tpu_torch.data.synthetic import synthetic_daily
from erc_tpu_torch.models import dgcnv2 as tdgcnv2
from erc_tpu_torch.models import dgcnv2_daily as tdaily
from erc_tpu_torch.ops import rnn as trnn
from erc_tpu_torch.serve import InferenceEngine
from erc_tpu_torch.train.checkpoint import load_model_state
from erc_tpu_torch.train.trainer import masked_cross_entropy
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-5
DIMS = dict(text_dim=4, audio_dim=4, visual_dim=4)
WEIGHTS = np.asarray(jdgcnv2.IEMOCAP6_LOSS_WEIGHTS, np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if v is not None}


def _assert_close_rel(got, want, what, rtol=RTOL, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), what
    d = np.linalg.norm(got - want)
    assert d <= max(rtol * np.linalg.norm(want), floor), (what, d, np.linalg.norm(want))


def _assert_grads_close(named, want, global_norm=None):
    """‖got − want‖ ≤ max(RTOL · ‖want‖, 1e-8 · global norm)."""
    if global_norm is None:
        global_norm = float(np.sqrt(sum(float((want[n].double() ** 2).sum()) for n, _ in named)))
    assert {n for n, _ in named} == set(want)
    for name, g in named:
        _assert_close_rel(g.numpy(), want[name].numpy(), name, floor=1e-8 * global_norm)


def _jax_vjp(fn, *primals, seed=9):
    """fn(*primals) and its VJP of a seeded cotangent, jitted as one function
    at matmul precision highest; returns (value, cotangent, grads)."""
    cot = np.random.default_rng(seed).normal(size=jax.eval_shape(fn, *primals).shape).astype(np.float32)

    def run(*p):
        out, vjp = jax.vjp(fn, *p)
        return out, vjp(jnp.asarray(cot))

    with jax.default_matmul_precision("highest"):
        out, grads = jax.jit(run)(*primals)
    return np.asarray(out), cot, _np_tree(grads)


def _port_vjp(module, fn, cot, *inputs):
    """fn(*inputs) through ``module``, and the gradients of <fn, cot> for the
    inputs and every parameter."""
    ts = [torch.from_numpy(np.array(x)).requires_grad_() for x in inputs]
    module.zero_grad()
    with torch.enable_grad():
        out = fn(*ts)
        out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts], {n: p.grad for n, p in module.named_parameters()}


def _ragged(B=3, L=9, D=6, seed=0):
    """x [B, L, D] zero at padding, with row 1 all padding; mask; lengths."""
    r = np.random.default_rng(seed)
    lengths = np.array([L, 0, 5], np.int32)[:B]
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    return (r.normal(size=(B, L, D)) * mask[..., None]).astype(np.float32), mask, lengths


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("kw", [dict(), dict(seed=3, vocab=50, n_train=7), dict(vocab=5, n_classes=7, n_train=4),
                                dict(n_classes=4, min_len=2, max_len=3, n_words=5, seed=11)])
@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_synthetic_daily_matches_jax(kw, split):
    assert synthetic_daily(split=split, **kw) == j_synthetic_daily(split=split, **kw)


def test_daily_batcher_matches_jax():
    """Dialogues longer than max_len and utterances longer than n_words are
    cut; the batch is padded to 4 rows."""
    samples = j_synthetic_daily(7, "train", n_train=3, vocab=50, min_len=4, max_len=12, n_words=20, seed=2)
    want = jdgcnv2.DailyBatcher(n_words=6, max_len=9, pad_batch_to=4)(samples)
    got = tdgcnv2.DailyBatcher(n_words=6, max_len=9, pad_batch_to=4)(samples)
    assert got.keys() == want.keys() and got["input_tensor"] is None
    for k, v in want.items():
        if v is not None:
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["token_ids"].shape == (4, 9, 6) and got["text_length"][3] == 0


def test_daily_example_batch_matches_jax():
    """DGCNV2DailyTrainer.example_batch: the JAX trainer's (one device, so the
    batch is padded to B)."""
    p = tdgcnv2.DGCNV2DailyParams()
    p.finalize(["--dataset=synthetic-daily-token-7", "--vocab_size=50", "--n_words=6", "--max_seq_len=12",
                "--device=cpu"])
    got = tdgcnv2.DGCNV2DailyTrainer(p).example_batch(L=7, B=3)
    want = jdgcnv2.DailyBatcher(n_words=6, max_len=12, pad_batch_to=3)(
        j_synthetic_daily(7, "train", n_train=3, min_len=7, max_len=7, vocab=50))
    for k, v in want.items():
        if v is not None:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


_DAILY_FILES = {
    "train": (["Hi there . __eou__ Hello ! __eou__", "How are you ? __eou__ Fine , thanks . __eou__ Good __eou__",
               "malformed line __eou__ two utterances __eou__", "__eou__", "Hello again __eou__ hi hi there __eou__"],
              ["0 4", "0 4 4", "1", "", "6 0"]),
    "validation": (["Hello unknownword __eou__", "A B __eou__ C __eou__"], ["3", "5 2"]),
    "test": (["there you are __eou__ Hi __eou__ What ? __eou__"], ["1 2 0"]),
}


def _write_daily(root: Path, layout: str):
    for split, (text, emo) in _DAILY_FILES.items():
        d = {"split": root / split, "flat": root, "ijcnlp": root / "ijcnlp_dailydialog" / split}[layout]
        d.mkdir(parents=True, exist_ok=True)
        (d / f"dialogues_{split}.txt").write_text("\n".join(text) + "\n", encoding="utf-8")
        (d / f"dialogues_emotion_{split}.txt").write_text("\n".join(emo) + "\n", encoding="utf-8")


@pytest.mark.parametrize("layout", ["split", "flat", "ijcnlp"])
def test_dailydialog_reader_matches_jax(tmp_path, layout):
    _write_daily(tmp_path, layout)
    root = str(tmp_path)
    for vocab_size in (5, 20000):
        assert tdd.build_vocab(root, vocab_size) == jdd.build_vocab(root, vocab_size)
        for split in ("train", "val", "test"):
            got = tdd.dailydialog_token(root, split, vocab_size=vocab_size)
            assert got == jdd.dailydialog_token(root, split, vocab_size=vocab_size), (split, vocab_size)
            assert got == tregistry.pick_datas(root, "dailydialog-token-7", split, vocab_size=vocab_size)
    train = tdd.dailydialog_token(root, "train")
    assert len(train) == 3 and [len(s["label"]) for s in train] == [2, 3, 2]  # the malformed lines skipped
    assert train[0]["speakers"] == [0, 1] and tdd.build_vocab(root, 5)["hi"] == 2


def test_dailydialog_reader_raises_where_files_are_missing(tmp_path):
    for reader in (tdd.dailydialog_token, jdd.dailydialog_token):
        with pytest.raises(FileNotFoundError, match="synthetic-daily-token-7"):
            reader(str(tmp_path / "none"), "train")


def test_registry_daily_names_match_jax():
    for split in ("train", "test"):
        kw = dict(vocab_size=60, n_train=5)
        got = tregistry.pick_datas(None, "synthetic-daily-token-7", split, **kw)
        assert got == jregistry.pick_datas(None, "synthetic-daily-token-7", split, **kw)
        assert tregistry.pick_datas(None, "synthetic-daily-token-7", split) == jregistry.pick_datas(
            None, "synthetic-daily-token-7", split)
    assert tregistry.regist_data["dailydialog-token-7"] is tdd.dailydialog_token
    assert tregistry.dataset_has_val("dailydialog-token-7") and tregistry.n_classes_of("dailydialog-token-7") == 7
    # MOSEI's generator is ported, and MMIN's: the same utterances as JAX's
    got, want = (m.pick_datas(None, "synthetic-mmin-4", "test")[0] for m in (tregistry, jregistry))
    assert got["name"] == want["name"] and (got["text_feature"] == want["text_feature"]).all()


# ------------------------------------------------------------------ BiRNN, GRU form
@pytest.mark.parametrize("rnn_mask", ["packed", "ones"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_birnn_gru_matches_jax(num_layers, rnn_mask):
    lengths = np.array([9, 0, 5, 1], np.int32)  # a full row, a padding row, ragged rows
    mask = (np.arange(9)[None] < lengths[:, None]).astype(np.float32)
    x = (np.random.default_rng(1).normal(size=(4, 9, 6)) * mask[..., None]).astype(np.float32)
    if rnn_mask == "ones":  # every padded step runs, as lstm_mode='unpacked' has it
        mask = np.ones_like(mask)
    jm = jrnn.BiRNN(hidden_size=5, num_layers=num_layers, cell="gru", bidirectional=True)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), x, mask))["params"]
    want, cot, (gp, gx) = _jax_vjp(lambda p, xx: jm.apply({"params": p}, xx, mask), params, x)
    module = trnn.BiRNN(6, 5, num_layers=num_layers, cell="gru")
    assert all(isinstance(layer, torch.nn.GRU) for layer in module.layers)
    module.load_state_dict(convert.birnn_state(params))
    got, (tx,), grads = _port_vjp(module, lambda xx: module(xx, torch.from_numpy(mask)), cot, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _assert_grads_close(list(grads.items()), convert.birnn_state(gp))
    _assert_close_rel(tx, gx, "x")


def test_birnn_rejects_an_unknown_cell():
    with pytest.raises(ValueError, match="unknown cell"):
        trnn.BiRNN(4, 3, cell="rnn")


def test_conv_backward_runs_in_full_float32():
    """The TextCNN's convolutions: the forward block and the hooks on the
    convolution's backward node put cuDNN's conv setting at full float32, and
    restore the flag after."""
    conv_fp32 = torch.backends.cudnn.conv
    seen = []

    class ConvolutionBackwardStandIn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            seen.append(conv_fp32.fp32_precision)
            return g * 2

    prev = conv_fp32.fp32_precision
    try:
        conv_fp32.fp32_precision = "tf32"
        with trnn.cudnn_full_fp32(conv_fp32):
            assert conv_fp32.fp32_precision == "ieee"
        assert conv_fp32.fp32_precision == "tf32"
        x = torch.ones(3, requires_grad=True)
        with torch.enable_grad():
            y = ConvolutionBackwardStandIn.apply(x)
            trnn._backward_in_full_fp32(y, conv_fp32, "ConvolutionBackward")
            y.sum().backward()
        assert seen == ["ieee"] and conv_fp32.fp32_precision == "tf32"
    finally:
        conv_fp32.fp32_precision = prev


# ------------------------------------------------------------------ DialogueRNN and the small layers
@pytest.mark.parametrize("P", [2, 3])
def test_dialogue_rnn_matches_jax(P):
    """Every position, padding included, and the gradients of every
    parameter and of the input; the speakers revisit each party."""
    U, mask, _ = _ragged(D=6, seed=P)
    U[1] = np.random.default_rng(7).normal(size=U[1].shape)  # padding rows carry values too
    spk = np.array([[0, 1, 0, P - 1, 1, 0, P - 1, 0, 1], [0] * 9, [P - 1, 0, P - 1, 0, 1, 0, 0, 0, 0]])
    qmask = (np.eye(P)[spk] * mask[..., None]).astype(np.float32)
    jm = jdgcnv2.DialogueRNNScan(6, 5, 4, 3, n_parties=P)
    params = _np_tree(jm.init(jax.random.PRNGKey(P), U, qmask, mask))["params"]
    want, cot, (gp, gu) = _jax_vjp(lambda p, u: jm.apply({"params": p}, u, qmask, mask), params, U)
    module = tdgcnv2.DialogueRNNScan(6, 5, 4, 3, n_parties=P).eval()
    module.load_state_dict(convert.as_is_state(params))
    got, (tu,), grads = _port_vjp(module, lambda u: module(u, torch.from_numpy(qmask)), cot, U)
    assert got.shape == (3, 9, 3) and np.abs(got[1]).max() > 0  # the padding dialogue's emotions
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _assert_grads_close(list(grads.items()), convert.as_is_state(gp))
    _assert_close_rel(tu, gu, "U")


def test_reverse_padded_matches_jax():
    x, mask, _ = _ragged(D=4)
    x[1] = 1.0  # padding values are dropped
    want, cot, (gx,) = _jax_vjp(lambda a: jdgcnv2.reverse_padded(a, jnp.asarray(mask)), x)
    got = tdgcnv2.reverse_padded(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2, :5], x[2, 4::-1])
    xt = torch.from_numpy(x).requires_grad_()
    with torch.enable_grad():
        tdgcnv2.reverse_padded(xt, torch.from_numpy(mask)).backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(xt.grad.numpy(), gx)


def test_masked_edge_attention_matches_jax():
    x, mask, lengths = _ragged(D=6, seed=4)
    jm = jdgcnv2.MaskedEdgeAttentionDense(6, 12, 3, 2)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), x, lengths))["params"]
    want, cot, (gp, gx) = _jax_vjp(lambda p, a: jm.apply({"params": p}, a, lengths), params, x)
    module = tdgcnv2.MaskedEdgeAttentionDense(6, 12, 3, 2)
    module.load_state_dict(convert.as_is_state(params))
    got, (tx,), grads = _port_vjp(module, lambda a: module(a, torch.from_numpy(lengths)), cot, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.all(got[1] == 0.0)
    _assert_grads_close(list(grads.items()), convert.as_is_state(gp))
    _assert_close_rel(tx, gx, "x")


def test_cnn_feature_extractor_matches_jax():
    """Word padding (id 0) runs through the convolutions and the max, as in
    flax; the embedding's gradient included."""
    samples = j_synthetic_daily(7, "train", n_train=3, vocab=50, min_len=4, max_len=9, n_words=8, seed=5)
    batch = jdgcnv2.DailyBatcher(n_words=6, max_len=9, pad_batch_to=3)(samples)
    tok, mask = batch["token_ids"], batch["attention_mask"]
    jm = jdgcnv2.CNNFeatureExtractor(50, embedding_dim=8, output_size=5, filters=4)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), tok, mask))["params"]
    assert params["conv_5"]["kernel"].shape == (5, 8, 4)
    want, cot, (gp,) = _jax_vjp(lambda p: jm.apply({"params": p}, tok, mask), params)
    module = tdgcnv2.CNNFeatureExtractor(50, embedding_dim=8, output_size=5, filters=4).eval()
    assert module.embedding.padding_idx is None
    module.load_state_dict(convert.text_cnn_state(params))
    got, _, grads = _port_vjp(module, lambda: module(torch.from_numpy(tok), torch.from_numpy(mask)), cot)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _assert_grads_close(list(grads.items()), convert.text_cnn_state(gp))
    assert grads["embedding.weight"][0].abs().sum() > 0  # the PAD row trains


# ------------------------------------------------------------------ DGCNV2Module
# (case id, base_model, lstm_mode, n_speakers, token track)
CASES = [("DialogRNN", "DialogRNN", "packed", 2, False), ("DialogRNN-s3", "DialogRNN", "packed", 3, False),
         ("LSTM-packed", "LSTM", "packed", 2, False), ("LSTM-unpacked", "LSTM", "unpacked", 2, False),
         ("GRU-packed", "GRU", "packed", 2, False), ("GRU-unpacked", "GRU", "unpacked", 2, False),
         ("None", "None", "packed", 2, False), ("daily-LSTM", "LSTM", "packed", 2, True)]


def _module_kw(base_model, lstm_mode, n_speakers, daily):
    kw = dict(base_model=base_model, input_size=12, hidden_size=4, n_speakers=n_speakers, wp=3, wf=2, n_classes=6,
              dropout_rec=0.0, drop_rate=0.0, max_seq_len=9, graph_hidden_size=8, d_g=6, d_p=5,
              lstm_mode=lstm_mode)
    if daily:
        kw.update(input_size=7, vocab_size=50, embedding_dim=8, cnn_output_size=7, cnn_filters=4, cnn_dropout=0.0)
    return kw


def _module_batch(n_speakers, daily, seed=0):
    """3 rows, 2 of them dialogues (one ragged), the third padding."""
    if daily:
        samples = j_synthetic_daily(6, "train", n_train=2, vocab=50, min_len=4, max_len=9, n_words=8, seed=seed)
        return jdgcnv2.DailyBatcher(n_words=6, max_len=9, pad_batch_to=3)(samples)
    samples = j_synthetic_erc("custom", 6, "train", n_train=2, min_len=4, max_len=9, seed=seed, **DIMS)
    batch = JERCBatcher("atv", 6, 2, speaker_onehot=True, max_len=9, pad_batch_to=3)(samples)
    if n_speakers > 2:
        spk = np.random.default_rng(seed).integers(0, n_speakers, size=batch["speaker_ids"].shape)
        batch["speaker_ids"] = (spk * batch["attention_mask"]).astype(np.int32)
    return batch


def _jax_loss(model, batch):
    def loss(params):
        logits = model.apply({"params": params}, batch, deterministic=True)
        return jtrainer.masked_cross_entropy(logits, batch["label"], batch["attention_mask"],
                                             jnp.asarray(WEIGHTS)), logits

    return loss


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def jax_module_run(request):
    """(case, batch, flax tree, logits, gradients of the class-weighted loss)."""
    _, base_model, lstm_mode, n_speakers, daily = request.param
    batch = _module_batch(n_speakers, daily)
    model = jdgcnv2.DGCNV2Module(**_module_kw(base_model, lstm_mode, n_speakers, daily))
    params = _np_tree(model.init(jax.random.PRNGKey(0), batch))["params"]
    with jax.default_matmul_precision("highest"):
        (_, logits), grads = jax.jit(jax.value_and_grad(_jax_loss(model, batch), has_aux=True))(params)
    return request.param, batch, params, np.asarray(logits), _np_tree(grads)


def test_dgcnv2_module_matches_jax(jax_module_run):
    (_, base_model, lstm_mode, n_speakers, daily), batch, params, logits, grads = jax_module_run
    module = tdgcnv2.DGCNV2Module(**_module_kw(base_model, lstm_mode, n_speakers, daily))
    module.load_state_dict(convert.dgcnv2_state(params))
    tb = _t(batch)
    got = module.eval()(tb).detach().numpy()
    assert got.shape == (3, 9, 6)
    np.testing.assert_allclose(got, logits, rtol=0, atol=ATOL)  # every position, padding included
    module.train()
    with torch.enable_grad():
        loss = masked_cross_entropy(module(tb), tb["label"], tb["attention_mask"], torch.from_numpy(WEIGHTS))
        loss.backward()
    _assert_grads_close([(n, p.grad) for n, p in module.named_parameters()], convert.dgcnv2_state(grads))


def test_bad_options_raise():
    with pytest.raises(ValueError, match="base_model"):
        tdgcnv2.DGCNV2Module(**{**_module_kw("LSTM", "packed", 2, False), "base_model": "RNN"})
    with pytest.raises(ValueError, match="lstm_mode"):
        tdgcnv2.DGCNV2Module(**_module_kw("GRU", "masked", 2, False))


def test_head_dropout_is_half_and_only_with_drop_rate():
    kw = _module_kw("None", "packed", 2, False)
    assert tdgcnv2.DGCNV2Module(**{**kw, "drop_rate": 0.4}).dropout.p == 0.5
    assert tdgcnv2.DGCNV2Module(**kw).dropout.p == 0.0


@pytest.mark.parametrize("base_model, want", [("DialogRNN", 2_977_146), ("LSTM", 1_679_946), ("GRU", 1_456_746),
                                              ("None", 929_746), ("daily", 7_385_697)])
def test_parameter_count_at_full_width(base_model, want):
    """DGCNV2Params on synthetic-cogmen-6 (712 inputs) for each base encoder,
    and DGCNV2DailyParams (vocabulary 20 000, embedding 300): the JAX trees'
    counts and the converted state dict's shapes."""
    daily = base_model == "daily"
    p = tdgcnv2.DGCNV2DailyParams() if daily else tdgcnv2.DGCNV2Params()
    p.finalize(["--dataset=synthetic-daily-token-7" if daily else "--dataset=synthetic-cogmen-6", "--device=cpu"])
    if not daily:
        p.base_model = base_model  # the command line would read "None" as None, in either package
    model = tdgcnv2.build(p, generator=torch.Generator().manual_seed(0))
    if daily:
        batch = jdgcnv2.DailyBatcher(n_words=50, max_len=128, pad_batch_to=1)(
            j_synthetic_daily(7, "train", n_train=1))
        jm = jdgcnv2.DGCNV2Module(base_model="LSTM", input_size=100, n_classes=7, max_seq_len=128, vocab_size=20000)
    else:
        batch = JERCBatcher("atv", 6, 2, speaker_onehot=True, max_len=8)(
            j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=1, min_len=4, max_len=8))
        jm = jdgcnv2.DGCNV2Module(base_model=base_model, input_size=712, n_classes=6, max_seq_len=128)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))["params"]
    assert sum(t.numel() for t in model.parameters()) == want
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)) == want
    sd = convert.dgcnv2_state(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in model.state_dict().items()}


# ------------------------------------------------------------------ weights from JAX
def test_convert_cli_and_load_model_state(jax_module_run, tmp_path):
    (_, _, _, _, daily), batch, params, logits, _ = jax_module_run
    module = "dgcnv2_daily" if daily else "dgcnv2"
    flat = {"params/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "v.npz", **flat)
    convert.main([f"--module={module}", str(tmp_path / "v.npz"), str(tmp_path / "sd.pt")])
    sd, want = torch.load(tmp_path / "sd.pt", weights_only=True), convert.dgcnv2_state(params)
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)
    # the JAX Saver's file, loaded for the module
    tx = joptim.build_optim(joptim.create_optim("Adam", lr=3e-4, weight_decay=0))
    state = TrainState(params=params, opt_state=tx.init(params), model_state={}, step=jnp.asarray(3))
    path = jcheckpoint.Saver(str(tmp_path)).save_model("last", state, meta={"eidx": 1})
    sd = load_model_state(path, module)
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)


def test_jax_checkpoint_serves_through_the_port(jax_module_run, tmp_path):
    """The JAX Saver's file → InferenceEngine's logits of a packed batch ≡
    JAX's (the token track's batch too, though its engine has no batcher)."""
    (_, base_model, lstm_mode, n_speakers, daily), batch, params, logits, _ = jax_module_run
    tx = joptim.build_optim(joptim.create_optim("Adam", lr=3e-4, weight_decay=0))
    state = TrainState(params=params, opt_state=tx.init(params), model_state={}, step=jnp.asarray(3))
    path = jcheckpoint.Saver(str(tmp_path)).save_model("last", state, meta={"eidx": 1})
    p = tdgcnv2.DGCNV2Params()
    p.finalize(["--module=dgcnv2", "--dataset=synthetic-cogmen-6", "--device=cpu"])
    model = tdgcnv2.DGCNV2Module(**_module_kw(base_model, lstm_mode, n_speakers, daily))
    engine = InferenceEngine(model, p, torch.device("cpu"), path, batch_size=3)
    np.testing.assert_allclose(engine.logits(batch), logits, rtol=0, atol=ATOL)


# ------------------------------------------------------------------ training
FEATURE_SMALL = ["--dataset=synthetic-cogmen-6", "--base_model=DialogRNN", "--hidden_size=8", "--d_g=8", "--d_p=8",
                 "--device=cpu"]
DAILY_SMALL = ["--dataset=synthetic-daily-token-7", "--vocab_size=50", "--n_words=6", "--embedding_dim=8",
               "--max_seq_len=9", "--hidden_size=8", "--device=cpu"]


def _port_trainer(daily: bool, *extra, dropout_off=True):
    cls, params_cls = ((tdgcnv2.DGCNV2DailyTrainer, tdgcnv2.DGCNV2DailyParams) if daily
                       else (tdgcnv2.DGCNV2Trainer, tdgcnv2.DGCNV2Params))
    p = params_cls()
    p.finalize((DAILY_SMALL if daily else FEATURE_SMALL) + list(extra))
    trainer = cls(p)
    trainer.log = lambda msg: None
    trainer.initialize()
    if dropout_off:
        for m in trainer.model.modules():
            if isinstance(m, tdgcnv2.Dropout):
                m.p = 0.0
    return trainer


@pytest.mark.parametrize("daily", [False, True], ids=["DialogRNN", "daily"])
def test_three_step_trajectory_matches_jax(daily):
    """Adam 3e-4 with no weight decay; the IEMOCAP-6 class weights on the
    feature track (full input width 712), none on the token track."""
    if daily:
        batcher = jdgcnv2.DailyBatcher(n_words=6, max_len=9, pad_batch_to=3)
        batches = [batcher(j_synthetic_daily(7, "train", n_train=2, vocab=50, seed=s)) for s in range(3)]
        jm = jdgcnv2.DGCNV2Module(base_model="LSTM", input_size=100, hidden_size=8, n_classes=7, max_seq_len=9,
                                  vocab_size=50, embedding_dim=8, dropout_rec=0.0, drop_rate=0.0, cnn_dropout=0.0)
        weights = None
    else:
        batcher = JERCBatcher("atv", 6, 2, speaker_onehot=True, bucket=16, max_len=16, pad_batch_to=3)
        batches = [batcher(j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=2, min_len=5, max_len=16, seed=s))
                   for s in range(3)]
        jm = jdgcnv2.DGCNV2Module(base_model="DialogRNN", input_size=712, hidden_size=8, n_classes=6, d_g=8, d_p=8,
                                  max_seq_len=128, dropout_rec=0.0, drop_rate=0.0)
        weights = jnp.asarray(WEIGHTS)
    trainer = _port_trainer(daily)
    assert trainer.grad_clip_norm is None and trainer.lr_sche is None
    assert (trainer.class_weights is None) == daily
    jp = jdgcnv2.DGCNV2DailyParams() if daily else jdgcnv2.DGCNV2Params()
    assert (jp.optim.lr, jp.optim.weight_decay) == (trainer.params.optim.lr, trainer.params.optim.weight_decay)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), batches[0]))["params"]
    trainer.model.load_state_dict(convert.dgcnv2_state(params))
    tx = joptim.build_optim(jp.optim)

    def loss_fn(params, batch):
        logits = jm.apply({"params": params}, batch, deterministic=True)
        return jtrainer.masked_cross_entropy(logits, batch["label"], batch["attention_mask"], weights)

    @jax.jit
    def step(params, opt_state, batch):  # Trainer._make_raw_train_step's composition
        value, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, value, optax.global_norm(grads)

    opt_state = tx.init(params)
    for i, batch in enumerate(batches):
        jbatch = {k: v for k, v in batch.items() if v is not None}
        with jax.default_matmul_precision("highest"):
            params, opt_state, loss, gnorm = step(params, opt_state, jbatch)
        mets = trainer.train_step(_t(batch))
        np.testing.assert_allclose(mets["Lall"].item(), float(loss), rtol=RTOL, err_msg=f"loss {i}")
        np.testing.assert_allclose(mets["gnorm"].item(), float(gnorm), rtol=RTOL, err_msg=f"gnorm {i}")
    want = convert.dgcnv2_state(_np_tree(params))
    for name, t in trainer.model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_dropout_draws_from_the_seeded_generator():
    """DialogueRNN's masks (both directions) and the head's: the same seed gives
    the same masks, another seed others, and the stream moves on."""
    batch = _t(_module_batch(2, False))
    batch["input_tensor"] = torch.randn(3, 9, 712, generator=torch.Generator().manual_seed(0))
    runs = {}
    for i, seed in enumerate((3, 3, 4)):
        t = _port_trainer(False, f"--seed={seed}", dropout_off=False)
        drops = [m for m in t.model.modules() if isinstance(m, tdgcnv2.Dropout)]
        assert sorted(m.p for m in drops) == [0.5, 0.5, 0.5] and all(m.generator is not None for m in drops)
        t.model.train()
        torch.manual_seed(i)  # the global RNG plays no part
        runs.setdefault(seed, []).append((t.model(batch).detach(), t.model(batch).detach()))
    (a1, a2), (b1, _) = runs[3]
    np.testing.assert_array_equal(a1.numpy(), b1.numpy())
    assert not torch.equal(a1, a2) and not torch.equal(a1, runs[4][0][0])


def _run_entry_point(args):
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
    assert "model DGCNV2Module" in out and "e0 b0 Lall=" in out and "2 steps" in out and "test: acc=" in out, out
    assert "JAX modules: []" in out
    return out


def test_feature_entry_point_runs_two_steps_saves_and_serves(tmp_path):
    args = [*FEATURE_SMALL, "--module=dgcnv2", "--epoch=1", "--batch_count=2", "--max_seq_len=32",
            "--train.batch_size=4", "--test.batch_size=16", "--confusion_matrix=false", f"--save_dir={tmp_path}"]
    out = _run_entry_point(args)
    path = tmp_path / "model.last.ckpt"
    assert path.exists() and f"saved {path}" in out
    engine = InferenceEngine.from_module("dgcnv2", str(path), dataset="synthetic-cogmen-6", batch_size=4,
                                         base_model="DialogRNN", hidden_size=8, d_g=8, d_p=8, max_seq_len=32,
                                         device="cpu")
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 2
    model = tdgcnv2.DGCNV2Module("DialogRNN", 712, hidden_size=8, n_classes=6, max_seq_len=32, d_g=8, d_p=8)
    model.load_state_dict(saved["model"])
    batch = engine.batcher(j_synthetic_erc("iemocap-cogmen", 6, "test", n_train=4, max_len=20, seed=5)[:4])
    with torch.no_grad():
        want = model.eval()(_t(batch)).numpy()
    np.testing.assert_allclose(engine.logits(batch), want, rtol=0, atol=1e-5)
    results = engine.predict(j_synthetic_erc("iemocap-cogmen", 6, "test", n_train=3, max_len=20, seed=6)[:3])
    assert all(np.isfinite(r["probs"]).all() and np.allclose(np.sum(r["probs"], -1), 1.0, atol=1e-5)
               for r in results)


def test_daily_entry_point_runs_two_steps_saves_and_serves(tmp_path):
    """The token track has no engine: its saved model is loaded back through
    ``load_model_state`` and runs the test split's batches."""
    args = [*DAILY_SMALL, "--module=dgcnv2_daily", "--epoch=1", "--batch_count=2", "--train.batch_size=4",
            "--test.batch_size=8", "--confusion_matrix=false", f"--save_dir={tmp_path}"]
    out = _run_entry_point(args)
    path = tmp_path / "model.last.ckpt"
    assert path.exists() and f"saved {path}" in out
    trainer = _port_trainer(True, "--test.batch_size=8")
    trainer.model.load_state_dict(load_model_state(str(path), "dgcnv2_daily"))
    res = trainer.test()
    assert np.isfinite(res["Lall"]) and 0.0 <= res["acc"] <= 1.0
    assert tdaily.ParamsType is tdgcnv2.DGCNV2DailyParams and tdaily.main is tdgcnv2.daily_main


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, small in ((tdgcnv2.main, FEATURE_SMALL), (tdaily.main, DAILY_SMALL)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([a for a in small if a != "--device=cpu"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine.from_module("dgcnv2", dataset="synthetic-cogmen-6", hidden_size=8, d_g=8, d_p=8)
