"""The port's CIM (models.cim) ≡ the JAX package's.

On the CPU at small size: B = 3 with one all-padding dialogue, ragged
L ≤ 9, features 8 (text), 6 (audio) and 5 (visual) wide, biGRUs of 6 a
direction; the 3-step trajectory on synthetic-mosei-2 batches of L ≤ 12
(features narrowed the same way) with biGRUs of 8.  The same numpy inputs and converted weights
(the flax tree perturbed by seeded noise, so every bias is nonzero) go
through JAX (float32, matmul precision highest, dropout off) and the port.
Logits of both heads within 1e-5 absolute at every position, padding
included; gradients of Lce + Lmulti within 1e-5 of each gradient's norm
(floored at 1e-8 of the global norm); losses within 1e-5 relative, and
each parameter after 3 Adam steps within 1e-5 of its norm (or of 3 steps'
largest move, 3 lr an element, for a bias that starts at 0).

Covered: ``CIMModule`` against JAX with ``fused_rnn`` on and off there
(gradients with it on);
``sigmoid_bce``, ``masked_bce_with_logits`` and ``resolve_fused_rnn``;
``CIMParams``; the full-width parameter counts; ``cim_state`` from the
nested tree, the flat ``.npz`` and the convert CLI, and a JAX Saver file
served by ``InferenceEngine``; a 3-step ``CIMTrainer`` trajectory; the
seeded dropout; ``main`` with ``--select_on=val``; and each entry point
without CUDA raises.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from erc_tpu.data.collate import ERCBatcher as JERCBatcher
from erc_tpu.data.synthetic import synthetic_mosei as j_synthetic_mosei
from erc_tpu.models import cim as jcim
from erc_tpu.train import checkpoint as jcheckpoint
from erc_tpu.train import optim as joptim
from erc_tpu.train import trainer as jtrainer
from erc_tpu.train.trainer import TrainState
from erc_tpu_torch import convert
from erc_tpu_torch.models import cim as tcim
from erc_tpu_torch.models import cogmen_mosei as tcogmen_mosei
from erc_tpu_torch.serve import InferenceEngine
from erc_tpu_torch.train.checkpoint import load_model_state
from erc_tpu_torch.train.trainer import masked_cross_entropy
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = RTOL = 1e-5
DIMS = dict(text_dim=8, audio_dim=6, visual_dim=5)
H = 6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if v is not None}


def _batch(seed=0):
    """3 rows: two MOSEI-shaped dialogues of 9 and 5 utterances, and padding."""
    samples = j_synthetic_mosei(2, "train", seed=seed, n_train=2, min_len=5, max_len=9, **DIMS)
    return JERCBatcher("atv", 2, 1, max_len=9, pad_batch_to=3)(samples)


def _jax_loss(model, batch):
    def loss(params):
        logits2, logits7 = model.apply({"params": params}, batch, deterministic=True)
        mask = batch["attention_mask"]
        lce = jtrainer.masked_cross_entropy(logits2, batch["label"], mask)
        lmulti = jcim.masked_bce_with_logits(logits7, batch["emo_label"].astype(jnp.float32), mask)
        return lce + lmulti, (logits2, logits7)

    return loss


@pytest.fixture(scope="module")
def jax_run():
    """(batch, perturbed flax tree, logits2, logits7, gradients of Lce + Lmulti)
    of the JAX module with ``fused_rnn`` on."""
    batch = _batch()
    model = jcim.CIMModule(hidden_size=H, n_classes=2, fused_rnn=True, **DIMS)
    params = _np_tree(jax.jit(lambda k: model.init(k, batch))(jax.random.PRNGKey(0)))["params"]
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map(lambda a: (a + 0.3 * noise.normal(size=a.shape)).astype(np.float32), params)
    with jax.default_matmul_precision("highest"):
        (_, (l2, l7)), grads = jax.jit(jax.value_and_grad(_jax_loss(model, batch), has_aux=True))(params)
    return batch, params, np.asarray(l2), np.asarray(l7), _np_tree(grads)


def _assert_grads_close(named, want):
    """‖got − want‖ ≤ max(RTOL · ‖want‖, 1e-8 · global norm) per parameter."""
    global_norm = float(np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values())))
    assert {n for n, _ in named} == set(want)
    for name, g in named:
        got, ref = g.double().numpy(), want[name].double().numpy()
        assert np.isfinite(got).all(), name
        d = np.linalg.norm(got - ref)
        assert d <= max(RTOL * np.linalg.norm(ref), 1e-8 * global_norm), (name, d, np.linalg.norm(ref))


def test_cim_module_matches_jax(jax_run):
    """Both heads at every position (the padded positions of the ragged row
    and the all-padding row carry nonzero logits), and the gradients."""
    batch, params, l2, l7, grads = jax_run
    module = tcim.CIMModule(hidden_size=H, n_classes=2, drop0=0.0, drop1=0.0, **DIMS)
    module.load_state_dict(convert.cim_state(params))
    tb = _t(batch)
    got2, got7 = (t.detach().numpy() for t in module.eval()(tb))
    assert got2.shape == (3, 9, 2) and got7.shape == (3, 9, 7)
    assert np.abs(l2[1, 5:]).max() > 0.1 and np.abs(l2[2]).max() > 0.1  # padding is not zero
    np.testing.assert_allclose(got2, l2, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got7, l7, rtol=0, atol=ATOL)
    module.train()
    with torch.enable_grad():
        logits2, logits7 = module(tb)
        mask = tb["attention_mask"]
        loss = masked_cross_entropy(logits2, tb["label"], mask) + tcim.masked_bce_with_logits(
            logits7, tb["emo_label"].float(), mask)
        loss.backward()
    _assert_grads_close([(n, p.grad) for n, p in module.named_parameters()], convert.cim_state(grads))


def test_cim_module_matches_jax_without_the_fused_scan(jax_run):
    """The JAX module's three separate scans (fused_rnn off): the same
    parameter tree, and the port's logits again."""
    batch, params, _, _, _ = jax_run
    model = jcim.CIMModule(hidden_size=H, n_classes=2, fused_rnn=False, **DIMS)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch))["params"]
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params)
    with jax.default_matmul_precision("highest"):
        l2, l7 = jax.jit(lambda p: model.apply({"params": p}, batch))(params)
    module = tcim.CIMModule(hidden_size=H, n_classes=2, fused_rnn=False, **DIMS).eval()
    module.load_state_dict(convert.cim_state(params))
    with torch.no_grad():
        got2, got7 = module(_t(batch))
    np.testing.assert_allclose(got2.numpy(), np.asarray(l2), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got7.numpy(), np.asarray(l7), rtol=0, atol=ATOL)


def test_cim_logits_do_not_read_speakers(jax_run):
    batch, params, l2, _, _ = jax_run
    module = tcim.CIMModule(hidden_size=H, n_classes=2, **DIMS).eval()
    module.load_state_dict(convert.cim_state(params))
    other = dict(batch, speaker_ids=np.random.default_rng(3).integers(0, 5, batch["speaker_ids"].shape).astype(
        np.int32))
    other["speaker_tensor"] = other["speaker_ids"]
    with torch.no_grad():
        a, b = module(_t(batch))[0], module(_t(other))[0]
    assert torch.equal(a, b)


def test_bce_matches_jax():
    r = np.random.default_rng(0)
    logits = (r.normal(size=(3, 5, 7)) * 30).astype(np.float32)  # saturated sigmoids both ways
    targets = r.integers(0, 2, (3, 5, 7)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5, [0] * 5], np.float32)
    got = tcim.sigmoid_bce(torch.from_numpy(logits), torch.from_numpy(targets)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcim.sigmoid_bce(logits, targets)), rtol=1e-6, atol=1e-6)
    for m in (mask, np.zeros_like(mask)):  # an all-padding batch divides by 1
        got = tcim.masked_bce_with_logits(*(torch.from_numpy(a) for a in (logits, targets, m))).item()
        np.testing.assert_allclose(got, float(jcim.masked_bce_with_logits(logits, targets, m)), rtol=1e-6)


@pytest.mark.parametrize("args", [[], ["--train.batch_size=64"], ["--test.batch_size=33"], ["--fused_rnn=off"],
                                  ["--fused_rnn=on", "--train.batch_size=128"], ["--val.batch_size=40"]])
def test_params_and_fused_rnn_match_jax(args):
    for dataset in ("synthetic-mosei-2", "synthetic-mosei-6", "iemocap-cogmen-6", "mosei-cim-2"):
        j, t = jcim.CIMParams(), tcim.CIMParams()
        for p in (j, t):
            p.from_args([f"--dataset={dataset}", *args])
            p.iparams()
        assert tcim.resolve_fused_rnn(t) == jcim.resolve_fused_rnn(j), (dataset, args)
        for key in ("apply_multi", "apply_bin", "mosei_metric", "metric", "hidden_size", "hidden_text",
                    "hidden_audio", "hidden_visual", "class_names", "train.batch_size", "test.batch_size",
                    "epoch", "select_on", "eval_val"):
            assert t[key] == j[key], (dataset, key)
        assert (t.optim.name, t.optim.lr, t.optim.weight_decay) == (j.optim.name, j.optim.lr, j.optim.weight_decay)
    assert tcim.resolve_fused_rnn({"fused_rnn": True}) is True


@pytest.mark.parametrize("dataset, want", [("synthetic-cogmen-6", 1_713_613), ("synthetic-mosei-2", 1_346_409)])
def test_parameter_count_at_full_width(dataset, want):
    """The JAX tree's count (from shapes only) and the converted state
    dict's shapes at CIMParams' widths."""
    p = tcim.CIMParams()
    p.finalize([f"--dataset={dataset}", "--device=cpu"])
    model = tcim.build(p, generator=torch.Generator().manual_seed(0))
    jm = jcim.CIMModule(text_dim=p.hidden_text, audio_dim=p.hidden_audio, visual_dim=p.hidden_visual,
                        hidden_size=200, n_classes=p.n_classes)
    batch = {k: np.zeros((1, 4, d), np.float32) for k, d in (("text_feature", p.hidden_text),
                                                              ("audio_feature", p.hidden_audio),
                                                              ("visual_feature", p.hidden_visual))}
    batch["attention_mask"] = np.ones((1, 4), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))["params"]
    assert sum(t.numel() for t in model.parameters()) == want
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)) == want
    sd = convert.cim_state(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in model.state_dict().items()}


# ------------------------------------------------------------------ weights from JAX
def test_cim_state_from_the_flat_npz_and_a_jax_saver_file(jax_run, tmp_path):
    batch, params, l2, _, _ = jax_run
    want = convert.cim_state(params)
    flat = traverse_util.flatten_dict({"params": params}, sep="/")
    np.savez(tmp_path / "v.npz", **flat)
    sd = convert.STATES["cim"](convert.read_npz(str(tmp_path / "v.npz")))
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)
    convert.main(["--module=cim", str(tmp_path / "v.npz"), str(tmp_path / "sd.pt")])
    sd = torch.load(tmp_path / "sd.pt", weights_only=True)
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)
    tx = joptim.build_optim(joptim.create_optim("Adam", lr=1e-3))
    state = TrainState(params=params, opt_state=tx.init(params), model_state={}, step=jnp.asarray(3))
    path = jcheckpoint.Saver(str(tmp_path)).save_model("last", state, meta={"eidx": 1})
    sd = load_model_state(path, "cim")
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)
    # served through from_module: predict gives argmax(logits2) of the JAX module
    engine = InferenceEngine.from_module("cim", path, dataset="custom-2", batch_size=3, max_seq_len=9,
                                         length_bucket=0, hidden_size=H, hidden_text=8, hidden_audio=6,
                                         hidden_visual=5, device="cpu")
    np.testing.assert_allclose(engine.logits(batch), l2, rtol=0, atol=ATOL)
    samples = j_synthetic_mosei(2, "train", n_train=2, min_len=5, max_len=9, **DIMS)
    results = engine.predict(samples)
    for i, r in enumerate(results):
        n = int(batch["text_length"][i])
        assert r["pred"] == l2[i, :n].argmax(-1).tolist()
        assert np.allclose(np.sum(r["probs"], -1), 1.0, atol=1e-6)


# ------------------------------------------------------------------ training
SMALL = ["--dataset=synthetic-mosei-2", "--hidden_size=8", "--max_seq_len=12", "--device=cpu"]


def _port_trainer(*extra, dropout_off=True):
    """A CIMTrainer of synthetic-mosei-2 with features narrowed to DIMS."""
    p = tcim.CIMParams()
    p.finalize(SMALL + list(extra))
    p.hidden_text, p.hidden_audio, p.hidden_visual = DIMS["text_dim"], DIMS["audio_dim"], DIMS["visual_dim"]
    trainer = tcim.CIMTrainer(p)
    trainer.log = lambda msg: None
    trainer.initialize()
    if dropout_off:
        trainer.model.drop0.p = trainer.model.drop1.p = 0.0
    return trainer


def test_three_step_trajectory_matches_jax():
    """Adam 1e-3 on synthetic-mosei-2 batches (features narrowed) with the
    multitask loss: Lall, Lce, Lmulti and the gradient norm of each step,
    then the weights."""
    batcher = JERCBatcher("atv", 2, 1, bucket=16, max_len=12, pad_batch_to=3)
    batches = [batcher(j_synthetic_mosei(2, "train", seed=s, n_train=2, min_len=5, max_len=12, **DIMS))
               for s in range(3)]
    trainer = _port_trainer()
    p = trainer.params
    assert p.apply_multi and p.mosei_metric == "multiemo" and trainer.grad_clip_norm is None
    assert trainer.lr_sche is None
    jm = jcim.CIMModule(hidden_size=8, n_classes=2, drop0=0.0, drop1=0.0, fused_rnn=False, **DIMS)
    params = _np_tree(jax.jit(lambda k: jm.init(k, batches[0]))(jax.random.PRNGKey(0)))["params"]
    trainer.model.load_state_dict(convert.cim_state(params))
    jp = jcim.CIMParams()
    tx = joptim.build_optim(jp.optim)

    def loss_fn(params, batch):
        logits2, logits7 = jm.apply({"params": params}, batch, deterministic=True)
        mask = batch["attention_mask"]
        lce = jtrainer.masked_cross_entropy(logits2, batch["label"], mask)
        lmulti = jcim.masked_bce_with_logits(logits7, batch["emo_label"].astype(jnp.float32), mask)
        return lce + lmulti, (lce, lmulti)

    @jax.jit
    def step(params, opt_state, batch):
        (value, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, value, aux, optax.global_norm(grads)

    opt_state = tx.init(params)
    for i, batch in enumerate(batches):
        jbatch = {k: v for k, v in batch.items() if v is not None}
        with jax.default_matmul_precision("highest"):
            params, opt_state, loss, (lce, lmulti), gnorm = step(params, opt_state, jbatch)
        mets = trainer.train_step(_t(batch))
        for key, want in (("Lall", loss), ("Lce", lce), ("Lmulti", lmulti), ("gnorm", gnorm)):
            np.testing.assert_allclose(mets[key].item(), float(want), rtol=RTOL, err_msg=f"{key} {i}")
    want = convert.cim_state(_np_tree(params))
    lr = float(jp.optim.lr)
    for name, t in trainer.model.named_parameters():
        # ‖Δw‖ ≤ 1e-5 of ‖w‖, or of the most that 3 steps move it (3 lr an element)
        w = want[name].double().numpy()
        d = np.linalg.norm(t.detach().double().numpy() - w)
        assert d <= RTOL * max(np.linalg.norm(w), 3 * lr * np.sqrt(w.size)), (name, d)


def test_losses_follow_apply_bin_and_apply_multi():
    batch = _t(_batch())
    trainer = _port_trainer()
    mets = trainer.compute_grads(batch)
    assert set(mets) == {"Lall", "Lce", "Acc", "Lmulti"}
    np.testing.assert_allclose(mets["Lall"].item(), mets["Lce"].item() + mets["Lmulti"].item(), rtol=1e-6)
    trainer.params.apply_bin = False
    np.testing.assert_allclose(trainer.compute_grads(batch)["Lall"].item(), mets["Lmulti"].item(), rtol=1e-6)
    trainer.params.apply_bin, trainer.params.apply_multi = True, False  # as CIMParams has it away from MOSEI
    assert set(trainer.compute_grads(batch)) == {"Lall", "Lce", "Acc"}
    assert not tcim.CIMParams().finalize(["--dataset=synthetic-cogmen-6"]).apply_multi


def test_dropout_draws_from_the_seeded_generator():
    batch = _t(_batch())
    runs = {}
    for seed in (3, 3, 4):
        t = _port_trainer(f"--seed={seed}", dropout_off=False)
        assert t.model.drop0.p == t.model.drop1.p == 0.3 and t.model.drop0.generator is not None
        t.model.train()
        torch.manual_seed(seed)  # the global RNG plays no part
        runs.setdefault(seed, []).append((t.model(batch)[0].detach(), t.model(batch)[0].detach()))
    (a1, a2), (b1, _) = runs[3]
    np.testing.assert_array_equal(a1.numpy(), b1.numpy())
    assert not torch.equal(a1, a2) and not torch.equal(a1, runs[4][0][0])


def test_main_trains_with_the_val_stage_saves_and_serves(tmp_path, capsys):
    """``main`` with ``--select_on=val`` for two steps: the val stage and the
    multilabel block in the log and the record, ``model.best_val.ckpt`` and
    ``model.last.ckpt`` saved; the saved model serves the test split's
    logits."""
    trainer = tcim.main([*SMALL, "--epoch=1", "--batch_count=2", "--train.batch_size=4", "--select_on=val",
                         "--confusion_matrix=false", f"--save_dir={tmp_path}"])
    out = capsys.readouterr().out
    assert "model CIMModule" in out and "2 steps" in out and "val: Lall=" in out and "mosei multilabel:" in out, out
    for tag in ("best_val", "last"):
        assert (tmp_path / f"model.{tag}.ckpt").exists(), tag
    engine = InferenceEngine.from_module("cim", str(tmp_path / "model.last.ckpt"), dataset="synthetic-mosei-2",
                                         batch_size=8, hidden_size=8, max_seq_len=12, device="cpu")
    batch = next(iter(trainer.make_loader("test")))
    with torch.no_grad():
        want = trainer.model.eval()(_t(batch))[0].numpy()
    np.testing.assert_array_equal(engine.logits(batch), want)
    res = trainer.test()
    summary = res["multilabel"]
    assert len(summary["cls_f1"]) == 7 and all(np.isfinite(summary[k]) for k in ("emo_acc", "emo_f1", "emo_wa"))


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, args in ((tcim.main, SMALL[:-1]), (tcogmen_mosei.main, ["--dataset=synthetic-mosei-6"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine.from_module("cim", dataset="synthetic-mosei-2", hidden_size=8)
