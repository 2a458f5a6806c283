"""The port's MMIN trainers ≡ a JAX reference step; warm starts from a JAX file.

``mmin_base`` and ``mmin_miss2`` here, ``mmin_miss`` in
``test_torch_mmin_miss.py``.  At small size (5-row batches with one padding
row: audio of 5–15 frames cut to 12 × 16, visual 10 × 20, text 8 × 32; the
hidden widths are the published ones), the same numpy batches, Missing
patterns drawn from ``numpy_rng("missing")`` by the JAX batcher, and the
same weights (drawn from a seed in the flax tree's shapes) go through:

- JAX: the family's loss with ``deterministic=True`` (``Lce``; ``Lce + 4·Lmse
  + Lrce`` for ``mmin_miss2``), stepped with ``erc_tpu.train.optim.build_optim``
  of ``MMINBaseParams``' Adam 2e-4 and the EMA formula of the JAX trainer
  (``α·e + (1 − α)·p``: α 0.999 for ``mmin_base``; 0.5 for the others, so
  that 3 steps move the shadow by far more than the tolerance), float32,
  matmul precision highest;
- the port's trainer at dropout 0, through ``train_step``.

Held: the module's outputs on the first batch within 1e-5 absolute; its
gradients within 1e-5 of max(1, max |g|) per parameter; each step's losses
within 1e-5 relative; after 3 steps each parameter within 1e-5 of its norm
(or of 3 steps' largest move, 3 lr an element) and so the EMA shadow, at
the published α also within 1e-5 absolute.  Then a JAX ``MMINBaseTrainer.save_model`` file is read by
the port's ``--pretrain_path`` into ``mmin_miss``'s frozen encoder and
``mmin_miss2``'s ``netB`` exactly, with the EMA shadow re-synced.
"""

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from erc_tpu.data import mmin as jmmin
from erc_tpu.models import mmin_base as jbase
from erc_tpu.models import mmin_miss as jmiss
from erc_tpu.models import mmin_models as jm
from erc_tpu.train import optim as joptim
from erc_tpu.train import trainer as jtrainer
from erc_tpu.train.trainer import TrainState
from erc_tpu_torch import convert
from erc_tpu_torch.core.seed import RngPool
from erc_tpu_torch.models import mmin_base, mmin_miss, mmin_miss2
from erc_tpu_torch.ops.dropout import Dropout
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
WIDTHS = {"audio_feature": 16, "visual_feature": 20, "text_feature": 32}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def draw_params(model, inputs, seed):
    """A flax tree of `model`'s shapes (``eval_shape``: nothing compiles) drawn
    from a seed: weights N(0, 1/fan_in), biases N(0, 0.01), so none is zero."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), inputs)["params"]
    r = np.random.default_rng(seed)

    def draw(s):
        std = 0.1 if len(s.shape) == 1 else 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return (std * r.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _samples(n, seed):
    r = np.random.default_rng(seed)
    return [{"visual_feature": r.normal(size=(10, 20)).astype(np.float32),
             "text_feature": r.normal(size=(8, 32)).astype(np.float32),
             "audio_feature": r.normal(size=(int(r.integers(5, 16)), 16)).astype(np.float32),
             "label": int(r.integers(0, 4)), "name": f"u{seed}_{i}"} for i in range(n)]


def batches(has_miss, seed=1):
    """3 batches of 4 utterances padded to 5 rows, the Missing patterns from
    the trainer's generator."""
    b = jmmin.MMINBatcher(max_audio_len=12, has_miss=has_miss, pad_batch_to=5, rng=RngPool(seed).numpy_rng("missing"))
    return [b(_samples(4, s)) for s in range(3)]


def port_trainer(module, *extra):
    """The family's port trainer on synthetic-mmin-4 with the features narrowed
    to WIDTHS, on the CPU, dropout off."""
    p = module.ParamsType()
    p.finalize(["--dataset=synthetic-mmin-4", "--device=cpu", *extra])
    p.hidden_audio, p.hidden_visual, p.hidden_text = (WIDTHS[k] for k in ("audio_feature", "visual_feature",
                                                                          "text_feature"))
    trainer = {mmin_base: mmin_base.MMINBaseTrainer, mmin_miss: mmin_miss.MMINMissTrainer,
               mmin_miss2: mmin_miss2.MMINMiss2Trainer}[module](p)
    trainer.log = lambda msg: None
    trainer.initialize()
    for m in trainer.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return trainer


def t_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_loss(kind, model, pretrained=None):
    """The JAX trainer's loss of `kind` with deterministic=True: (Lall, (metrics, outputs))."""
    ce = jtrainer.masked_cross_entropy

    def loss(params, batch):
        mask, labels = batch["sample_mask"], batch["label"]
        if kind == "mmin_base":
            outs = model.apply({"params": params}, batch, deterministic=True)
            lce = ce(outs[0], labels, mask)
            return lce, ({"Lall": lce}, outs)
        rev = {k: batch[f"{k}_reverse"] for k in WIDTHS}
        if kind == "mmin_miss":
            outs = model.apply({"params": params}, batch, deterministic=True)
            logits, fusion, fusion_cycle, features = outs
            pre_model, pre_params = pretrained
            target = jax.lax.stop_gradient(pre_model.apply({"params": pre_params}, rev, deterministic=True,
                                                           method=pre_model.encode))
            lce, lmse = ce(logits, labels, mask), jmiss.masked_mse(target, fusion, mask)
            lcycle = jmiss.masked_mse(features, fusion_cycle, mask)
            lall = lce + lmse * 4 + lcycle * 2
            return lall, ({"Lall": lall, "Lce": lce, "Lmse": lmse, "Lcycle": lcycle}, outs)
        outs = model.apply({"params": params}, batch, deterministic=True, with_reverse=True)
        logits, fusion, rlogits, rfeat = outs
        lce, lrce, lmse = ce(logits, labels, mask), ce(rlogits, labels, mask), jmiss.masked_mse(rfeat, fusion, mask)
        lall = lce + lmse * 4 + lrce
        return lall, ({"Lall": lall, "Lce": lce, "Lrce": lrce, "Lmse": lmse}, outs)

    return loss


def jax_reference(kind, host, pretrained=None, alpha=0.999):
    """(initial params, per-step (metrics, outputs, grads), final params, final EMA) of 3 JAX steps."""
    model = {"mmin_base": jm.MMINBaseModule, "mmin_miss": jm.MMINMissModule,
             "mmin_miss2": jm.MMINMiss2Module}[kind](n_classes=4)
    params = draw_params(model, host[0], 0)
    tx = joptim.build_optim(jbase.MMINBaseParams().optim)
    loss = jax_loss(kind, model, pretrained)

    @jax.jit
    def step(params, opt_state, ema, batch):
        (_, (mets, outs)), grads = jax.value_and_grad(loss, has_aux=True)(params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree_util.tree_map(lambda e, p: alpha * e + (1 - alpha) * p, ema, params)
        return params, opt_state, ema, mets, outs, grads

    p, opt_state, ema, steps = params, tx.init(params), jax.tree_util.tree_map(jnp.copy, params), []
    with jax.default_matmul_precision("highest"):
        for batch in host:
            p, opt_state, ema, mets, outs, grads = step(p, opt_state, ema, batch)
            steps.append((_np_tree(mets), _np_tree(outs), _np_tree(grads)))
    return params, steps, _np_tree(p), _np_tree(ema)


def assert_trajectory(trainer, to_state, host, ref, forward):
    """Outputs and gradients of the first batch, then 3 steps' losses, the
    weights and the EMA shadow (see the module docstring)."""
    params, steps, final, ema = ref
    trainer.model.load_state_dict(to_state(params))
    trainer.sync_ema()
    with torch.no_grad():
        outs = forward(trainer.model, t_batch(host[0]))
    for got, want in zip(outs, steps[0][1], strict=True):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    trainer.compute_grads(t_batch(host[0]))
    want_grads = to_state(steps[0][2])
    for name, t in trainer.model.named_parameters():
        w = want_grads[name].numpy()
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=TOL * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)
    for i, batch in enumerate(host):
        mets = trainer.train_step(t_batch(batch))
        for key, want in steps[i][0].items():
            np.testing.assert_allclose(mets[key].item(), float(want), rtol=TOL, err_msg=f"{key} step {i}")
    lr, alpha = float(trainer.params.optim.lr), float(trainer.params.ema_alpha)
    want_p, want_e, start = to_state(final), to_state(ema), to_state(params)
    moved = 0.0
    for (name, t), (_, e) in zip(trainer.model.named_parameters(), trainer.ema_model.named_parameters(), strict=True):
        for got, want in ((t, want_p[name]), (e, want_e[name])):
            # ‖Δw‖ ≤ 1e-5 of ‖w‖, or of the most that 3 steps move it (3 lr an element)
            w = want.double().numpy()
            d = np.linalg.norm(got.detach().double().numpy() - w)
            tol = TOL * max(np.linalg.norm(w), 3 * lr * np.sqrt(w.size))
            assert d <= tol, (name, d, tol)
        if alpha == 0.999:  # the published α: the shadow elementwise too
            np.testing.assert_allclose(e.numpy(), want_e[name].numpy(), rtol=0, atol=TOL, err_msg=f"EMA {name}")
        else:  # the shadow moved by far more than the tolerance: a missing update would show
            moved = max(moved, np.linalg.norm((want_e[name] - start[name]).numpy()) / tol)
    assert alpha == 0.999 or moved > 10, moved


def test_mmin_base_three_steps_match_jax():
    host = batches(has_miss=False)
    trainer = port_trainer(mmin_base)
    assert trainer.plateau_source == "val" and trainer.grad_clip_norm is None
    assert isinstance(trainer.lr_sche, torch.optim.lr_scheduler.ReduceLROnPlateau) and trainer.lr_sche.mode == "min"
    assert trainer.optimizer.defaults["lr"] == 2e-4 and trainer.optimizer.defaults["weight_decay"] == 0.0
    ref = jax_reference("mmin_base", host)
    assert_trajectory(trainer, convert.mmin_base_state, host, ref, lambda m, b: m(b))


def test_mmin_miss2_three_steps_match_jax():
    """Twin nets under one optimizer, gradients into both (no detach), the
    EMA over both."""
    host = batches(has_miss=True)
    assert all("text_feature_reverse" in b and "missing_type" in b for b in host)
    trainer = port_trainer(mmin_miss2, "--ema_alpha=0.5")
    ref = jax_reference("mmin_miss2", host, alpha=0.5)
    assert_trajectory(trainer, convert.mmin_miss2_state, host, ref, lambda m, b: m(b, with_reverse=True))
    assert float(trainer.model.netB.netC.fc0.weight.grad.abs().max()) > 0
    # eval classifies with net alone
    batch = t_batch(host[0])
    raw, ema = trainer.to_logits(batch)
    with torch.no_grad():
        assert torch.equal(raw, trainer.model.net(batch)[0]) and torch.equal(ema, trainer.ema_model.net(batch)[0])


def test_warm_start_from_a_jax_saver_file(tmp_path, monkeypatch):
    """A JAX ``MMINBaseTrainer.save_model`` file (a full TrainState with its
    EMA shadow) → the port's ``--pretrain_path``: ``mmin_miss``'s frozen
    encoder and ``mmin_miss2``'s ``netB`` equal the saved ``params`` exactly;
    ``mmin_miss2``'s EMA shadow starts from the loaded weights and ``net``
    keeps its own."""
    monkeypatch.setenv("ERC_TPU_EXPROOT", str(tmp_path / "exp"))
    prec = jax.config.jax_default_matmul_precision
    jp = jbase.MMINBaseParams()
    jp.dataset = "synthetic-mmin-4"
    jp.iparams()
    try:
        jt = jbase.MMINBaseTrainer(jp)
    finally:  # the JAX trainer sets the process-wide matmul precision
        jax.config.update("jax_default_matmul_precision", prec)
    model = jm.MMINBaseModule(n_classes=4)
    params = draw_params(model, batches(False)[0], 3)
    ema = jax.tree_util.tree_map(lambda a: a * 0.5, params)
    tx = joptim.build_optim(jp.optim)
    jt.state = TrainState(params=params, opt_state=tx.init(params), model_state={}, step=jnp.asarray(3),
                          ema_params=ema)
    path = jt.save_model("best_val")
    want = convert.mmin_base_state(params)

    miss = port_trainer(mmin_miss, f"--pretrain_path={path}")
    got = miss.pretrained_model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert not any(t.requires_grad for t in miss.pretrained_model.parameters())
    assert not miss.pretrained_model.training

    miss2 = port_trainer(mmin_miss2, f"--pretrain_path={path}")
    for module in (miss2.model.netB, miss2.ema_model.netB):
        got = module.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    net = miss2.model.net.state_dict()
    assert not torch.equal(net["netC.fc0.weight"], want["netC.fc0.weight"])
    assert all(torch.equal(a, b) for a, b in zip(miss2.model.parameters(), miss2.ema_model.parameters()))
