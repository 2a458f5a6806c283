"""Declared LR schedules, ``split_wd`` and ``lars`` ≡ the JAX package's, on the CPU.

- Every curve of ``core.interp`` equals the JAX package's on the host, and
  ``to_schedule`` equals ``to_optax_schedule`` at steps 0 … 3·horizon within
  1e-6 relative (the table curves' modulo and clip quirks included).
- A DAG-ERC trainer (2 layers of 16, L 16) under ``--optim.sche.name=Cos``
  over two epochs of 3 batches each, at K = 1 and K = 2 (a group and a
  leftover each epoch), runs update n at the LR that optax's
  ``inject_hyperparams`` injects at update n (within 1e-6 relative), with
  its plateau controller off (one log line; the LR stays the curve's
  through the test stages); the schedule's count is saved, and a run
  resumed after its first epoch takes the uninterrupted run's LRs.
- ``--optim.split_wd=1`` and ``=full``: for every family the parameters the
  port decays are those that the JAX package's mask (``wd_mask_bn``,
  ``wd_mask``) decays, seen through ``convert.py`` (a flax tree whose leaves
  hold the mask's 1 or 0, converted: no torch parameter may mix them); and 3
  steps of Adam and AdamW with the split equal optax's within 1e-5.
- ``--optim.name=lars``: 3 steps equal ``optax.lars(lr, weight_decay=wd)``
  within 1e-5, a zero parameter (trust ratio 1) included, and the schedule
  drives its LR too.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu.core import interp as jinterp
from erc_tpu.train import optim as joptim
from erc_tpu_torch.core import interp as tinterp
from erc_tpu_torch.core.params import Params
from erc_tpu_torch.models import dagerc as tdagerc
from erc_tpu_torch.train import optim as toptim

from test_torch_precision import FAMILIES, _state, host_batch, jax_trainer, port_trainer
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

CURVES = [("Constant", dict(value=0.3)), ("Linear", dict(start=1.0, end=0.1, left=2, right=9)),
          ("Cos", dict(start=1e-3, end=1e-5, left=1, right=12)), ("Exp", dict(start=0.0, end=2.0, right=7)),
          ("Log", dict(start=1.0, end=3.0, left=2, right=10)), ("PowerDecay", dict(start=0.5, decay=0.9, period=3)),
          ("PeriodCos", dict(start=1.0, end=0.0, period=5)), ("HalfPeriodCos", dict(start=2.0, end=1.0, period=6)),
          ("PeriodTriangle", dict(start=0.0, end=1.0, period=4)), ("PeriodLinear", dict(start=1.0, end=3.0, period=7))]


def _curves(name, kw):
    if name == "InterpList":
        return (jinterp.InterpList([(jinterp.Linear(0, 1, 0, 4), 4), (jinterp.Constant(1.0), 10)]),
                tinterp.InterpList([(tinterp.Linear(0, 1, 0, 4), 4), (tinterp.Constant(1.0), 10)]))
    return getattr(jinterp, name)(**kw), getattr(tinterp, name)(**kw)


@pytest.mark.parametrize("name, kw", [*CURVES, ("InterpList", {})], ids=[c for c, _ in CURVES] + ["InterpList"])
def test_curves_and_schedules_match_jax(name, kw):
    jc, tc = _curves(name, kw)
    horizon = int(getattr(jc, "right", 0) or getattr(jc, "period", 0) or 1000) + 1
    steps = np.arange(3 * horizon + 1)
    assert [tc(s) for s in steps] == [jc(s) for s in steps]
    jfn, tfn = jinterp.to_optax_schedule(jc), tinterp.to_schedule(tc)
    want = np.array([float(jfn(jnp.asarray(s, jnp.int32))) for s in steps])
    got = np.array([float(tfn(torch.tensor(int(s)))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ------------------------------------------------------------- the trainer's LR
SCHE = ["--optim.sche.name=Cos", "--optim.sche.start=0.001", "--optim.sche.end=0.00001", "--optim.sche.left=0",
        "--optim.sche.right=5"]
SCHE_NODE = [a.replace("--optim.", "--") for a in SCHE]  # the same, on the optim node itself
DAG_ARGS = ["--dataset=synthetic-iemocap-6", "--gnn_layers=2", "--hidden_dim=16", "--max_seq_len=16", "--dag_chunk=4",
            "--device=cpu", "--train.batch_size=4", "--test.batch_size=16", "--batch_count=3", "--epoch=2",
            "--confusion_matrix=false"]


def _dag_trainer(*extra):
    p = tdagerc.DAGERCParams()
    p.finalize([*DAG_ARGS, *SCHE, *extra])
    trainer = tdagerc.DAGERCTrainer(p)
    trainer.lines = []
    trainer.log = trainer.lines.append
    trainer.initialize()
    trainer.lrs = []
    trainer.optimizer.register_step_post_hook(lambda opt, a, kw: trainer.lrs.append(float(opt.param_groups[0]["lr"])))
    return trainer


def _injected_lrs(n):
    """The LR that optax's inject_hyperparams applies at each of n updates."""
    cfg = joptim.create_optim("AdamW", lr=5e-4, weight_decay=0.0)
    cfg.from_args(SCHE_NODE)
    tx = joptim.build_optim(cfg, grad_clip_norm=5.0)
    params = {"w": jnp.ones(3)}
    state, out = tx.init(params), []
    for _ in range(n):
        _, state = tx.update({"w": jnp.ones(3)}, state, params)
        out.append(joptim.get_learning_rate(state))
    return out


@pytest.mark.parametrize("spc", [1, 2])
def test_declared_schedule_sets_each_steps_lr(spc, tmp_path):
    trainer = _dag_trainer(f"--steps_per_call={spc}", f"--save_dir={tmp_path}", "--checkpoint_per_epoch=1")
    assert toptim.has_schedule(trainer.optimizer)
    history = trainer.train()
    assert [r["steps"] for r in history] == [3, 3] and trainer.global_steps == 6
    want = _injected_lrs(6)
    np.testing.assert_allclose(trainer.lrs, want, rtol=1e-6, atol=0)
    assert int(trainer.optimizer.state["schedule"]["count"]) == 6
    # the test stages stepped the plateau controller: off, said once, and the LR is the curve's
    assert trainer.lines.count("lr schedule declared (--optim.sche): plateau controller disabled") == 1
    for _ in range(trainer.lr_sche.patience + 3):
        trainer._plateau_step(1.0)
    assert float(trainer.optimizer.param_groups[0]["lr"]) == trainer.lrs[-1]
    # resumed after epoch 0: the count comes back with the optimizer, and the LRs go on
    resumed = _dag_trainer(f"--steps_per_call={spc}", f"--save_dir={tmp_path}", "--resume=true")
    first = sorted(tmp_path.glob("checkpoint.*.ckpt"))[0]
    tree = resumed.saver.load(str(first))
    assert int(tree["optimizer"]["state"]["schedule"]["count"]) == 3
    for p in sorted(tmp_path.glob("checkpoint.*.ckpt"))[1:]:
        p.unlink()
    resumed.train()
    np.testing.assert_allclose(resumed.lrs, want[3:], rtol=1e-6, atol=0)


# ----------------------------------------------------------------- split_wd
MASK_FAMILIES = ["cogmen", "dagerc", "dgcn", "mmgcn-dense", "dgcnv2-LSTM", "dgcnv2-DialogRNN", "dgcnv2_daily", "cim",
                 "mmin_base", "mmin_miss", "mmin_miss2"]


@pytest.mark.parametrize("fam", MASK_FAMILIES)
def test_split_wd_decays_what_the_jax_masks_decay(fam):
    fam = FAMILIES[fam]
    trainer = port_trainer(fam)
    _, params, model_state = jax_trainer(fam, host_batch(trainer))
    named = list(trainer.model.named_parameters())
    for jmask, tmask in ((joptim.wd_mask_bn, toptim.wd_mask_bn), (joptim.wd_mask, toptim.wd_mask)):
        mask = jmask(params)
        filled = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, float(m), np.float32), mask, params)
        seen = _state(fam, filled, model_state)
        for n, t in named:
            values = np.unique(seen[n].numpy())
            assert len(values) == 1, f"{fam.name} {n}: fed by leaves of both masks ({values})"
            assert bool(values[0]) == tmask(n, t), (fam.name, jmask.__name__, n)


class _Tree(torch.nn.Module):
    """The parameters of a flax-like tree, named as the JAX test of the masks names them."""

    def __init__(self, leaves):
        super().__init__()
        for mod, items in leaves.items():
            sub = torch.nn.Module()
            for name, v in items.items():
                sub.register_parameter(name, torch.nn.Parameter(torch.from_numpy(v.copy())))
            self.add_module(mod, sub)


def _leaves(seed):
    r = np.random.default_rng(seed)
    shapes = {"dense": {"kernel": (4, 4), "bias": (4,)}, "bn": {"scale": (4,), "bias": (4,)},
              "layer_0": {"gru_c_b_ih": (8,), "Wr0": (4, 4), "zero": (3, 2)}}
    return {m: {n: (np.zeros(s, np.float32) if n == "zero" else r.normal(size=s).astype(np.float32))
                for n, s in items.items()} for m, items in shapes.items()}


def _three_steps(name, wd, split=None):
    """(the port's parameters, optax's) after 3 steps from the same tree and gradients."""
    leaves = _leaves(0)
    kw = {"split_wd": split} if split else {}
    cfg = joptim.create_optim(name, lr=0.05, weight_decay=wd, **kw)
    tx = joptim.build_optim(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, leaves)
    state = tx.init(jparams)
    model = _Tree(leaves)
    opt = toptim.build_optim(Params(**cfg.to_dict()), model.named_parameters())
    r = np.random.default_rng(1)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda v: r.normal(size=v.shape).astype(np.float32), leaves)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for m, items in grads.items():
            for n, g in items.items():
                getattr(getattr(model, m), n).grad = torch.from_numpy(g)
        opt.step()
    return model, jparams


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
@pytest.mark.parametrize("split", ["1", "full"])
def test_split_wd_steps_match_optax(name, split):
    model, jparams = _three_steps(name, 0.5, split)
    for m, items in jparams.items():
        for n, v in items.items():
            np.testing.assert_allclose(getattr(getattr(model, m), n).detach().numpy(), np.asarray(v), rtol=0,
                                       atol=1e-5, err_msg=f"{m}.{n}")
    rule = toptim.wd_mask if split == "full" else toptim.wd_mask_bn
    decayed = {n for n, p in model.named_parameters() if rule(n, p)}
    assert decayed == ({"dense.kernel", "layer_0.Wr0", "layer_0.zero"} if split == "full" else
                       {"dense.kernel", "dense.bias", "layer_0.gru_c_b_ih", "layer_0.Wr0", "layer_0.zero"})


@pytest.mark.parametrize("wd", [0.0, 0.3])
def test_lars_steps_match_optax(wd):
    model, jparams = _three_steps("lars", wd)
    assert isinstance(model, _Tree)
    for m, items in jparams.items():
        for n, v in items.items():
            np.testing.assert_allclose(getattr(getattr(model, m), n).detach().numpy(), np.asarray(v), rtol=0,
                                       atol=1e-5, err_msg=f"{m}.{n}")


def test_lars_under_a_schedule():
    cfg = Params(name="lars", lr=0.1, weight_decay=0.0)
    cfg.from_args(SCHE_NODE)
    p = torch.nn.Parameter(torch.ones(3))
    opt = toptim.build_optim(cfg, [p])
    lrs = []
    for _ in range(3):
        p.grad = torch.ones(3)
        opt.step()
        lrs.append(float(opt.param_groups[0]["lr"]))
    np.testing.assert_allclose(lrs, _injected_lrs(3), rtol=1e-6)
