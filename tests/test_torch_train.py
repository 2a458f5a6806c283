"""The port's DAG-ERC training (erc_tpu_torch.train, models.dagerc) ≡ the
JAX package's.

Small widths (hidden 16 or 8, chunk 4, 2 layers; B 3 with an all-padding
dialogue; L 14 or 10, not a multiple of the chunk), on the CPU, where K3 and
K4 run as their plain versions through the autograd Function:

- ``DAGStack(impl='kernel')`` gradients against ``jax.grad`` of JAX's
  ``DAGStack(impl='pallas')`` (interpret mode), with and without remat,
  for the parameters and the input; tolerance 1e-5 × max(1, max |want|)
  (float32, summation order only; weight gradients sum over B·L);
- ``masked_cross_entropy``/``masked_accuracy``, the optimizers with the
  clip (optax's ``build_optim(..., grad_clip_norm=5.0)``), the plateau
  controller, ``classification_summary`` (sklearn's numbers) and
  ``DialogueLoader``'s batches against the JAX package's: 1e-6, or exact
  where no float arithmetic differs;
- a 3-step DAG-ERC trajectory against the JAX pieces that
  ``Trainer._make_raw_train_step`` composes, at matmul precision highest
  and dropout 0: per-step loss within 1e-5 relative, first-step gradients
  within 1e-5 × max(1, max |want|), parameters after 3 steps within 1e-4
  (Adam divides by the root of the second moment, which magnifies the
  gradients' last-digit differences);
- ``python -m erc_tpu_torch.train --device=cpu`` for 2 steps, in a fresh
  interpreter, which also shows that the port's training imports no JAX,
  and leaves ``model.last.ckpt`` under ``--save_dir``;
- ``--config=FILE`` (json, and yaml) gives the JAX ``Params``' values, the
  file loaded before the flags so that a flag wins;
- ``--pretrain=true --pretrain_path=FILE`` loads the model and optimizer
  state of a port file (exactly; the epoch and step count stay 0) and of a
  JAX ``Saver`` file of a TrainState (weights, AdamW's moments and count,
  the injected LR and a declared schedule's count, converted), from which
  one more step equals optax's within 1e-5.
"""

import copy
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu.data import loader as jloader
from erc_tpu.data import registry as jregistry
from erc_tpu.data.collate import ERCBatcher as JERCBatcher
from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu.models import dagerc as jdagerc
from erc_tpu.ops import graphs as jgraphs
from erc_tpu.train import metrics as jmetrics
from erc_tpu.train import optim as joptim
from erc_tpu.train import trainer as jtrainer
from erc_tpu_torch import convert
from erc_tpu_torch.core.params import Params
from erc_tpu_torch.data import loader as tloader
from erc_tpu_torch.data import registry as tregistry
from erc_tpu_torch.data.collate import ERCBatcher
from erc_tpu_torch.models import dagerc as tdagerc
from erc_tpu_torch.ops.kernels import dag_block as tdb
from erc_tpu_torch.train import metrics as tmetrics
from erc_tpu_torch.train import optim as toptim
from erc_tpu_torch.train import trainer as ttrainer
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32 if np.asarray(a).dtype.kind == "f" else None, copy=True))


def _close(got, want, name, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(want).max(initial=0.0))), err_msg=name)


# ------------------------------------------------------------------ DAGStack
def _stack_inputs():
    r = np.random.default_rng(0)
    B, L, D = 3, 10, 8
    lengths = np.asarray([10, 7, 0], np.int32)
    H0 = r.normal(size=(B, L, D)).astype(np.float32)
    spk = r.integers(0, 2, (B, L)).astype(np.int32)
    adj = np.asarray(jgraphs.dag_adjacency(jnp.asarray(spk), jnp.asarray(lengths), L, 1))
    sm = np.asarray(jgraphs.same_speaker_mask(jnp.asarray(spk)))
    # the loss reads the dialogues' positions only, as DAG-ERC's masked loss does
    valid = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    weight = (r.normal(size=(2, B, L, D)) * valid[None, ..., None]).astype(np.float32)
    return H0, adj, sm, weight


@pytest.fixture(scope="module")
def stack_grads_jax():
    """jax.grad of the weighted outputs of JAX's DAGStack(impl='pallas'), w.r.t.
    its parameters and the input (without remat, which changes no value and
    doubles the interpret-mode compile)."""
    H0, adj, sm, weight = _stack_inputs()
    jm = jdagerc.DAGStack(8, 2, chunk=4, remat=False, impl="pallas")
    variables = jdagerc.DAGStack(8, 2, chunk=4, impl="xla").init(jax.random.PRNGKey(1), H0, adj, sm)

    def loss(params, h):
        outs = jm.apply({"params": params}, h, adj, sm, deterministic=False)
        return sum(jnp.vdot(o, w) for o, w in zip(outs, weight))

    with jax.default_matmul_precision("highest"):
        g_params, g_h = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], H0)
    return variables["params"], g_params, g_h


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_dag_stack_kernel_grads_match_jax_pallas(stack_grads_jax, remat):
    params, g_params, g_h = stack_grads_jax
    H0, adj, sm, weight = _stack_inputs()
    stack = tdagerc.DAGStack(8, 2, chunk=4, impl="kernel", remat=remat).train()
    stack.load_state_dict({k: _t(v) for k, v in params.items()})
    h = _t(H0).requires_grad_(True)
    tdb.reset_launches()
    with torch.enable_grad():
        outs = stack(h, _t(adj), _t(sm))
        sum((o * _t(w)).sum() for o, w in zip(outs, weight)).backward()
    assert tdb.launches == {"dag_block": 0, "dag_block_bwd": 0}  # CPU tensors: plain versions
    _close(h.grad.numpy(), g_h, "H0")
    for name, p in stack.named_parameters():
        _close(p.grad.numpy(), g_params[name], name)


# ------------------------------------------------------------------ loss, metrics
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "class-weights"])
def test_masked_cross_entropy_and_accuracy_match_jax(weighted):
    r = np.random.default_rng(1)
    logits = r.normal(size=(3, 7, 6)).astype(np.float32)
    labels = r.integers(0, 6, (3, 7)).astype(np.int32)
    mask = (np.arange(7)[None] < np.asarray([7, 4, 0])[:, None]).astype(np.float32)
    labels[mask == 0] = -1
    logits[0, 0] = logits[0, 0, 2]  # a tie: both take the first maximum
    cw = r.random(6).astype(np.float32) + 0.5 if weighted else None
    want_ce = jtrainer.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
                                            None if cw is None else jnp.asarray(cw))
    got_ce = ttrainer.masked_cross_entropy(_t(logits), _t(labels), _t(mask), None if cw is None else _t(cw))
    np.testing.assert_allclose(got_ce.item(), float(want_ce), rtol=1e-6)
    want_acc = jtrainer.masked_accuracy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    assert ttrainer.masked_accuracy(_t(logits), _t(labels), _t(mask)).item() == pytest.approx(float(want_acc))


def test_classification_summary_matches_sklearn_with_absent_class():
    r = np.random.default_rng(2)
    true = r.integers(0, 4, 60)  # classes 4 and 5 never the target
    pred = np.where(r.random(60) < 0.6, true, r.integers(0, 6, 60))
    pred[pred == 4] = 5  # class 4 nowhere, class 5 only predicted
    want = jmetrics.classification_summary(true.tolist(), pred.tolist(), 6)
    got = tmetrics.classification_summary(true.tolist(), pred.tolist(), 6)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["cm"], want["cm"])
    for k in got:
        if k != "cm":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-15, err_msg=k)


# ------------------------------------------------------------------ optimizers
# (name, weight decay, momentum, and what else the case sets: nesterov, a declared schedule, a tensor LR)
OPTIMS = [("adamw", 0.0, 0.0, {}), ("adamw", 1e-2, 0.0, {}), ("adam", 1e-2, 0.0, {}), ("sgd", 0.0, 0.9, {}),
          ("sgd", 0.0, 0.0, {"nesterov": True}), ("sgd", 0.0, 0.9, {"nesterov": False}),
          ("sgd", 0.0, 0.9, {"sche": True, "tensor_lr": True})]
OPTIM_SCHE = dict(name="Cos", start=0.05, end=0.001, left=0, right=4)


@pytest.mark.parametrize("name,wd,momentum,extra", OPTIMS,
                         ids=[f"{n}-wd{w}-m{m}" + "".join(f"-{k}" if v is True else f"-{k}={v}" for k, v in e.items())
                              for n, w, m, e in OPTIMS])
@pytest.mark.parametrize("grad_scale", [0.1, 10.0], ids=["clip-idle", "clip-active"])
def test_optimizer_step_and_clip_match_optax(name, wd, momentum, extra, grad_scale):
    """3 steps of the port's optimizer after optax's clip ≡ optax's (``nesterov`` defaults to momentum > 0); sgd's
    momentum 0 with ``nesterov=True`` is plain ``-lr·g`` there, as in optax; a declared schedule's LR, and a 0-d
    tensor LR on the CPU as the card's capturable optimizers hold it, give the same updates."""
    r = np.random.default_rng(3)
    shapes = {"w": (5, 4), "b": (4,), "v": (3, 2, 2)}
    init = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.normal(size=s) * grad_scale).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    cfg = dict(name=name, lr=0.01, weight_decay=wd, momentum=momentum, nesterov=extra.get("nesterov", momentum > 0))
    jcfg = joptim.create_optim(**cfg)
    tcfg = Params(**cfg)
    if extra.get("sche"):
        jcfg.sche = joptim.create_schedule(**OPTIM_SCHE)
        tcfg.sche = Params(**OPTIM_SCHE)
    tx = joptim.build_optim(jcfg, grad_clip_norm=5.0)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in init.items()}
    opt = toptim.build_optim(tcfg, tp.values())
    if extra.get("tensor_lr"):
        for g in opt.param_groups:
            g["lr"] = torch.tensor(float(g["lr"]))
    lrs = []
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = _t(g[k])
        norm = toptim.clip_by_global_norm_([p.grad for p in tp.values()], 5.0)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        opt.step()
        lrs.append(float(opt.param_groups[0]["lr"]))
        np.testing.assert_allclose(lrs[-1], joptim.get_learning_rate(state), rtol=1e-6)
    if extra.get("sche"):
        assert len(set(lrs)) == 3 and isinstance(opt.param_groups[0]["lr"], torch.Tensor)
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=k)


def test_adamw_passes_the_configs_weight_decay():
    opt = toptim.build_optim(Params(name="AdamW", lr=1e-3, weight_decay=0.0), [torch.nn.Parameter(torch.ones(2))])
    assert opt.param_groups[0]["weight_decay"] == 0.0  # torch's own default is 0.01


def test_plateau_controller_matches_jax():
    losses = [1.0, 0.9, 0.8] + [0.8] * 12 + [0.79995] * 3 + [0.5] + [0.6] * 25
    jsche = joptim.ReduceLROnPlateau(mode="min")
    trainer = ttrainer.Trainer.__new__(ttrainer.Trainer)
    trainer.params = Params(lr_plateau=True)
    trainer.optimizer = torch.optim.SGD([torch.nn.Parameter(torch.ones(1))], lr=1e-3)
    trainer.lr_sche = torch.optim.lr_scheduler.ReduceLROnPlateau(trainer.optimizer, "min")
    trainer.log = lambda msg: None
    lr, seen = 1e-3, set()
    for loss in losses:
        lr = jsche.step(loss, lr)
        trainer._plateau_step(loss)
        assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(lr, rel=1e-12)
        seen.add(lr)
    assert len(seen) == 4  # three reductions happened


def test_plateau_controller_with_a_tensor_lr_matches_jax():
    """The LR as a 0-d float32 tensor, as the captured step reads it on the
    card: the controller reduces it at the steps where the JAX controller
    reduces its LR, to the same values rounded to float32 (as optax's
    injected LR holds them), writing the tensor in place (the captured
    step's graph reads it by address), and the trainer logs each change."""
    losses = [1.0, 0.9, 0.8] + [0.8] * 12 + [0.79995] * 3 + [0.5] + [0.6] * 25
    jsche = joptim.ReduceLROnPlateau(mode="min")
    trainer = ttrainer.Trainer.__new__(ttrainer.Trainer)
    trainer.params = Params(lr_plateau=True)
    lr_t = torch.tensor(1e-3)
    trainer.optimizer = torch.optim.Adam([torch.nn.Parameter(torch.ones(1))], lr=lr_t, foreach=False)
    trainer.lr_sche = torch.optim.lr_scheduler.ReduceLROnPlateau(trainer.optimizer, "min")
    logged = []
    trainer.log = logged.append
    lr, changes = 1e-3, 0
    for loss in losses:
        new = jsche.step(loss, lr)
        changes += new != lr
        lr = new
        trainer._plateau_step(loss)
        assert trainer.optimizer.param_groups[0]["lr"] is lr_t
        np.testing.assert_allclose(lr_t.item(), np.float32(lr), rtol=1e-6)
    assert changes == 3 and len(logged) == 3 and all("ReduceLROnPlateau" in m for m in logged)


def test_load_optimizer_state_keeps_the_cpu_optimizer_from_a_card_state():
    """A state saved by a capturable optimizer (the LR a tensor, its step
    counts tensors) loads into the CPU trainer's optimizer as a float LR,
    not capturable, and its next step is the step of the optimizer that
    saved the state."""
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))
    src = toptim.build_optim(Params(name="Adam", lr=1e-2), [w], torch.device("cpu"))
    assert not src.param_groups[0]["capturable"] and isinstance(src.param_groups[0]["lr"], float)
    for _ in range(2):
        w.grad = torch.tensor([0.5, -1.0, 0.25])
        src.step()
    card_like = copy.deepcopy(src.state_dict())  # as a checkpoint holds it: no tensor shared with src
    card_like["param_groups"][0].update(lr=torch.tensor(1e-2), capturable=True)
    v = torch.nn.Parameter(w.detach().clone())
    dst = toptim.build_optim(Params(name="Adam", lr=5.0), [v])
    toptim.load_optimizer_state(dst, card_like)
    group = dst.param_groups[0]
    assert group["lr"] == pytest.approx(1e-2) and isinstance(group["lr"], float) and not group["capturable"]
    for p, opt in ((w, src), (v, dst)):
        p.grad = torch.tensor([0.1, 0.2, -0.3])
        opt.step()
    np.testing.assert_allclose(v.detach().numpy(), w.detach().numpy(), rtol=0, atol=1e-7)


# ------------------------------------------------------------------ data
def test_dialogue_loader_batches_match_jax_over_two_epochs():
    samples = j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=37, min_len=4, max_len=30)
    kw = dict(batch_size=5, shuffle=True, seed=7, sort_by_length=True, sort_chunk=2)
    jl = jloader.DialogueLoader(samples, JERCBatcher("atv", 6, 2, bucket=8, max_len=32, pad_batch_to=5),
                                process_index=0, process_count=1, **kw)
    tl = tloader.DialogueLoader(samples, ERCBatcher("atv", 6, 2, bucket=8, max_len=32, pad_batch_to=5), **kw)
    assert len(tl) == len(jl) == 8
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        pairs = list(zip(tl, jl))
        assert len(pairs) == 8
        for got, want in pairs:
            assert got.keys() == want.keys()
            for k in got:
                if want[k] is None:
                    assert got[k] is None, k
                else:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cut = tloader.DialogueLoader(samples, tl.batcher, batch_size=5, seed=7, batch_count=11)
    assert len(list(cut)) == 11  # an epoch cycled past its 8 batches


def test_registry_matches_jax_for_synthetic_names(tmp_path):
    for name in ("synthetic-iemocap-6", "synthetic-cogmen-4", "synthetic-mosei-6", "mosei-x-7", "iemocap-4"):
        assert tregistry.n_classes_of(name) == jregistry.n_classes_of(name)
        assert tregistry.dataset_has_val(name) == jregistry.dataset_has_val(name), name
    for split in ("train", "test"):
        got = tregistry.pick_datas(None, "synthetic-iemocap-6", split)
        want = jregistry.pick_datas(None, "synthetic-iemocap-6", split)
        assert len(got) == len(want) == {"train": 120, "test": 31}[split]
        np.testing.assert_array_equal(got[3]["visual"], want[3]["visual"])
    # an extraction view: the sentence map of the adapted MOSEI pickle, as in JAX
    with open(tmp_path / "MOSEI.adpated.pkl", "wb") as f:
        pickle.dump([["a"], ["b"], [], {}, {}, {}, {}, {}, {"a": ["hello there", "yes"], "b": ["no"]}, [], [], [],
                     []], f)
    got = tregistry.pick_datas(str(tmp_path), "mosei-text-any-7")
    assert got == jregistry.pick_datas(str(tmp_path), "mosei-text-any-7") == {"a": ["hello there", "yes"],
                                                                              "b": ["no"]}


# ------------------------------------------------------------------ trajectory
SMALL = ["--dataset=synthetic-iemocap-6", "--hidden_dim=16", "--gnn_layers=2", "--dag_chunk=4",
         "--device=cpu", "--dag_impl=kernel"]


def _flax_params(state):
    """The flax params of a fused DAGERCModule from the port's state dict."""
    tree = {}
    for key, v in state.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        a = v.detach().numpy().copy()
        if path[0] == "stack":
            node[leaf] = a
        else:  # Linear {weight [out, in], bias} → Dense {kernel [in, out], bias}
            node["kernel" if leaf == "weight" else "bias"] = a.T if leaf == "weight" else a
    return tree


def _port_trainer(*extra):
    p = tdagerc.DAGERCParams()
    p.finalize(SMALL + list(extra))
    p.dropout = 0.0
    trainer = tdagerc.DAGERCTrainer(p)
    trainer.log = lambda msg: None
    trainer.initialize()
    return trainer


def _batches(n=3):
    batcher = JERCBatcher("atv", 6, 2, speaker_onehot=True, bucket=0, max_len=14, pad_batch_to=3)
    return [batcher(j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=2, min_len=6, max_len=20, seed=s))
            for s in range(n)]


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if v is not None}


def test_dag_remat_gives_the_same_gradients():
    batch = _torch_batch(_batches(1)[0])
    on, off = _port_trainer("--dag_remat=true"), _port_trainer("--dag_remat=false")
    assert on.model.stack.remat and not off.model.stack.remat
    on.compute_grads(batch)
    off.compute_grads(batch)
    for (name, a), b in zip(on.model.named_parameters(), off.model.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0, atol=1e-7, err_msg=name)


def test_three_step_trajectory_matches_jax():
    trainer = _port_trainer()
    assert trainer.model.stack.impl == "kernel" and trainer.model.stack.remat
    params0 = _flax_params(trainer.model.state_dict())
    jp = tdagerc.DAGERCParams()  # the JAX module and optimizer from the same settings
    jm = jdagerc.DAGERCModule(emb_dim=712, n_classes=6, gnn_layers=2, hidden_dim=16, chunk=4, remat=True,
                              impl="xla", drop_rate=0.0)
    tx = joptim.build_optim(joptim.create_optim(jp.optim.name, lr=jp.optim.lr, weight_decay=0.0),
                            grad_clip_norm=5.0)

    def loss_fn(params, batch):
        logits = jm.apply({"params": params}, batch, deterministic=False)
        return jtrainer.masked_cross_entropy(logits, batch["label"], batch["attention_mask"])

    @jax.jit
    def step(params, opt_state, batch):  # Trainer._make_raw_train_step's composition
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads, optax.global_norm(grads)

    params, opt_state = params0, tx.init(params0)
    for i, batch in enumerate(_batches()):
        with jax.default_matmul_precision("highest"):
            params, opt_state, loss, grads, gnorm = step(params, opt_state, batch)
        mets = trainer.train_step(_torch_batch(batch))
        np.testing.assert_allclose(mets["Lall"].item(), float(loss), rtol=RTOL, err_msg=f"loss {i}")
        np.testing.assert_allclose(mets["gnorm"].item(), float(gnorm), rtol=RTOL, err_msg=f"gnorm {i}")
        if i == 0:
            want = convert.dagerc_state(jax.tree_util.tree_map(np.asarray, grads))
            for name, p in trainer.model.named_parameters():
                # the step scaled the gradients in place when the clip was active
                _close(p.grad.numpy() * max(1.0, float(gnorm) / 5.0), want[name].numpy(), f"grad {name}")
    want = convert.dagerc_state(jax.tree_util.tree_map(np.asarray, params))
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-4, err_msg=name)


def test_dropout_draws_from_the_seeded_generator():
    a, b = _port_trainer("--seed=3"), _port_trainer("--seed=3")
    for t in (a, b):
        t.model.dropout.p = 0.5
    batch = _torch_batch(_batches(1)[0])
    a.model.train()
    b.model.train()
    torch.manual_seed(0)
    la = a.model(batch)
    torch.manual_seed(1)  # the global RNG plays no part
    np.testing.assert_array_equal(la.detach().numpy(), b.model(batch).detach().numpy())
    assert not torch.equal(la, a.model(batch))  # the stream moves on


# ------------------------------------------------------------------ entry point
def test_train_entry_point_runs_two_steps_on_cpu(tmp_path):
    cmd = [sys.executable, "-m", "erc_tpu_torch.train", "--module=dagerc", *SMALL, "--epoch=1",
           "--batch_count=2", "--max_seq_len=16", "--train.batch_size=4", "--test.batch_size=16",
           "--confusion_matrix=false", f"--save_dir={tmp_path}"]
    code = ("import runpy, sys\n"
            "import erc_tpu_torch.train, erc_tpu_torch.models.dagerc, erc_tpu_torch.ops.kernels.dag_block\n"
            f"sys.argv = {['erc_tpu_torch.train'] + cmd[3:]!r}\n"
            "runpy.run_module('erc_tpu_torch.train', run_name='__main__')\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'erc_tpu')]\n"
            "print('JAX modules:', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "e0 b0 Lall=" in out and "epoch 0: " in out and "2 steps" in out, out
    assert "test: acc=" in out and "Lall=" in out.split("test: acc=")[1], out
    assert "JAX modules: []" in out
    path = tmp_path / "model.last.ckpt"
    assert path.exists() and f"saved {path}" in out
    assert torch.load(path, weights_only=True)["step"] == 2


# ------------------------------------------------------------ --config, --pretrain
@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_config_file_loads_before_the_flags(fmt, tmp_path):
    cfg = {"epoch": 3, "seed": 9, "optim": {"lr": 0.01, "weight_decay": 0.5}, "train": {"batch_size": 5},
           "dag_chunk": 8}
    path = tmp_path / f"run.{fmt}"
    if fmt == "yaml":
        import yaml

        path.write_text(yaml.safe_dump(cfg))
    else:
        import json

        path.write_text(json.dumps(cfg))
    argv = [f"--config={path}", "--dataset=synthetic-iemocap-6", "--seed=4"]
    jp = jdagerc.DAGERCParams()
    jp.from_args(argv)
    jp.iparams()
    tp = tdagerc.DAGERCParams()
    tp.finalize(argv)
    for key in ("epoch", "seed", "optim.lr", "optim.weight_decay", "train.batch_size", "dag_chunk", "optim.name"):
        assert tp[key] == jp[key], key
    assert tp.epoch == 3 and tp.seed == 4 and tp.get("config") is None and jp.get("config") is None


SCHE = ["--optim.sche.name=Cos", "--optim.sche.start=0.001", "--optim.sche.end=0.0001", "--optim.sche.right=9"]


def test_pretrain_loads_a_port_file(tmp_path):
    source = _port_trainer("--optim.name=AdamW", *SCHE, f"--save_dir={tmp_path}")
    for batch in _batches(2):
        source.train_step(_torch_batch(batch))
    path = source.save_model()
    trainer = _port_trainer("--optim.name=AdamW", *SCHE, "--pretrain=true", f"--pretrain_path={path}", "--epoch=0")
    assert trainer.train() == [] and trainer.eidx == 0 and trainer.global_steps == 0
    for (n, a), b in zip(trainer.model.state_dict().items(), source.model.state_dict().values()):
        assert torch.equal(a, b), n
    got, want = trainer.optimizer.state_dict(), source.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"] and got["state"].keys() == want["state"].keys()
    for k, st in want["state"].items():
        for name, v in st.items():
            assert torch.equal(got["state"][k][name], v), (k, name)
    assert int(trainer.optimizer.state["schedule"]["count"]) == 2


def _jax_trainstate(tmp_path, jcfg, steps=2):
    """A JAX Saver file of a DAG-ERC TrainState after ``steps`` updates of ``jcfg``'s optimizer (clip 5) on seeded
    gradients, from the port trainer's initial weights; returns the path, the optimizer, its state, the params and
    the gradient draw."""
    from erc_tpu.train.checkpoint import Saver as JSaver

    probe = _port_trainer()
    params = jax.tree_util.tree_map(jnp.asarray, _flax_params(probe.model.state_dict()))
    tx = joptim.build_optim(jcfg, grad_clip_norm=5.0)
    opt_state = tx.init(params)
    r = np.random.default_rng(0)

    def grads():
        return jax.tree_util.tree_map(lambda v: jnp.asarray(r.normal(size=v.shape).astype(np.float32) * 0.1), params)

    for _ in range(steps):
        updates, opt_state = tx.update(grads(), opt_state, params)
        params = optax.apply_updates(params, updates)
    state = jtrainer.TrainState(params=params, opt_state=opt_state, model_state={},
                                step=jnp.asarray(steps, jnp.int32))
    return JSaver(str(tmp_path)).save_model("last", state), tx, opt_state, params, grads


def _next_step_matches(trainer, tx, opt_state, params, grads, atol):
    """One more step from the loaded state, the port's against optax's: the moments and counts took."""
    g = grads()
    updates, opt_state = tx.update(g, opt_state, params)
    params = optax.apply_updates(params, updates)
    gt = convert.dagerc_state(jax.tree_util.tree_map(np.asarray, g))
    for n, t in trainer.model.named_parameters():
        t.grad = gt[n].clone()
    toptim.clip_by_global_norm_([t.grad for t in trainer.model.parameters()], 5.0)
    trainer.optimizer.step()
    want = convert.dagerc_state(jax.tree_util.tree_map(np.asarray, params))
    for n, t in trainer.model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), want[n].numpy(), rtol=0, atol=atol, err_msg=n)


def test_pretrain_loads_a_jax_trainstate_file(tmp_path):
    jcfg = joptim.create_optim("AdamW", lr=5e-4, weight_decay=0.01)
    jcfg.from_args([a.replace("--optim.", "--") for a in SCHE])
    path, tx, opt_state, params, grads = _jax_trainstate(tmp_path, jcfg)
    trainer = _port_trainer("--optim.name=AdamW", "--optim.weight_decay=0.01", *SCHE, "--pretrain=true",
                            f"--pretrain_path={path}", "--epoch=0")
    trainer.train()
    want = convert.dagerc_state(jax.tree_util.tree_map(np.asarray, params))
    for n, t in trainer.model.named_parameters():
        assert torch.equal(t.detach(), want[n]), n
    assert int(trainer.optimizer.state["schedule"]["count"]) == 2
    assert float(trainer.optimizer.param_groups[0]["lr"]) == joptim.get_learning_rate(opt_state)
    _next_step_matches(trainer, tx, opt_state, params, grads, RTOL)


TRACES = {"sgd-m0.9-nesterov": ["--optim.name=SGD", "--optim.lr=0.01", "--optim.momentum=0.9",
                                "--optim.nesterov=true"],
          "lars": ["--optim.name=lars", "--optim.lr=0.01", "--optim.weight_decay=0.01"]}


@pytest.mark.parametrize("flags", TRACES.values(), ids=TRACES.keys())
def test_pretrain_loads_a_jax_trainstate_with_a_trace(flags, tmp_path):
    """A JAX TrainState of ``optax.sgd(momentum=0.9, nesterov=True)`` or ``optax.lars`` after 2 steps loads into the
    port's ``Sgd`` / ``Lars`` (optax's ``trace`` under the key ``trace``), and the next step equals optax's."""
    jcfg = joptim.create_optim("x")
    jcfg.from_args([a.replace("--optim.", "--") for a in flags])
    path, tx, opt_state, params, grads = _jax_trainstate(tmp_path, jcfg)
    trainer = _port_trainer(*flags, "--pretrain=true", f"--pretrain_path={path}", "--epoch=0")
    trainer.train()
    assert isinstance(trainer.optimizer, toptim.Sgd if "SGD" in flags[0] else toptim.Lars)
    traces = [trainer.optimizer.state[p]["trace"] for p in trainer.model.parameters()]
    assert len(traces) == len(list(trainer.model.parameters())) and any(bool(t.any()) for t in traces)
    _next_step_matches(trainer, tx, opt_state, params, grads, 1e-6)


def test_train_main_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdagerc.main([a for a in SMALL if a != "--device=cpu"])
