"""The port's COGMEN training (models.cogmen.COGMENTrainer) ≡ the JAX package's.

Small widths (hidden 16; input 712 = audio 100 + text 100 + visual 512 from
the synthetic COGMEN geometry, so the chained encoder keeps its 712 width
and 8 heads), B = 3 with one short dialogue, L = 16, on the CPU, where the
band kernels run as their plain pieces inside the autograd Functions.
JAX runs at matmul precision highest, both at dropout 0:

- gradients of the masked cross-entropy in train mode, for the banded and
  the dense graph and both encoder modes, against ``jax.grad`` of the flax
  module (dense, and banded through the Pallas kernels' custom VJPs in
  interpret mode): each parameter's ‖port − JAX‖ within 1e-5 of its
  gradient norm, or within 1e-8 of the global norm where the exact
  gradient is 0 and only rounding is left (the attention's key bias shifts
  a softmax's logits alike): the absolute floor of PERF.md §2's rule, 1e-4
  of 1e-4 of the global norm;
- the running statistics after a train-mode forward against flax's
  updated ``batch_stats``: 1e-6;
- a 3-step trajectory of ``COGMENTrainer`` (Adam, lr 1e-4, L2 1e-8 folded
  into the gradient) against the JAX pieces ``Trainer._make_raw_train_step``
  composes: loss and global norm within 1e-5 relative, first-step
  gradients by the rule above, parameters after 3 steps within 1e-5, a
  tenth of one step at lr 1e-4 (Adam divides by the root of the second
  moment, which magnifies the last-digit differences of near-zero
  gradients), except where the exact gradient is 0 (the graph
  transformer's key bias shifts a softmax's logits alike; its value and
  skip biases add a constant per feature that the batch norm's mean
  removes): there Adam turns rounding noise into lr-sized steps of random
  sign on both sides, so only the gradient is compared;
- ``python -m erc_tpu_torch.train --module=cogmen --device=cpu`` for 2 steps
  in a fresh interpreter (no JAX module imported), whose saved model serves
  through ``InferenceEngine`` with the trainer's eval logits; without CUDA
  and without ``--device=cpu`` the entry point raises;
- dropout (encoder and head) draws from the trainer's seeded generator.
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

from erc_tpu.data.collate import ERCBatcher as JERCBatcher
from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu.models.cogmen import COGMENModule as JCOGMEN
from erc_tpu.train import optim as joptim
from erc_tpu.train import trainer as jtrainer
from erc_tpu_torch import convert
from erc_tpu_torch.models import cogmen as tcogmen
from erc_tpu_torch.train.trainer import masked_cross_entropy
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
KW = dict(input_size=712, hidden_size=16, num_head=17, n_speakers=2, n_classes=6, wp=5, wf=5, drop_rate=0.0)
SMALL = ["--dataset=synthetic-cogmen-6", "--hidden_size=16", "--device=cpu", "--graph_impl=banded"]


def _batches(n=1):
    batcher = JERCBatcher("atv", 6, 2, bucket=16, max_len=16, pad_batch_to=3)
    return [batcher(j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=3, min_len=5, max_len=16, seed=s))
            for s in range(n)]


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if v is not None}


def _variables(mode, batch):
    """Flax variables with non-trivial BN running statistics."""
    model = JCOGMEN(graph_impl="dense", encoder_mode=mode, **KW)
    variables = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0), batch, deterministic=True))
    rng = np.random.default_rng(1)
    variables["batch_stats"]["gcn"]["bn"] = {"mean": rng.normal(0, 0.3, 16).astype(np.float32),
                                             "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}
    return variables


def _jax_loss(model, batch):
    def loss(params, batch_stats):
        logits, new = model.apply({"params": params, "batch_stats": batch_stats}, batch, deterministic=False,
                                  mutable=["batch_stats"])
        return jtrainer.masked_cross_entropy(logits, batch["label"], batch["attention_mask"]), new["batch_stats"]

    return loss


@pytest.fixture(scope="module", params=["reference", "chained"])
def jax_grads(request):
    """(mode, batch, variables, JAX gradients by graph impl, updated batch_stats)."""
    mode = request.param
    batch = _batches()[0]
    variables = _variables(mode, batch)
    impls = ("dense", "banded") if mode == "reference" else ("dense",)
    grads, stats = {}, None
    for impl in impls:
        loss = _jax_loss(JCOGMEN(graph_impl=impl, encoder_mode=mode, **KW), batch)
        with jax.default_matmul_precision("highest"):
            g, stats = jax.jit(jax.grad(loss, has_aux=True))(variables["params"], variables["batch_stats"])
        grads[impl] = convert.cogmen_state(jax.tree_util.tree_map(np.asarray, g), variables["batch_stats"])
    return mode, batch, variables, grads, jax.tree_util.tree_map(np.asarray, stats)


def _port_module(mode, impl, variables):
    module = tcogmen.COGMENModule(graph_impl=impl, encoder_mode=mode, **KW)
    module.load_state_dict(convert.cogmen_state(variables["params"], variables["batch_stats"]))
    return module.train()


def _assert_grads_close(named_grads, want, global_norm=None):
    """‖got − want‖ ≤ max(RTOL · ‖want‖, 1e-8 · global norm)."""
    if global_norm is None:
        global_norm = float(np.sqrt(sum(float((want[n].double() ** 2).sum()) for n, _ in named_grads)))
    for name, g in named_grads:
        w = want[name].double()
        d = (g.double() - w).norm().item()
        assert d <= max(RTOL * w.norm().item(), 1e-8 * global_norm), (name, d, w.norm().item())


@pytest.mark.parametrize("impl", ["dense", "banded"])
def test_cogmen_grads_match_jax(jax_grads, impl):
    mode, batch, variables, grads, _ = jax_grads
    module = _port_module(mode, impl, variables)
    tb = _torch_batch(batch)
    with torch.enable_grad():
        logits = module(tb)
        masked_cross_entropy(logits, tb["label"], tb["attention_mask"]).backward()
    _assert_grads_close([(n, p.grad) for n, p in module.named_parameters()], grads["dense"])
    if "banded" in grads:  # the band kernels' custom VJPs on the JAX side too
        _assert_grads_close([(n, p.grad) for n, p in module.named_parameters()], grads["banded"])


@pytest.mark.parametrize("impl", ["dense", "banded"])
def test_running_stats_match_flax(jax_grads, impl):
    mode, batch, variables, _, stats = jax_grads
    module = _port_module(mode, impl, variables)
    with torch.enable_grad():
        module(_torch_batch(batch))
    bn = module.gcn.bn
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["gcn"]["bn"]["mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["gcn"]["bn"]["var"], rtol=0, atol=1e-6)


def _port_trainer(*extra):
    p = tcogmen.COGMENParams()
    p.finalize(SMALL + list(extra))
    p.drop_rate = 0.0
    trainer = tcogmen.COGMENTrainer(p)
    trainer.log = lambda msg: None
    trainer.initialize()
    return trainer


def test_three_step_trajectory_matches_jax():
    batches = _batches(3)
    trainer = _port_trainer()
    assert trainer.model.gcn.graph_impl == "banded" and trainer.grad_clip_norm is None
    variables = _variables("reference", batches[0])
    trainer.model.load_state_dict(convert.cogmen_state(variables["params"], variables["batch_stats"]))
    jp = tcogmen.COGMENParams()
    jm = JCOGMEN(graph_impl="dense", encoder_mode="reference", **KW)
    tx = joptim.build_optim(joptim.create_optim(jp.optim.name, lr=jp.optim.lr, weight_decay=jp.optim.weight_decay))

    @jax.jit
    def step(params, batch_stats, opt_state, batch):  # Trainer._make_raw_train_step's composition
        (value, batch_stats), grads = jax.value_and_grad(_jax_loss(jm, batch), has_aux=True)(params, batch_stats)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), batch_stats, opt_state, value, grads, optax.global_norm(grads)

    params, batch_stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    for i, batch in enumerate(batches):
        with jax.default_matmul_precision("highest"):
            params, batch_stats, opt_state, loss, grads, gnorm = step(params, batch_stats, opt_state, batch)
        mets = trainer.train_step(_torch_batch(batch))
        np.testing.assert_allclose(mets["Lall"].item(), float(loss), rtol=RTOL, err_msg=f"loss {i}")
        np.testing.assert_allclose(mets["gnorm"].item(), float(gnorm), rtol=RTOL, err_msg=f"gnorm {i}")
        if i == 0:
            want = convert.cogmen_state(jax.tree_util.tree_map(np.asarray, grads), batch_stats)
            _assert_grads_close([(n, p.grad) for n, p in trainer.model.named_parameters()], want, float(gnorm))
            zero = {n for n, _ in trainer.model.named_parameters() if want[n].norm() <= 1e-6 * float(gnorm)}
    want = convert.cogmen_state(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, batch_stats))
    assert zero == {f"gcn.conv2.lin_{n}.bias" for n in ("key", "value", "skip")}
    # the running mean takes in those biases' noise, so the running stats are
    # held after one step only (test_running_stats_match_flax)
    for name, t in trainer.model.named_parameters():
        if name not in zero:
            np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_dropout_draws_from_the_seeded_generator():
    a, b = _port_trainer("--seed=3", "--encoder_mode=chained"), _port_trainer("--seed=3", "--encoder_mode=chained")
    drops = [m for m in a.model.modules() if type(m).__name__ == "Dropout"]
    assert len(drops) == 1 + 2 * 2  # the head, and each encoder layer's attention and its own
    for t in (a, b):
        for m in t.model.modules():
            if type(m).__name__ == "Dropout":
                m.p = 0.5
                assert m.generator is not None
    batch = _torch_batch(_batches()[0])
    a.model.train()
    b.model.train()
    torch.manual_seed(0)
    la = a.model(batch)
    torch.manual_seed(1)  # the global RNG plays no part
    np.testing.assert_array_equal(la.detach().numpy(), b.model(batch).detach().numpy())
    assert not torch.equal(la, a.model(batch))  # the stream moves on


# ------------------------------------------------------------------ entry point
def test_train_entry_point_runs_two_steps_saves_and_serves(tmp_path):
    args = [*SMALL, "--module=cogmen", "--encoder_mode=chained", "--epoch=1", "--batch_count=2",
            "--max_seq_len=32", "--train.batch_size=4", "--test.batch_size=16", "--confusion_matrix=false",
            f"--save_dir={tmp_path}"]
    code = ("import runpy, sys\n"
            "import erc_tpu_torch.train, erc_tpu_torch.models.cogmen, erc_tpu_torch.ops.kernels.banded\n"
            "import erc_tpu_torch.serve, erc_tpu_torch.train.checkpoint\n"
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
    assert "e0 b0 Lall=" in out and "2 steps" in out and "test: acc=" in out, out
    assert "JAX modules: []" in out
    path = tmp_path / "model.last.ckpt"
    assert path.exists() and (tmp_path / "model.last.ckpt.json").exists() and f"saved {path}" in out

    from erc_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine.from_module("cogmen", str(path), dataset="synthetic-cogmen-6", batch_size=4,
                                         hidden_size=16, encoder_mode="chained", graph_impl="banded", device="cpu")
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 2 and set(saved) == {"model", "optimizer", "rng", "step", "eidx", "best_f1",
                                                 "best_val_f1"}
    model = tcogmen.COGMENModule(graph_impl="dense", encoder_mode="chained", **{**KW, "drop_rate": 0.5})
    model.load_state_dict(saved["model"])
    batch = engine.batcher(j_synthetic_erc("iemocap-cogmen", 6, "test", n_train=4, max_len=20, seed=5)[:4])
    with torch.no_grad():
        want = model.eval()(_torch_batch(batch)).numpy()
    np.testing.assert_allclose(engine.logits(batch), want, rtol=0, atol=1e-5)


def test_train_main_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcogmen.main([a for a in SMALL if a != "--device=cpu"])
