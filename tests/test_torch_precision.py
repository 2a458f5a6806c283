"""The port's precision knobs ≡ the JAX trainer's, on the CPU.

- ``--compute_dtype=bfloat16`` is honoured: a forward hook inside the port's
  bfloat16 step sees bfloat16 activations, its loss is not the float32
  step's bit for bit, and the masters, their ``.grad``, the optimizer state,
  the LR and the batch norm's running statistics stay float32; the val and
  test stages of a trainer built with bfloat16 give the float32 forward's
  logits bit for bit.
- ``--transfer_dtype=bfloat16``: the port's host rounding equals the JAX
  package's ``transfer_cast_fn('bfloat16')`` (``ml_dtypes``) bit for bit,
  compared as uint16, on normal, subnormal, tie and non-finite values;
  integers and booleans pass through; the floating arrays' bytes halve; a
  step on the bfloat16-transferred batch equals a step on the float32 batch
  rounded to bfloat16 and back, bit for bit.
- The refusals: bfloat16 with COGMEN's or DialogueGCN's banded graph (or
  ``auto`` where L may pass 256) and with DAG-ERC's kernel form raise a
  ``ValueError`` at trainer build, as the JAX package's bfloat16 step fails
  to trace there; ``--matmul_precision`` takes ``highest``/``float32`` and
  ``high``/``tensorfloat32``, defaults to ``highest``, raises for
  ``bfloat16``/``default``/``fastest``, and its scope restores torch's
  settings; the knobs the port reads but does not honour yet (the
  distributed ones) raise ``NotImplementedError``, and those of the
  runtime slice build.

The families' bfloat16 steps against the JAX package's are in
``test_torch_precision_graph.py``, ``test_torch_precision_seq.py`` and
``test_torch_precision_mm.py``, through the helpers here (``FAMILIES``,
``jax_bf16_step``, ``port_bf16_step``, ``assert_bf16_step_matches``): the
same numpy batch (the port loader's first) and the same weights (seeded
draws in the JAX tree's shapes, converted), dropout off in both, one JAX
bfloat16 step (``Trainer._make_raw_train_step``'s casts around the JAX
trainer's own ``loss_and_metrics``, matmul precision highest) against one
bfloat16 step of the port's trainer: losses within ``LOSS_RTOL`` relative,
each parameter's gradient within ``GRAD_RTOL`` of its norm, floored at
``GRAD_FLOOR`` of the global norm.
"""

from __future__ import annotations

import types
from functools import partial

import flax.linen
import numpy as np
import pytest
import torch

import jax

from erc_tpu.data.loader import transfer_cast_fn
from erc_tpu.train import trainer as jtrainer
from erc_tpu_torch import convert
from erc_tpu_torch.core import precision
from erc_tpu_torch.core.cuda_graphs import host_tensor
from erc_tpu_torch.data.loader import to_device
from erc_tpu_torch.ops.dropout import Dropout
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

LOSS_RTOL = 2e-2  # the port's bfloat16 loss against the JAX package's, relative
GRAD_RTOL = 5e-2  # each gradient's gap, relative to its norm ...
GRAD_FLOOR = 1e-3  # ... or to this share of the global norm, whichever is larger


def _family(name, port_mod, port_cls, jax_mod, jax_cls, argv, convert_fn, jax_zero=None, stats=False):
    return types.SimpleNamespace(name=name, port_mod=port_mod, port_cls=port_cls, jax_mod=jax_mod, jax_cls=jax_cls,
                                 argv=argv, convert=convert_fn, jax_zero=jax_zero or {}, stats=stats)


COGMEN_ARGS = ["--dataset=synthetic-cogmen-6", "--hidden_size=16", "--max_seq_len=16"]
FAMILIES = {f.name: f for f in [
    _family("cogmen", "cogmen", "COGMEN", "cogmen", "COGMEN", [*COGMEN_ARGS, "--graph_impl=dense"],
            convert.cogmen_state, stats=True),
    _family("dagerc", "dagerc", "DAGERC", "dagerc", "DAGERC",
            ["--dataset=synthetic-iemocap-6", "--gnn_layers=2", "--hidden_dim=16", "--max_seq_len=16", "--dag_chunk=4"],
            convert.dagerc_state),
    _family("dgcn", "dgcn", "DGCN", "dgcn", "DGCN", [*COGMEN_ARGS, "--graph_impl=dense"], convert.dgcn_state),
    *[_family(f"mmgcn-{adj}", "mmgcn", "MMGCN", "mmgcn", "MMGCN",
              ["--dataset=synthetic-cogmen-6", "--graph_hidden_size=8", "--gcn_layers=4", "--gcn_chunk=2",
               "--max_seq_len=16", f"--adj_impl={adj}"], convert.mmgcn_state, jax_zero={"drop_rate": 0.0})
      for adj in ("dense", "structured")],
    *[_family(f"dgcnv2-{base}", "dgcnv2", "DGCNV2", "dgcnv2", "DGCNV2",
              ["--dataset=synthetic-cogmen-6", f"--base_model={base}", "--hidden_size=8", "--d_g=8", "--d_p=8",
               "--max_seq_len=16"], convert.dgcnv2_state, jax_zero={"dropout_rec": 0.0})
      for base in ("LSTM", "GRU", "DialogRNN")],
    _family("dgcnv2_daily", "dgcnv2", "DGCNV2Daily", "dgcnv2", "DGCNV2Daily",
            ["--dataset=synthetic-daily-token-7", "--vocab_size=50", "--n_words=6", "--embedding_dim=8",
             "--max_seq_len=9", "--hidden_size=8"], convert.dgcnv2_state, jax_zero={"dropout_rec": 0.0}),
    _family("cim", "cim", "CIM", "cim", "CIM", ["--dataset=synthetic-mosei-2", "--hidden_size=8", "--max_seq_len=12"],
            convert.cim_state),
    *[_family(m, m, {"mmin_base": "MMINBase", "mmin_miss": "MMINMiss", "mmin_miss2": "MMINMiss2"}[m], m,
              {"mmin_base": "MMINBase", "mmin_miss": "MMINMiss", "mmin_miss2": "MMINMiss2"}[m],
              ["--dataset=synthetic-mmin-4"], getattr(convert, f"{m}_state"))
      for m in ("mmin_base", "mmin_miss", "mmin_miss2")],
]}
SMALL = ["--device=cpu", "--train.batch_size=3", "--batch_count=1", "--seed=2"]


def _import(package, name):
    import importlib

    return importlib.import_module(f"{package}.models.{name}")


def port_trainer(fam, *extra):
    """The family's port trainer at the small settings on the CPU, dropout off."""
    mod = _import("erc_tpu_torch", fam.port_mod)
    p = getattr(mod, f"{fam.port_cls}Params")()
    p.finalize([*fam.argv, *SMALL, *extra])
    trainer = getattr(mod, f"{fam.port_cls}Trainer")(p)
    trainer.log = lambda msg: None
    trainer.initialize()
    for m in trainer.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return trainer


def host_batch(trainer):
    """The first batch of the trainer's train loader (numpy, no None)."""
    batch = next(iter(trainer.make_loader("train")))
    return {k: v for k, v in batch.items() if v is not None}


def _draw(shapes, seed):
    """Arrays of the shapes in a flax tree from a seed: weights N(0, 1/fan_in),
    vectors N(0, 0.01) (batch norm scales 1 + that), running means 0 and
    variances 1."""
    r = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "mean":
            return np.zeros(s.shape, np.float32)
        if name == "var":
            return np.ones(s.shape, np.float32)
        std = 0.1 if len(s.shape) == 1 else 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return ((name == "scale") + std * r.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_trainer(fam, batch):
    """The family's JAX trainer (no experiment, no mesh: ``imodels`` alone),
    its module's dropout rates that flax's ``Dropout`` does not carry zeroed,
    and (params, model_state) drawn in its shapes."""
    mod = _import("erc_tpu", fam.jax_mod)
    jp = getattr(mod, f"{fam.jax_cls}Params")()
    jp.from_args([*fam.argv, *SMALL])
    jp.iparams()
    jtr = object.__new__(getattr(mod, f"{fam.jax_cls}Trainer"))
    jtr.params, jtr.mesh, jtr.class_weights = jp, types.SimpleNamespace(size=1), None
    jtr.imodels(jp)
    if fam.jax_zero:
        jtr.model = jtr.model.clone(**fam.jax_zero)
    init = partial(jtr.model.init, deterministic=True)
    shapes = jax.eval_shape(init, {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, batch)
    variables = _draw(shapes, 0)
    if fam.name == "mmin_miss":
        pre = jax.eval_shape(partial(jtr.pretrained_model.init, deterministic=True),
                             {"params": jax.random.PRNGKey(0)}, batch)
        jtr.pretrained_params = _draw(pre, 1)["params"]
    return jtr, variables["params"], {k: v for k, v in variables.items() if k != "params"}


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """flax's ``Dropout`` as the identity (the port's runs at p = 0)."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **kw: x)


def jax_bf16_step(jtr, params, model_state, batch, dtype="bfloat16"):
    """(loss, gradients) of the JAX trainer's train step in ``dtype``:
    ``_make_raw_train_step``'s casts around its ``loss_and_metrics``, at
    matmul precision highest."""

    def lf(p):
        variables = {"params": jtrainer.cast_floats(p, dtype), **model_state}
        loss, _ = jtr.loss_and_metrics(variables, jtrainer.cast_floats(batch, dtype), jax.random.PRNGKey(3),
                                       train=True)
        return loss

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(lf))(params)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _state(fam, tree, model_state):
    if fam.stats:
        return fam.convert(tree, model_state["batch_stats"])
    return fam.convert(tree)


def assert_bf16_step_matches(fam):
    """One bfloat16 step of the port against one of the JAX package, from
    the same weights and batch.  The loss within ``LOSS_RTOL``; each
    gradient's gap to JAX's, relative to max(its norm, ``GRAD_FLOOR`` · the
    global norm), within ``GRAD_RTOL`` beyond the JAX step's own bfloat16
    error for that parameter (its bfloat16 gradient's gap to its float32
    one, by the same measure): XLA's CPU reductions of bfloat16 that JAX's
    autodiff emits (the transposes of broadcasts) accumulate in bfloat16,
    where torch's accumulate in float32, so that the JAX package's own
    bfloat16 gradients stray from its float32 ones by up to 51 % of their
    norm here (COGMEN's graph transformer).  Returns (loss gap, worst
    gradient gap, JAX's own gap at that parameter)."""
    probe = port_trainer(fam)
    batch = host_batch(probe)
    jtr, params, model_state = jax_trainer(fam, batch)
    jloss, jgrads = jax_bf16_step(jtr, params, model_state, batch)
    _, jgrads32 = jax_bf16_step(jtr, params, model_state, batch, "float32")
    trainer = port_trainer(fam, "--compute_dtype=bfloat16")
    trainer.model.load_state_dict(_state(fam, params, model_state))
    if fam.name == "mmin_miss":
        trainer.pretrained_model.load_state_dict(convert.mmin_base_state(jtr.pretrained_params))
    mets = trainer.compute_grads(to_device(batch, trainer.device))
    want, want32 = _state(fam, jgrads, model_state), _state(fam, jgrads32, model_state)
    named = [(n, t.grad) for n, t in trainer.model.named_parameters()]
    gnorm = float(np.sqrt(sum(float((want32[n].double() ** 2).sum()) for n, _ in named)))

    def gap(got, ref):
        return (got.double() - ref.double()).norm().item() / max(ref.double().norm().item(), GRAD_FLOOR * gnorm)

    loss_gap = abs(mets["Lall"].item() - jloss) / abs(jloss)
    worst = (0.0, 0.0, "")
    for name, g in named:
        assert g.dtype == torch.float32, name
        if want32[name].norm() <= GRAD_FLOOR * gnorm:
            # an exact gradient of about 0 (COGMEN's graph transformer biases,
            # whose shift the batch norm removes): rounding alone, held under the floor
            assert g.norm() <= GRAD_FLOOR * gnorm, (fam.name, name, g.norm().item() / gnorm)
            continue
        own = gap(want[name], want32[name])
        got = gap(g, want[name])
        assert got <= GRAD_RTOL + own, (fam.name, name, got, own)
        worst = max(worst, (got, own, name))
    print(f"{fam.name}: loss {mets['Lall'].item():.6f} vs JAX {jloss:.6f} (gap {loss_gap:.2e}); worst gradient "
          f"gap {worst[0]:.2e} at {worst[2]} (JAX's own bfloat16 gap there {worst[1]:.2e})")
    assert loss_gap <= LOSS_RTOL, (fam.name, mets["Lall"].item(), jloss)
    return loss_gap, worst[0], worst[1]


# ------------------------------------------------------------ compute_dtype
def _cogmen(*extra):
    return port_trainer(FAMILIES["cogmen"], *extra)


def test_bf16_step_runs_in_bf16_and_keeps_float32_state():
    """A forward hook inside the bfloat16 step sees bfloat16 activations (the
    graph layers' and the biLSTM's), the loss is not the float32 step's, and
    everything the step keeps is float32."""
    f32, bf16 = _cogmen(), _cogmen("--compute_dtype=bfloat16")
    bf16.model.load_state_dict(f32.model.state_dict())
    batch = host_batch(f32)
    seen = []
    bf16.model.transformer_out.register_forward_hook(lambda m, a, out: seen.append(out.dtype))
    lstm = port_trainer(FAMILIES["dgcn"], "--compute_dtype=bfloat16")
    lstm.model.rnn.register_forward_hook(lambda m, a, out: seen.append(out.dtype))
    m32 = f32.train_step(to_device(batch, f32.device))
    m16 = bf16.train_step(to_device(batch, bf16.device))
    lstm.train_step(to_device(host_batch(lstm), lstm.device))
    assert seen == [torch.bfloat16, torch.bfloat16]
    assert m16["Lall"].dtype == torch.float32 and m16["Lall"].item() != m32["Lall"].item()
    for trainer in (bf16, lstm):
        state = [t for s in trainer.optimizer.state.values() for t in s.values()]
        assert state and all(t.dtype == torch.float32 for t in state)
        for name, t in [*trainer.model.named_parameters(), *trainer.model.named_buffers()]:
            assert t.dtype == torch.float32, name
            assert t.grad is None or t.grad.dtype == torch.float32, name
        assert not torch.is_tensor(trainer.optimizer.param_groups[0]["lr"])  # a float on the CPU
    assert bf16.model.gcn.bn.running_mean.dtype == torch.float32 and bf16.model.gcn.bn.running_mean.abs().sum() > 0


@pytest.mark.parametrize("name, transfer", [("cogmen", "float32"), ("cogmen", "bfloat16"), ("dgcn", "bfloat16")])
def test_eval_stages_compute_in_float32(name, transfer):
    """The test stage of a trainer that trains in bfloat16 gives the logits of
    a float32 trainer with its weights, bit for bit (with either transfer
    dtype: eval restores the batch to float32 at entry); the biLSTM reads its
    float32 parameters again after the bfloat16 step."""
    fam = FAMILIES[name]
    bf16 = port_trainer(fam, "--compute_dtype=bfloat16", f"--transfer_dtype={transfer}", "--test.batch_size=4")
    bf16.train_step(to_device(host_batch(bf16), bf16.device))
    rnns = [m for m in bf16.model.modules() if isinstance(m, torch.nn.RNNBase)]
    assert (name == "dgcn") == bool(rnns)
    for m in rnns:
        assert all(w is getattr(m, n) for w, n in zip(m._flat_weights, m._flat_weights_names))
    f32 = port_trainer(fam, f"--transfer_dtype={transfer}", "--test.batch_size=4")
    f32.model.load_state_dict(bf16.model.state_dict())
    logits = {}
    for tag, trainer in (("bf16", bf16), ("f32", f32)):
        out = logits[tag] = []
        trainer.test_step_collect = lambda batch, lg, out=out: out.append(lg)
        trainer.test()
    assert len(logits["bf16"]) > 1
    for a, b in zip(logits["bf16"], logits["f32"]):
        assert a.dtype == np.float32 and np.array_equal(a, b)


# ----------------------------------------------------------- transfer_dtype
def test_transfer_rounding_matches_ml_dtypes_bit_for_bit():
    r = np.random.default_rng(0)
    f32 = np.float32
    special = np.array([0.0, -0.0, 1.0, 1.00390625, 1.01171875, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 3.4e38, -3.4e38,
                        np.finfo(f32).tiny, np.finfo(f32).tiny / 3, 1e-40, -1e-45, np.inf, -np.inf], f32)
    bits = r.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32).view(f32)
    scaled = (r.normal(size=4096) * 10.0 ** r.integers(-30, 30, 4096)).astype(f32)
    x = np.concatenate([special, scaled, bits[np.isfinite(bits)]])
    assert x.dtype == f32
    want = transfer_cast_fn("bfloat16")({"x": x})["x"].view(np.uint16)
    got = host_tensor(x, torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, want)
    nan = host_tensor(np.array([np.nan, -np.nan], f32), torch.bfloat16).float().numpy()
    assert np.isnan(nan).all()


def test_transfer_passes_integers_and_booleans_and_halves_the_float_bytes():
    batch = host_batch(_cogmen())
    batch["flags"] = np.array([True, False, True])
    f32 = to_device(batch, torch.device("cpu"))
    b16 = to_device(batch, torch.device("cpu"), torch.bfloat16)
    floats = [k for k, v in batch.items() if v.dtype.kind == "f"]
    assert floats and set(floats) == {k for k, t in b16.items() if t.is_floating_point()}
    for k, t in b16.items():
        if k in floats:
            assert t.dtype == torch.bfloat16 and 2 * t.nbytes == f32[k].nbytes
        else:
            assert t.dtype == f32[k].dtype and torch.equal(t, f32[k])
    assert 2 * sum(b16[k].nbytes for k in floats) == sum(f32[k].nbytes for k in floats)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_step_on_a_bf16_transferred_batch_equals_the_step_on_the_rounded_batch(compute):
    """train_batch with --transfer_dtype=bfloat16 ≡ train_batch with float32
    transfer of the batch rounded to bfloat16 and back, bit for bit."""
    a = _cogmen(f"--compute_dtype={compute}", "--transfer_dtype=bfloat16")
    b = _cogmen(f"--compute_dtype={compute}")
    b.model.load_state_dict(a.model.state_dict())
    batch = host_batch(a)
    rounded = {k: host_tensor(v, torch.bfloat16).float().numpy() if v.dtype.kind == "f" else v for k, v in batch.items()}
    assert any(not np.array_equal(rounded[k], batch[k]) for k in batch)
    ma, mb = a.train_batch(batch), b.train_batch(rounded)
    assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)
    for (n, ta), tb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(ta, tb), n


# ----------------------------------------------------------------- refusals
REFUSED = [("cogmen", ["--graph_impl=banded"]), ("cogmen", ["--graph_impl=auto", "--max_seq_len=300"]),
           ("dgcn", ["--graph_impl=banded"]), ("dgcn", ["--graph_impl=auto", "--max_seq_len=300"]),
           ("dagerc", ["--dag_impl=kernel"]), ("dgcnv2-LSTM", ["--base_model=DialogRNN"])]


@pytest.mark.parametrize("name, extra", REFUSED, ids=[f"{n}-{'-'.join(e)}" for n, e in REFUSED])
def test_bf16_refused_where_the_jax_step_fails(name, extra):
    """bfloat16 raises a ValueError at trainer build where the JAX package's
    bfloat16 step fails to trace; float32 builds those forms."""
    fam = FAMILIES[name]
    with pytest.raises(ValueError, match="compute_dtype=bfloat16 with .*JAX package's bfloat16 train step fails"):
        port_trainer(fam, *extra, "--compute_dtype=bfloat16")
    port_trainer(fam, *extra)


@pytest.mark.parametrize("name, extra, error", [
    ("cogmen", ["--graph_impl=banded"], "lax.mul requires arguments to have the same dtypes"),
    ("dgcnv2-LSTM", ["--base_model=DialogRNN"], "carry input and carry output must have equal types"),
])
def test_the_jax_bf16_step_fails_on_the_refused_forms(name, extra, error, no_flax_dropout):
    """The JAX package's own bfloat16 step on two of the refused forms fails
    to trace, as the refusals' messages say (the banded graph in the band
    kernels' product, DialogueRNN in its scan)."""
    fam = FAMILIES[name]
    fam = types.SimpleNamespace(**{**vars(fam), "argv": [*fam.argv, *extra]})
    batch = host_batch(port_trainer(fam))
    jtr, params, model_state = jax_trainer(fam, batch)
    with pytest.raises(TypeError, match=error):
        jax_bf16_step(jtr, params, model_state, batch)


# --------------------------------------------------------- matmul_precision
def test_matmul_precision_defaults_to_highest_and_maps_onto_torch():
    assert _cogmen().params.matmul_precision == "highest" and _cogmen().fp32_precision == "ieee"
    for name, want in (("float32", "ieee"), ("high", "tf32"), ("tensorfloat32", "tf32")):
        assert _cogmen(f"--matmul_precision={name}").fp32_precision == want


@pytest.mark.parametrize("name", ["bfloat16", "default", "fastest"])
def test_bf16_matmul_precisions_raise(name):
    with pytest.raises(ValueError, match="use --compute_dtype=bfloat16"):
        _cogmen(f"--matmul_precision={name}")


def test_matmul_precision_is_scoped_to_the_trainer():
    """TF32 in cuBLAS and in the guarded cuDNN RNN inside the trainer's step
    (a hook on the biLSTM reads torch's settings there), strict float32 in
    another trainer's, and torch's settings as they were after each."""
    backends = (torch.backends.cuda.matmul, torch.backends.cudnn.rnn)
    before = [b.fp32_precision for b in backends]
    seen = []
    for name in ("tensorfloat32", "highest"):
        trainer = port_trainer(FAMILIES["dgcn"], f"--matmul_precision={name}")
        trainer.model.rnn.layers[0].register_forward_hook(
            lambda m, a, out: seen.append([b.fp32_precision for b in backends]))
        trainer.train_step(to_device(host_batch(trainer), trainer.device))
        assert [b.fp32_precision for b in backends] == before and precision.cudnn_fp32() == "ieee"
    assert seen == [["tf32", "tf32"], ["ieee", "ieee"]]


# ------------------------------------------------------------ once not ported
# the JAX trainer's knobs that the port refused until its runtime slice (the
# first eight, honoured since: tests/test_torch_callbacks.py and
# test_torch_runtime.py run each) and its data-parallel slice (the distributed
# three: tests/test_torch_multiprocess.py runs them); none raises
# NotImplementedError now.  The coordinator alone: the entry point asks for
# the other two, and a trainer refuses it where no process group is up.
NOT_PORTED = [("checkpoint_per_step", 100), ("profile_steps", 5), ("nan_guard", True), ("eval_first", True),
              ("debug_nans", True), ("tensorboard", True), ("wandb", True), ("remote_url", "http://localhost:8000"),
              ("coordinator", "localhost:1234"), ("num_processes", 2), ("process_id", 0)]


@pytest.mark.parametrize("knob, value", NOT_PORTED, ids=[k for k, _ in NOT_PORTED])
def test_knobs_not_ported_raise(knob, value):
    from erc_tpu_torch.parallel import mesh
    from erc_tpu_torch.train import trainer as ttrainer

    assert not hasattr(ttrainer, "NOT_PORTED")
    if knob == "coordinator":  # the entry point's start_group wants the other two; a trainer wants a group up
        fam = FAMILIES["cogmen"]
        p = getattr(_import("erc_tpu_torch", fam.port_mod), f"{fam.port_cls}Params")()
        p.finalize([*fam.argv, *SMALL, f"--{knob}={value}"])
        with pytest.raises(ValueError, match="--num_processes and --process_id"):
            ttrainer.start_group(p)
        with pytest.raises(ValueError, match="none is up"):
            _cogmen(f"--{knob}={value}")
        assert not mesh.grouped()
        return
    assert _cogmen(f"--{knob}={value}").params.get(knob) == value
    assert not mesh.grouped()  # without a coordinator, one process


def test_knobs_at_their_defaults_build():
    trainer = _cogmen("--steps_per_call=1", "--eval_steps_per_call=0", "--nan_guard=false", "--remote_url=")
    assert trainer.params.steps_per_call == 1 and trainer.params.eval_steps_per_call == 0
