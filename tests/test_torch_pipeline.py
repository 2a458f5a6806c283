"""The port's loader pipeline and K steps a call ≡ the JAX trainer's, on the CPU.

- The loader wrappers (``MappedLoader`` with ``transfer_cast_fn``,
  ``GroupedLoader``, ``PrefetchLoader``, ``stack_batches``) over the same
  samples yield exactly the JAX package's items (the JAX bfloat16 cast as
  float32 values: numpy has no bfloat16, so the port keeps them float32),
  over two epochs, with a shape change and an epoch tail flushed as single
  batches; they forward ``len`` and ``set_epoch``.  ``PrefetchLoader``'s
  queue is bounded, an exception in its producer reaches the consumer, and
  a consumer that stops early joins the producer.
- One epoch at ``--steps_per_call=2`` (5 batches: two groups and a leftover
  single step) of COGMEN (hidden 16, L 16, batch 8, dropout 0) and of
  ``mmin_base`` (published widths, 16 audio frames, batch 8, dropout off)
  from the same weights in both packages, the JAX trainer on one device at
  matmul precision highest: the epoch's means within 1e-5 relative; COGMEN's
  parameters within 1e-5 absolute, but for the three biases whose exact
  gradient is 0 (``test_torch_cogmen_train.py``: Adam turns their rounding
  noise into lr-sized steps in both packages); MMIN's parameters and EMA
  shadow by ``test_torch_mmin_train.py``'s rule, each within 1e-5 of its
  norm or of the most that the steps move it (5 lr an element), since Adam
  magnifies the last digits of tiny gradients (one element of 393 216 in
  ``netL.conv3.weight`` lies 1.1e-5 off);
  the port at K = 2 against the port at K = 1: the same parameters bit for
  bit, and the same step count.
- ``--eval_steps_per_call=4`` (and ``--steps_per_call=4`` inherited by the
  test stage) gives the K = 1 test stage's predictions, NLL and record
  exactly, for COGMEN and for ``mmin_base``'s (raw, EMA) logit pair.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

from erc_tpu.data import loader as jloader
from erc_tpu.data.collate import ERCBatcher as JERCBatcher
from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu.models import cogmen as jcogmen
from erc_tpu.models import mmin_base as jmmin
from erc_tpu.parallel.mesh import make_mesh
from erc_tpu.train import trainer as jtrainer
from erc_tpu_torch import convert
from erc_tpu_torch.data import loader as tloader
from erc_tpu_torch.data.collate import ERCBatcher
from erc_tpu_torch.models import cogmen as tcogmen
from erc_tpu_torch.models import mmin_base as tmmin
from erc_tpu_torch.ops.dropout import Dropout
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
ZERO_GRAD = {f"gcn.conv2.lin_{n}.bias" for n in ("key", "value", "skip")}
COGMEN_ARGS = ["--dataset=synthetic-cogmen-6", "--hidden_size=16", "--max_seq_len=16", "--graph_impl=dense",
               "--train.batch_size=8", "--test.batch_size=6", "--drop_rate=0.0", "--eval_per_epoch=0", "--epoch=1",
               "--batch_count=5", "--confusion_matrix=false"]
MMIN_ARGS = ["--dataset=synthetic-mmin-4", "--max_audio_len=16", "--train.batch_size=8", "--test.batch_size=6",
             "--eval_per_epoch=0", "--epoch=1", "--batch_count=5", "--confusion_matrix=false"]


# ------------------------------------------------------------ loader wrappers
def _loaders(transfer):
    """The same wrapped loader in both packages: bucketed lengths (a shape
    change inside an epoch), K = 3 groups, the cast, prefetch."""
    samples = j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=40, min_len=3, max_len=30, seed=4)
    kw = dict(batch_size=4, shuffle=True, seed=5, sort_by_length=True, sort_chunk=8)
    out = []
    for pkg, batcher in ((jloader, JERCBatcher), (tloader, ERCBatcher)):
        loader = pkg.DialogueLoader(samples, batcher(bucket=16, max_len=48, pad_batch_to=4), **kw)
        cast = pkg.transfer_cast_fn(transfer)
        if cast is not None:
            loader = pkg.MappedLoader(loader, cast)
        out.append(pkg.PrefetchLoader(pkg.GroupedLoader(loader, 3), depth=2))
    return out


def _as_float32(v):
    return v if v is None or v.dtype.kind in "iub" or v.dtype == np.float32 else v.astype(np.float32)


@pytest.mark.parametrize("transfer", ["float32", "bfloat16"])
def test_loader_wrappers_yield_the_jax_items(transfer):
    jl, tl = _loaders(transfer)
    assert len(jl) == len(tl) == 10
    ks = []
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jitems, titems = list(jl), list(tl)
        assert len(jitems) == len(titems)
        for (jb, jk), (tb, tk) in zip(jitems, titems):
            assert jk == tk and jb.keys() == tb.keys()
            for key, v in jb.items():
                w = _as_float32(v)
                assert (w is None) == (tb[key] is None), key
                if w is not None:
                    assert w.dtype == tb[key].dtype and w.shape == tb[key].shape, key
                    np.testing.assert_array_equal(tb[key], w, err_msg=key)
        ks.append([k for _, k in titems])
    assert any(k == 3 for k in ks[0]) and any(k == 1 for k in ks[0])  # a group and flushed singles


def test_stack_batches_matches_jax():
    batches = [{"a": np.full((2, 3), i, np.float32), "b": None, "c": np.arange(4) + i} for i in range(3)]
    j, t = jloader.stack_batches(batches), tloader.stack_batches(batches)
    assert j.keys() == t.keys() and t["b"] is None
    for key in ("a", "c"):
        np.testing.assert_array_equal(t[key], j[key])
        assert t[key].shape[0] == 3


class _Slow:
    """A loader of `n` items that records how far its producer got."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.made, self.epoch = n, fail_at, 0, None

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise ValueError(f"collation failed at {i}")
            self.made += 1
            yield i


def test_prefetch_bounded_propagates_and_joins():
    src = _Slow(50)
    loader = tloader.PrefetchLoader(tloader.MappedLoader(src, lambda x: x), depth=2)
    loader.set_epoch(7)
    assert len(loader) == 50 and src.epoch == 7
    it = iter(loader)
    assert next(it) == 0
    time.sleep(0.3)
    assert src.made <= 4  # the queue holds 2, the producer one more in hand
    before = threading.active_count()
    it.close()  # stops early: the producer is unblocked and joined
    assert threading.active_count() <= before - 1
    with pytest.raises(ValueError, match="collation failed at 3"):
        list(tloader.PrefetchLoader(_Slow(10, fail_at=3)))
    assert list(tloader.PrefetchLoader(_Slow(5))) == list(range(5))


def test_grouped_loader_len_counts_steps():
    src = _Slow(7)
    grouped = tloader.GroupedLoader(tloader.MappedLoader(src, lambda i: {"x": np.zeros((2, 1 + i // 4))}), 2)
    grouped.set_epoch(3)
    items = list(grouped)
    assert len(grouped) == 7 and src.epoch == 3
    assert [k for _, k in items] == [2, 2, 2, 1]  # shapes 1 1 1 1 | 2 2 2: 1 1, 1 1, 2 2, then 2's tail
    assert items[0][0]["x"].shape == (2, 2, 1) and items[3][0]["x"].shape == (2, 2)
    # a group keeps its batches as the loader made them (the staging copies read them there, nothing stacked)
    batches = [{"x": np.full((2, 3), i, np.float32), "y": None} for i in range(2)]
    group = tloader.StackedGroup(batches)
    assert group.batches[1] is batches[1] and dict(group.items()).keys() == {"x", "y"} and group["y"] is None
    np.testing.assert_array_equal(group["x"], jloader.stack_batches(batches)["x"])


# ---------------------------------------------------------- K steps a call vs JAX
def _one_device(monkeypatch, tmp_path):
    monkeypatch.setenv("ERC_TPU_EXPROOT", str(tmp_path / "exp"))
    monkeypatch.setattr(jtrainer.meshlib, "make_mesh", lambda: make_mesh(devices=jax.devices()[:1]))


class _JCOGMEN(jcogmen.COGMENTrainer):
    def on_train_epoch_end(self, eidx, record):
        self.epoch_means = record.agg()


class _JMMIN(jmmin.MMINBaseTrainer):
    """At dropout off (its modules' rates are fixed), on the port's first 5 batches."""

    def loss_and_metrics(self, variables, batch, rng, train: bool):
        return super().loss_and_metrics(variables, batch, rng, train=False)

    def make_loader(self, split):
        loader = super().make_loader(split)
        loader.batch_count = 5 if split == "train" else None
        return loader

    def on_train_epoch_end(self, eidx, record):
        self.epoch_means = record.agg()


FAMILIES = {
    "cogmen": (jcogmen.COGMENParams, _JCOGMEN, tcogmen.COGMENParams, tcogmen.COGMENTrainer, COGMEN_ARGS),
    "mmin_base": (jmmin.MMINBaseParams, _JMMIN, tmmin.MMINBaseParams, tmmin.MMINBaseTrainer, MMIN_ARGS),
}


def _jax_epoch(name, spc):
    """The JAX trainer's epoch at `spc`: (initial weights as a port state dict, epoch means, final weights, EMA)."""
    jp_cls, jt_cls, _, _, args = FAMILIES[name]
    p = jp_cls()
    p.from_args([*args, f"--steps_per_call={spc}", "--heartbeat=false", "--matmul_precision=highest"])
    p.iparams()
    prec = jax.config.jax_default_matmul_precision
    try:
        tr = jt_cls(p)
        tr.initialize()
        start = _port_state(name, tr.state.params, tr.state.model_state)
        tr.train()
    finally:
        jax.config.update("jax_default_matmul_precision", prec)
    ema = getattr(tr.state, "ema_params", None)
    return (start, tr.epoch_means, _port_state(name, tr.state.params, tr.state.model_state),
            None if ema is None else _port_state(name, ema, tr.state.model_state), tr.global_steps)


def _port_state(name, params, model_state):
    tree = {"params": jax.tree_util.tree_map(np.asarray, params),
            **jax.tree_util.tree_map(np.asarray, dict(model_state))}
    return convert.STATES[name](tree)


def _port_trainer(name, *extra):
    _, _, tp_cls, tt_cls, args = FAMILIES[name]
    p = tp_cls()
    p.finalize([*args, "--device=cpu", *extra])
    trainer = tt_cls(p)
    trainer.log = lambda msg: None
    trainer.initialize()
    for m in trainer.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return trainer


def _port_epoch(name, start, *extra):
    trainer = _port_trainer(name, *extra)
    trainer.model.load_state_dict(start)
    if getattr(trainer, "ema_model", None) is not None:
        trainer.sync_ema()
    return trainer, trainer.train()[-1]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_steps_per_call_epoch_matches_jax(name, monkeypatch, tmp_path):
    _one_device(monkeypatch, tmp_path)
    start, jmeans, jfinal, jema, jsteps = _jax_epoch(name, 2)
    trainer, rec = _port_epoch(name, start, "--steps_per_call=2")
    assert rec["steps"] == trainer.global_steps == jsteps == 5
    for key in ("Lall", "Acc", "gnorm"):
        np.testing.assert_allclose(rec[key], float(jmeans[key]), rtol=TOL, err_msg=key)
    models = [(trainer.model, jfinal)]
    if jema is not None:
        models.append((trainer.ema_model, jema))
    lr = float(trainer.params.optim.lr)
    for model, want in models:
        for n, t in model.named_parameters():
            got, w = t.detach().double().numpy(), want[n].double().numpy()
            if name == "cogmen" and n not in ZERO_GRAD:
                np.testing.assert_allclose(got, w, rtol=0, atol=TOL, err_msg=n)
            elif name != "cogmen":
                tol = TOL * max(np.linalg.norm(w), 5 * lr * np.sqrt(w.size))
                assert np.linalg.norm(got - w) <= tol, (n, np.linalg.norm(got - w), tol)
    # K = 2 against K = 1 in the port: the same five steps, bit for bit
    single, rec1 = _port_epoch(name, start, "--steps_per_call=1")
    assert rec1["steps"] == single.global_steps == 5
    for (n, a), (_, b) in zip(trainer.model.named_parameters(), single.model.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("name", list(FAMILIES))
def test_eval_steps_per_call_matches_single_batches(name):
    runs = {}
    for label, extra in (("K1", ()), ("eval K4", ("--eval_steps_per_call=4",)), ("K4", ("--steps_per_call=4",))):
        trainer = _port_trainer(name, *extra)  # the same seeded weights
        runs[label] = (trainer, trainer.test())
    t1, r1 = runs["K1"]
    assert len(list(t1.make_loader("test"))) > 4  # a group of 4 and leftover single batches
    for label in ("eval K4", "K4"):
        tk, rk = runs[label]
        assert tk._true == t1._true and tk._pred == t1._pred and tk._nll_sum == t1._nll_sum, label
        assert rk.keys() == r1.keys()
        for key, v in r1.items():
            np.testing.assert_array_equal(np.asarray(rk[key]), np.asarray(v), err_msg=f"{label} {key}")
