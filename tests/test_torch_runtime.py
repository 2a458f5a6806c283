"""The port's runtime around the train loop ≡ the JAX package's, on the CPU.

- ``Params``: ``hash``, ``resume_hash``, ``to_json`` and ``to_yaml`` of the
  same dicts give the JAX package's strings byte for byte (hypothesis over
  small nested dicts, run-control keys among them); ``Arange`` raises where
  the JAX one raises, at declaration and at assignment.
- ``Meter``/``Record``: every aggregation of the same stream gives the JAX
  result exactly, for numpy values and for tensors (against JAX arrays); a
  stream of tensors is read back only at ``agg()``.
- ``BestMetrics``, ``MetricBoard`` and ``PredictionStore`` given the same
  calls write byte-identical files; ``Logger`` writes the same lines but
  for the timestamp, to a file of the same name pattern.
- The slice as a whole: the same tiny COGMEN (dense graph, hidden 16, L 16,
  batch 8, dropout 0) trains 2 epochs of 2 batches with a test stage each in
  the JAX ``Trainer`` (one device, matmul precision highest) and in the
  port's, from the JAX weights converted (``convert.py``): the two run
  directories hold the same files (the log's time stamp aside),
  ``metrics.json`` has the same keys and values within 1e-5, ``board.jsonl``
  the same (stage, step, keys) rows with values within 1e-5 (but ``dps``, a
  wall-clock rate), and ``analyse.collect_metrics`` the same columns over
  both roots.
- ``--profile_steps=2`` writes a Chrome trace of the steps' operations with
  its window in the trace's metadata; ``--debug_nans`` raises
  ``FloatingPointError`` naming the module on a NaN input and on a NaN
  gradient, and leaves a finite run's losses as they are; the CPU has no
  allocator statistics (``device_memory_stats`` is None, as in JAX).
- ``erc_tpu_torch`` and ``chip_smoke.py`` import no JAX, flax, optax or
  ``erc_tpu`` module (their import statements, read with ``ast``).
"""

import ast
import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from erc_tpu.core import logger as jlogger
from erc_tpu.core import meter as jmeter
from erc_tpu.core import metrics_db as jdb
from erc_tpu.core import params as jparams
from erc_tpu.models import cogmen as jcogmen
from erc_tpu.parallel.mesh import make_mesh
from erc_tpu.train import trainer as jtrainer
from erc_tpu_torch import analyse, convert
from erc_tpu_torch.core import logger as tlogger
from erc_tpu_torch.core import memstat
from erc_tpu_torch.core import meter as tmeter
from erc_tpu_torch.core import metrics_db as tdb
from erc_tpu_torch.core import params as tparams
from erc_tpu_torch.models import cogmen as tcogmen
from erc_tpu_torch.train.trainer import nan_checks
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
ARGS = ["--dataset=synthetic-cogmen-6", "--hidden_size=16", "--max_seq_len=16", "--graph_impl=dense",
        "--train.batch_size=8", "--test.batch_size=8", "--drop_rate=0.0", "--epoch=2", "--batch_count=2",
        "--confusion_matrix=false", "--heartbeat=false"]


# ------------------------------------------------------------------ Params
_KEYS = st.sampled_from(["a", "b", "lr", "seed", "epoch", "resume", "device", "steps_per_call", "dataset",
                         "coordinator", "optim", "batch_count"])
_LEAF = st.one_of(st.none(), st.booleans(), st.integers(-10 ** 6, 10 ** 6),
                  st.floats(allow_nan=False, allow_infinity=False, width=32), st.text("abc-_ xyz", max_size=6),
                  st.lists(st.integers(-5, 5), max_size=3))
_TREE = st.dictionaries(_KEYS, st.one_of(_LEAF, st.dictionaries(_KEYS, _LEAF, max_size=3)), max_size=6)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_TREE)
def test_params_hashes_and_dumps_match_jax(d):
    j, t = jparams.Params().from_dict(d), tparams.Params().from_dict(d)
    assert t.to_dict() == j.to_dict()
    assert t.hash() == j.hash() and t.resume_hash() == j.resume_hash()
    assert t.to_json() == j.to_json() and t.to_yaml() == j.to_yaml()


_NUM = st.one_of(st.integers(-100, 100), st.floats(-100, 100, allow_nan=False))


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


@settings(max_examples=60, deadline=None)
@given(_NUM, _NUM, _NUM, _NUM)
def test_arange_raises_where_jax_raises(default, lo, hi, later):
    declared = _raises(lambda: jparams.Params().arange(default, lo, hi))
    assert _raises(lambda: tparams.Params().arange(default, lo, hi)) == declared
    if declared:
        return

    def assign(m):
        p = m.Params()
        p.x = p.arange(default, lo, hi)
        p.x = later
        return p.x

    assert _raises(lambda: assign(tparams)) == _raises(lambda: assign(jparams))


# ------------------------------------------------------------------ Meter and Record
AGGS = ("mean", "sum", "last", "max", "min", "smean")


def _stream(make_value):
    r = np.random.default_rng(3)
    out = []
    for i in range(12):
        m = {}
        for agg in AGGS:
            m[agg] = (agg, make_value(np.float32(r.normal())))
        m["count"] = ("sum", i)
        out.append(m)
    return out


def _fold(mod, stream):
    rec = mod.Record("train")
    for step in stream:
        meter = mod.Meter()
        for key, (agg, v) in step.items():
            setattr(getattr(meter, agg), key, v)
        rec.record(meter)
    return rec.agg()


@pytest.mark.parametrize("kind", ["numpy", "device"])
def test_record_aggregations_match_jax(kind):
    if kind == "numpy":
        j = _fold(jmeter, _stream(lambda v: v))
        t = _fold(tmeter, _stream(lambda v: v))
    else:
        j = _fold(jmeter, _stream(lambda v: jnp.asarray(v)))
        t = _fold(tmeter, _stream(lambda v: torch.tensor(v)))
    assert j.keys() == t.keys()
    for key in j:
        assert t[key] == j[key] and type(t[key]) is type(j[key]), (key, t[key], j[key])
    m = tmeter.Meter()
    m.mean.Lall = 1.0
    m.max.acc = torch.tensor(2.0)
    assert m.todict() == {"Lall": 1.0, "acc": 2.0} and "Lall" in m and str(m) == "Lall=1 | acc=2"


def test_tensor_stream_is_read_back_at_agg_only(monkeypatch):
    reads = []
    for name in ("numpy", "item", "tolist", "__float__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, _o=orig, _n=name: (reads.append(_n), _o(self, *a))[1])
    rec = tmeter.Record()
    for i in range(5):
        m = tmeter.Meter()
        m.mean.Lall = torch.tensor(float(i))
        m.max.top = torch.tensor(float(-i))
        rec.record(m)
    assert reads == [] and isinstance(rec._items["Lall"].acc, torch.Tensor)
    assert rec.agg() == {"Lall": 2.0, "top": 0.0} and reads


# ------------------------------------------------------------------ stores and logger
def _store_calls(db):
    """The same calls on either package's module (numpy values)."""
    def run(root):
        best = db.BestMetrics(os.path.join(root, "metrics.json"))
        board = db.MetricBoard(os.path.join(root, "board.jsonl"))
        preds = db.PredictionStore(os.path.join(root, "predictions.jsonl"))
        r = np.random.default_rng(0)
        for step in range(3):
            f1 = float(r.random())
            with best:
                best.update_metric_pair("f1", f1, "cls_f1", r.random(3))
                best.update_metrics({"acc": np.float64(r.random()), "wa": np.float32(0.5)}, compare="max")
                best.update_metric("loss", float(r.random()), compare="min")
            board.append({"Lall": np.float32(r.random()), "cm": np.arange(4).reshape(2, 2), "f1": f1}, step=step,
                         stage="test")
            board.flush()
            preds.append([[1, 2, 3], np.array([1, 0, 3])])
            preds.flush()
        silent = db.BestMetrics(os.path.join(root, "silent.json"), write=False)
        silent.update_metric("f1", 1.0)
        silent.flush()
    return run


def test_metric_stores_write_the_jax_files(tmp_path):
    for name, db in (("jax", jdb), ("torch", tdb)):
        os.makedirs(tmp_path / name)
        _store_calls(db)(str(tmp_path / name))
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax")) == [
        "board.jsonl", "metrics.json", "predictions.jsonl"]
    for f in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert tdb.MetricBoard.load(str(tmp_path / "torch" / "board.jsonl")) == jdb.MetricBoard.load(
        str(tmp_path / "jax" / "board.jsonl"))
    # a tensor is written as its value
    board = tdb.MetricBoard(str(tmp_path / "t.jsonl"))
    board.append({"Lall": torch.tensor(0.25), "cm": torch.arange(4).reshape(2, 2)}, step=0)
    board.flush()
    assert json.loads((tmp_path / "t.jsonl").read_text()) == {"step": 0, "stage": "train", "Lall": 0.25,
                                                             "cm": [[0, 1], [2, 3]]}


_STAMP = re.compile(r"^\[\d\d:\d\d:\d\d\] ", re.M)


def test_logger_lines_match_jax(tmp_path):
    lines = []
    for name, mod in (("jax", jlogger), ("torch", tlogger)):
        log = mod.Logger()
        before = list(log._files)
        fname = log.add_log_dir(str(tmp_path / name))
        assert re.fullmatch(r"log\.\d{6}-\d{6}\.0\.txt", os.path.basename(fname))
        log.info("epoch 0:", 1.5)
        log.inline("e0 b0 Lall=1")
        log.newline()
        log.warn("careful")
        log.debug("not shown at info level")
        log.raw([[1, 2], [3, 4]])
        if name == "jax":  # the JAX logger has no remove: take its file back by hand
            f = log._files.pop(len(before))
            f.close()
        else:
            log.remove_log_file(fname)
        assert list(log._files) == before
        lines.append(_STAMP.sub("", Path(fname).read_text()))
    assert lines[1] == lines[0] and lines[0].count("\n") == 4


# ------------------------------------------------------------------ the slice as a whole
def _port_state(params, model_state):
    tree = {"params": jax.tree_util.tree_map(np.asarray, params),
            **jax.tree_util.tree_map(np.asarray, dict(model_state))}
    return convert.STATES["cogmen"](tree)


def _files(root):
    """Relative names of the files under one run's two directories (the log's stamp as <stamp>)."""
    out = set()
    for kind in ("experiment", "blob"):
        (exp,) = os.listdir(os.path.join(root, kind))
        (test,) = os.listdir(os.path.join(root, kind, exp))
        base = os.path.join(root, kind, exp, test)
        for dirpath, _, names in os.walk(base):
            for n in names:
                rel = os.path.relpath(os.path.join(dirpath, n), base)
                out.add(f"{kind}/" + re.sub(r"log\.\d{6}-\d{6}\.", "log.<stamp>.", rel))
    return out


def _close(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _close(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, float, int)) and not isinstance(a, bool):
        np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64), rtol=TOL, atol=TOL,
                                   err_msg=what)
    else:
        assert a == b, what


def test_run_layout_metrics_and_board_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jtrainer.meshlib, "make_mesh", lambda: make_mesh(devices=jax.devices()[:1]))
    roots = {"jax": str(tmp_path / "jax"), "torch": str(tmp_path / "torch")}
    monkeypatch.setenv("ERC_TPU_EXPROOT", roots["jax"])
    p = jcogmen.COGMENParams()
    p.from_args([*ARGS, "--matmul_precision=highest"])
    p.iparams()
    prec = jax.config.jax_default_matmul_precision
    try:
        jt = jcogmen.COGMENTrainer(p)
        jt.initialize()
        start = _port_state(jt.state.params, jt.state.model_state)
        jt.train()
    finally:
        jax.config.update("jax_default_matmul_precision", prec)
    monkeypatch.setenv("ERC_TPU_EXPROOT", roots["torch"])
    tp = tcogmen.COGMENParams()
    tp.finalize([*ARGS, "--device=cpu"])
    tt = tcogmen.COGMENTrainer(tp)
    tt.log = lambda msg: None
    tt.initialize()
    tt.model.load_state_dict(start)
    tt.train()
    assert tt.exp.exp_name == "erc_tpu_torch.COGMENTrainer" and jt.exp.exp_name == "erc_tpu.COGMENTrainer"
    assert _files(roots["torch"]) == _files(roots["jax"])
    assert {"experiment/metrics.json", "experiment/board.jsonl", "experiment/report.json",
            "blob/saver/model.best.ckpt", "blob/predictions.jsonl"} <= _files(roots["torch"])
    _close(json.load(open(jt.exp.test_file("metrics.json"))), json.load(open(tt.exp.test_file("metrics.json"))),
           "metrics.json")
    jrows = [json.loads(line) for line in open(jt.exp.test_file("board.jsonl"))]
    trows = [json.loads(line) for line in open(tt.exp.test_file("board.jsonl"))]
    assert [(r["stage"], r["step"], sorted(r)) for r in trows] == [(r["stage"], r["step"], sorted(r)) for r in jrows]
    for jr, tr in zip(jrows, trows):
        jr.pop("dps", None)
        tr.pop("dps", None)
        _close(jr, tr, f"board {jr['stage']} {jr['step']}")
    cols = [{k for row in analyse.collect_metrics(root=root) for k in row} for root in roots.values()]
    assert cols[0] == cols[1] and {"f1", "acc", "dataset", "seed"} <= cols[1]
    initial = tt.exp.load_info("initial")
    assert {"torch", "numpy", "python"} <= set(initial["versions"]) and "jax" not in initial["versions"]


# ------------------------------------------------------------------ profiler, debug_nans, memstat
def _port_trainer(tmp_path, monkeypatch, *extra):
    monkeypatch.setenv("ERC_TPU_EXPROOT", str(tmp_path))
    p = tcogmen.COGMENParams()
    p.finalize([*ARGS, "--device=cpu", "--epoch=1", "--eval_per_epoch=0", *extra])
    tr = tcogmen.COGMENTrainer(p)
    tr.log = lambda msg: None
    return tr


def test_profile_steps_writes_a_chrome_trace(tmp_path, monkeypatch):
    tr = _port_trainer(tmp_path, monkeypatch, "--profile_steps=2", "--batch_count=3")
    tr.train()
    trace = json.load(open(os.path.join(tr.exp.blob_dir, "profile", "trace.pt.trace.json")))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"aten::addmm", "aten::mm"} & names and "Optimizer.step#Adam.step" in names
    steps = [e for e in trace["traceEvents"] if e.get("name") == "Optimizer.step#Adam.step"]
    assert len(steps) == 2  # the first 2 of 3 steps
    assert trace["erc_tpu_torch.window"] == {"first_step": 0, "steps": 2, "epoch": 0, "steps_per_call": 1}


def test_debug_nans(tmp_path, monkeypatch):
    plain = _port_trainer(tmp_path, monkeypatch)
    checked = _port_trainer(tmp_path, monkeypatch, "--debug_nans=true")
    assert not checked.train_graphs
    a, b = plain.train(), checked.train()
    assert [r["Lall"] for r in a] == [r["Lall"] for r in b]
    for x, y in zip(plain.model.parameters(), checked.model.parameters()):
        assert torch.equal(x, y)
    from erc_tpu_torch.data.loader import to_device

    batch = to_device(next(iter(checked.make_loader("train"))), checked.device)
    batch["input_tensor"][0, 1, 3] = float("nan")
    with pytest.raises(FloatingPointError, match="module 'transformer_out'"):
        checked.train_step(batch)
    # a NaN that arises in the backward alone: d sqrt(x - x) at 0
    model = torch.nn.Sequential(torch.nn.Linear(3, 3), _SqrtOfZero())
    with pytest.raises(FloatingPointError, match="module '0'"):
        with nan_checks(model), torch.enable_grad():  # other test files turn grad mode off at import
            model(torch.ones(2, 3)).sum().backward()


class _SqrtOfZero(torch.nn.Module):
    def forward(self, x):
        return torch.sqrt(x - x)


def test_device_memory_stats_on_the_cpu():
    assert memstat.device_memory_stats("cpu") is None
    report = memstat.memory_report()
    assert report.startswith("cpu: no allocator stats") or "cuda" in report


# ------------------------------------------------------------------ no JAX in the port
def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "erc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 60
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "erc_tpu")]
    assert bad == []
