"""The port's spans (``erc_tpu_torch/core/tracing.py``) on the CPU.

- Off (no profiler records): ``span`` returns the shared ``OFF``, reads no
  clock, makes no span and no range, records nothing and keeps nothing.
- Under a CPU ``torch.profiler``: nested spans record their name, parent,
  step, thread and attributes, close on an exception, and show as ``erc.*``
  ranges in ``prof.events()``; spans of many threads keep their parents on
  their own thread.
- ``PrefetchLoader``: one ``loader.get`` an item (and one marked ``end``),
  ``empty`` behind a sleeping loader and not behind a slow consumer, and
  ``loader.collate`` spans on the producer's thread.
- A CPU ``Trainer.train_batch`` gives one ``step`` span carrying its
  ``global_steps``; the ``--profile_steps`` Chrome trace holds the
  ``erc.step`` ranges; an epoch's ``seconds`` include the wait for the
  device at ``record.agg()``.
"""

import json
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from erc_tpu_torch.core import tracing
from erc_tpu_torch.data.loader import PrefetchLoader
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_returns_the_shared_no_op_and_records_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("touched outside a profiler")

    t0 = time.perf_counter()
    with monkeypatch.context() as m:
        m.setattr(time, "perf_counter", refuse)
        m.setattr(tracing, "Span", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        for attrs in ({}, {"step": 3, "k": 1}):
            sp = tracing.span("step", **attrs)
            assert sp is tracing.OFF and not sp
            with sp as entered:
                assert entered is tracing.OFF
    assert tracing.spans(t0) == []


@pytest.mark.parametrize("attrs", [{}, {"step": 3, "k": 1}], ids=["bare", "attributes"])
def test_off_keeps_nothing(attrs):
    span = tracing.span

    def loop(n):
        for _ in range(n):
            with span("step", **attrs):
                pass

    loop(10)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        loop(10_000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, tracing.__file__)]
    grown = [s for s in after.filter_traces(mine).compare_to(before.filter_traces(mine), "lineno") if s.size_diff]
    assert grown == []


def test_nested_spans_record_parent_step_and_attributes_and_show_as_ranges():
    t0 = time.perf_counter()
    with _profiled() as prof:
        with tracing.span("step", step=7, k=1) as outer:
            assert outer
            with tracing.span("step.stage", rows=64) as inner:
                torch.ones(8).add_(1)
            with tracing.span("step.launch"):
                pass
        with pytest.raises(ValueError):
            with tracing.span("graphs.capture", bucket=(0, ())):
                raise ValueError("in a span")
        with tracing.span("loader.get") as after:
            pass
    got = tracing.spans(t0)
    assert [s.name for s in got] == ["step.stage", "step.launch", "step", "graphs.capture", "loader.get"]
    stage, launch, step, capture, get = got
    assert step is outer and stage is inner and get is after
    assert stage.parent is step and launch.parent is step and step.parent is None
    assert capture.parent is None and get.parent is None  # the raise closed the capture's span
    assert stage.step == launch.step == step.step == 7 and get.step is None
    assert stage.attrs == {"rows": 64} and step.attrs == {"step": 7, "k": 1} and capture.attrs == {"bucket": (0, ())}
    assert {s.thread for s in got} == {threading.get_ident()}
    assert step.start <= stage.start <= stage.end <= launch.start <= launch.end <= step.end
    assert tracing.spans(t0, step.end) == [stage, launch, step]
    ranges = [e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    assert sorted(ranges) == sorted(tracing.PREFIX + s.name for s in got)


def test_spans_of_many_threads_keep_their_parents():
    threads, depth = 16, 50
    t0 = time.perf_counter()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    together = threading.Barrier(threads)  # all alive at once: no thread id is reused
    try:
        def work(i):
            together.wait(timeout=60)
            for j in range(depth):
                with tracing.span("outer", step=i):
                    with tracing.span("inner", j=j):
                        pass

        with _profiled():
            ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in ts)
    got = tracing.spans(t0)
    inner = [s for s in got if s.name == "inner"]
    assert len(inner) == threads * depth and sum(s.name == "outer" for s in got) == threads * depth
    for s in inner:
        assert s.parent.name == "outer" and s.parent.thread == s.thread and s.step == s.parent.step
        assert s.parent.start <= s.start <= s.end <= s.parent.end
    assert len({s.thread for s in inner}) == threads


class _Sleepy:
    """A loader of ``n`` items, sleeping ``pause`` seconds before each."""

    def __init__(self, n, pause):
        self.n, self.pause = n, pause

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        for i in range(self.n):
            time.sleep(self.pause)
            yield {"i": np.array([i])}


def _prefetched(loader, consumer_pause):
    t0 = time.perf_counter()
    items = []
    with _profiled():
        for item in PrefetchLoader(loader, depth=2):
            items.append(int(item["i"][0]))
            time.sleep(consumer_pause)
    got = tracing.spans(t0)
    return items, [s for s in got if s.name == "loader.get"], [s for s in got if s.name == "loader.collate"]


def test_prefetch_gets_are_empty_behind_a_sleeping_loader():
    items, gets, collates = _prefetched(_Sleepy(5, 0.1), consumer_pause=0.0)
    assert items == list(range(5))
    assert len(gets) == 6 and [g.attrs.get("end", False) for g in gets] == [False] * 5 + [True]
    assert all(g.attrs["empty"] for g in gets[:5])
    assert all(g.seconds > 0.05 for g in gets[:5])  # each waited on the producer's sleep
    main = threading.get_ident()
    assert all(g.thread == main for g in gets)
    assert len(collates) == 6 and [c.attrs.get("end", False) for c in collates] == [False] * 5 + [True]
    assert len({c.thread for c in collates}) == 1 and collates[0].thread != main
    assert all(c.seconds > 0.09 for c in collates[:5]) and all(c.parent is None for c in collates)


def test_prefetch_gets_are_not_empty_behind_a_slow_consumer():
    items, gets, collates = _prefetched(_Sleepy(6, 0.0), consumer_pause=0.1)
    assert items == list(range(6))
    assert len(gets) == 7 and sum(bool(g.attrs.get("end")) for g in gets) == 1
    assert not any(g.attrs["empty"] for g in gets[1:])  # the producer filled the queue while the consumer slept
    assert len(collates) == 7 and collates[0].thread != threading.get_ident()


def test_prefetch_off_records_nothing():
    t0 = time.perf_counter()
    assert [int(b["i"][0]) for b in PrefetchLoader(_Sleepy(3, 0.0))] == [0, 1, 2]
    assert tracing.spans(t0) == []


# ------------------------------------------------------------------ the trainer
ARGS = ["--dataset=synthetic-cogmen-6", "--hidden_size=16", "--graph_impl=dense", "--max_seq_len=16",
        "--train.batch_size=8", "--test.batch_size=8", "--epoch=1", "--batch_count=2", "--eval_per_epoch=0",
        "--confusion_matrix=false", "--device=cpu", "--heartbeat=false"]


def _trainer(*extra):
    from erc_tpu_torch.models.cogmen import COGMENParams, COGMENTrainer

    p = COGMENParams()
    p.finalize([*ARGS, *extra])
    tr = COGMENTrainer(p)
    tr.log = lambda msg: None
    return tr


def test_train_batch_gives_one_step_span_with_its_global_steps():
    tr = _trainer()
    tr.initialize()
    batch = next(iter(tr.make_loader("train")))
    tr.train_batch(batch)  # outside a profiler: nothing recorded
    t0 = time.perf_counter()
    with _profiled() as prof:
        tr.train_batch(batch)
        tr.train_batch(batch)
    steps = [s for s in tracing.spans(t0) if s.name == "step"]
    assert [(s.step, s.attrs["k"]) for s in steps] == [(1, 1), (2, 1)] and tr.global_steps == 3
    assert sum(e.name == tracing.PREFIX + "step" for e in prof.events()) == 2


def test_profile_steps_trace_holds_the_step_ranges_and_loader_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("ERC_TPU_EXPROOT", str(tmp_path))
    tr = _trainer("--profile_steps=2", "--batch_count=3")
    t0 = time.perf_counter()
    tr.train()
    got = tracing.spans(t0)
    assert [s.step for s in got if s.name == "step"] == [0, 1]
    gets = [s for s in got if s.name == "loader.get"]
    assert len(gets) == 2 and not any(g.attrs.get("end") for g in gets)
    trace = json.load(open(tmp_path / "blob" / tr.exp.exp_name / tr.exp.test_name / "profile" / "trace.pt.trace.json"))
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count(tracing.PREFIX + "step") == 2 and names.count(tracing.PREFIX + "loader.get") == 2


def test_epoch_seconds_count_the_wait_for_the_device(monkeypatch):
    """``record.agg()`` waits for the device: an epoch's seconds (and its
    dia/s) take it in.  A stub ``agg`` that sleeps stands in for the wait."""
    from erc_tpu_torch.core import meter

    agg = meter.Record.agg

    def slow_agg(self):
        time.sleep(0.3)
        return agg(self)

    monkeypatch.setattr(meter.Record, "agg", slow_agg)
    tr = _trainer()
    (epoch,) = tr.train()
    assert epoch["seconds"] >= 0.3 and epoch["steps"] == 2
