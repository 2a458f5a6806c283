"""The metric readers on made-up spans and traces: busy time as the union
of device intervals, idle shares, the breakdown, rates and spans, and
nothing where there is nothing to read."""

import math

import pytest

from perfbench.core import manifest
from perfbench.core.context import Run
from perfbench.core.trace import Span, Trace

def _run(traffic="lognormal-120"):
    c = {"name": "dagerc-iemocap." + traffic, "config": "dagerc-iemocap", "traffic": traffic, "chips": 1}
    return Run(cell=c, cfg=manifest.config(c["config"]), mix=manifest.mix(c["traffic"]), seed=1, seconds=1.0,
               traced=True, device="cpu", work=manifest.work(c["config"]))


def test_busy_is_the_union_of_intervals():
    t = Trace([("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 20.0, 30.0)], [], (0.0, 40.0))
    assert t.busy_s() == pytest.approx(25e-6)
    assert t.busy_s(8.0, 22.0) == pytest.approx(9e-6)
    r = _run()
    r.trace = t
    assert manifest.metric_reader("device_idle_pct.train").read(r) == pytest.approx(100 * 15 / 40)


def test_breakdown_names_the_host_span_of_each_gap():
    t = Trace([("k1", 0.0, 10.0), ("k1", 30.0, 40.0), ("k2", 40.0, 45.0)],
              [("segment", 0.0, 100.0), ("loader.next", 10.0, 30.0), ("train_batch", 30.0, 60.0)], (0.0, 100.0))
    b = t.breakdown()
    assert b["device_ops"] == [["k1", pytest.approx(20e-6)], ["k2", pytest.approx(5e-6)]]
    assert dict((k, v) for k, v in b["idle_gaps"]) == {"loader.next": pytest.approx(20e-6),
                                                       "train_batch": pytest.approx(55e-6)}


def test_rates_and_spans():
    r = _run()
    r.window = {"start": 1.0, "end": 3.0, "dialogues": 500, "steps": 40, "trained": []}
    assert manifest.metric_reader("train_dia_per_s").read(r) == 250.0
    r.spans.spans += [Span("loader.next", 1.0, 1.002), Span("loader.next", 2.0, 2.004), Span("loader.next", 5.0, 6.0),
                      Span("setup.warmup", 0.0, 0.5)]
    assert manifest.metric_reader("loader_wait_ms.train").read(r) == pytest.approx(3.0)
    assert manifest.metric_reader("warmup_s").read(r) == pytest.approx(0.5)


def test_device_metrics_read_nothing_without_a_trace():
    r = _run()
    for name in ("device_idle_pct.train", "dag_block_roofline.train"):
        assert manifest.metric_reader(name).read(r) is None


def test_mfu_counts_the_window_s_model_flops():
    r = _run()
    r.data = [{"speakers": [[1, 0], [0, 1], [1, 0]], "label": [0, 1, 2]}]
    r.window = {"start": 0.0, "end": 1.0, "trained": [2]}
    want = 100 * 2 * 3 * r.work.forward_flops([0, 1, 0], r.model) / 67e12
    assert manifest.metric_reader("train_mfu_pct").read(r) == pytest.approx(want)
    assert not math.isnan(want)
