"""The readers of the program's spans (``erc_tpu_torch/core/tracing.py``)
on a hand-made run: the benchmark's ``segment`` span and the spans the
program recorded in the segment.  Nothing where the program recorded none,
or has no tracer (as before the spans existed)."""

import sys

import pytest

from perfbench.core import manifest
from perfbench.core.context import Run
from perfbench.core.trace import Span

READERS = ("loader_empty_pct.train", "collate_ms.train")
SEG = (100.0, 100.01)  # the segment on the host clock, s


def _run():
    c = {"name": "dagerc-iemocap.lognormal-120", "config": "dagerc-iemocap", "traffic": "lognormal-120", "chips": 1}
    r = Run(cell=c, cfg=manifest.config(c["config"]), mix=manifest.mix(c["traffic"]), seed=1, seconds=1.0,
            traced=True, device="cpu", work=manifest.work(c["config"]))
    r.spans.spans.append(Span("segment", *SEG))
    return r


def _program(monkeypatch, made):
    from erc_tpu_torch.core import tracing

    monkeypatch.setattr(tracing, "spans", lambda since=float("-inf"), until=float("inf"):
                        [s for s in made if s.start >= since and s.end <= until])


def _sp(name, start_ms, end_ms, **attrs):
    """A program span at ``start_ms``-``end_ms`` into the segment."""
    from erc_tpu_torch.core import tracing

    s = tracing.Span(name, attrs)
    s.start, s.end = SEG[0] + start_ms / 1e3, SEG[0] + end_ms / 1e3
    s.parent, s.thread, s.step = None, 1, None
    return s


def _epoch():
    """Two items and the loader's end: the first get finds the queue empty,
    the second does not; the end's get and collate are no item's."""
    return [
        _sp("loader.get", 0.0, 0.4, empty=True), _sp("loader.get", 4.6, 4.7, empty=False),
        _sp("loader.get", 9.6, 9.7, empty=True, end=True),
        _sp("loader.collate", 0.1, 0.3), _sp("loader.collate", 4.7, 5.3), _sp("loader.collate", 5.4, 5.5, end=True),
        _sp("loader.get", 99.0, 99.5, empty=True), _sp("loader.collate", 98.0, 99.0),  # after the segment
    ]


def _read(r, name):
    return manifest.metric_reader(name).read(r)


def test_readers_on_an_epoch(monkeypatch):
    _program(monkeypatch, _epoch())
    r = _run()
    assert _read(r, "loader_empty_pct.train") == pytest.approx(50.0)
    assert _read(r, "collate_ms.train") == pytest.approx((0.2 + 0.6) / 2)


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_spans(monkeypatch, name):
    _program(monkeypatch, [])
    assert _read(_run(), name) is None
    _program(monkeypatch, _epoch())
    r = _run()
    r.spans.spans.clear()  # no segment
    assert _read(r, name) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_from_a_program_without_a_tracer(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "erc_tpu_torch.core.tracing", None)  # its import raises ImportError
    import erc_tpu_torch.core

    monkeypatch.delattr(erc_tpu_torch.core, "tracing", raising=False)
    assert _read(_run(), name) is None
