"""The trainer's thread waiting on its loader pipeline (``DialogueLoader`` →
``PrefetchLoader``, collation by ``ERCBatcher``): the benchmark's span around
each ``next()`` in the window, the mean a step, in ms."""


def read(r):
    w = r.window
    spans = r.spans.named("loader.next", w["start"], w["end"])
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None
