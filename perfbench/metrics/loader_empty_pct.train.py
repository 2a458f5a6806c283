"""The trainer's gets from the prefetch loader (``data/loader.py``,
``PrefetchLoader``) that found its queue empty, so that the step waited on
the producer thread: the program's ``loader.get`` spans with ``empty`` over
all its ``loader.get`` spans of an item in the traced segment, in %.  Each
epoch's first get waits on a new producer thread.  Nothing where the
program records no spans."""


def read(r):
    seg = r.spans.named("segment")
    if not seg:
        return None
    try:
        from erc_tpu_torch.core import tracing
    except ImportError:  # a program without spans
        return None
    gets = [s for s in tracing.spans(seg[0].start, seg[0].end) if s.name == "loader.get" and not s.attrs.get("end")]
    if not gets:
        return None
    return 100.0 * sum(bool(s.attrs.get("empty")) for s in gets) / len(gets)
