"""The prefetch loader's producer thread making a batch (``data/loader.py``,
``PrefetchLoader``: the next item of the wrapped loader, its collation by
``ERCBatcher``): the program's ``loader.collate`` spans of an item in the
traced segment, the mean a batch, in ms.  Nothing where the program records
no spans."""


def read(r):
    seg = r.spans.named("segment")
    if not seg:
        return None
    try:
        from erc_tpu_torch.core import tracing
    except ImportError:  # a program without spans
        return None
    made = [s for s in tracing.spans(seg[0].start, seg[0].end)
            if s.name == "loader.collate" and not s.attrs.get("end")]
    return 1e3 * sum(s.seconds for s in made) / len(made) if made else None
