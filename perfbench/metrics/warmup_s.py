"""The benchmark's span around warming the cell's shapes: each bucket's
first step or forward and its capture (``core/cuda_graphs.py``), its first
replay, and on a checkout's first run the kernels' build."""


def read(r):
    spans = r.spans.named("setup.warmup")
    return spans[0].seconds if spans else None
