"""K3 and K4 (``ops/kernels/dag_block.py``, ``csrc/dag_block*.cu``) against
their roofline in the traced training segment: the least time of the work
the steps need (per DAG layer and block of ``dag_chunk`` positions, one K3
forward and one K4 backward over the real utterances; recomputation adds
time, not work) over the traced time of every K3 and K4 launch, in %."""

from perfbench.work import kernels, peaks


def read(r):
    if r.trace is None:
        return None
    ops = r.trace.ops_named(kernels.DAG_FWD_KERNELS + kernels.DAG_BWD_KERNELS)
    if not ops:
        return None
    m = r.model
    C, D, layers = int(m["dag_chunk"]), int(m["hidden_dim"]), int(m["gnn_layers"])
    least = 0.0
    for batch in r.segment:
        lens = r.lengths(batch)
        for s in range(0, max(lens), C):
            least += layers * (peaks.least_seconds(*kernels.dag_fwd_work(lens, s, C, D))
                               + peaks.least_seconds(*kernels.dag_bwd_work(lens, s, C, D)))
    return 100.0 * least / (sum(b - a for _, a, b in ops) / 1e6)
