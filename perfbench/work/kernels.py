"""The hand-written DAG kernels' work, frozen from the port's kernel table
(``chip_smoke.py``'s ``_dag_work`` and ``_dag_bwd_work``), counted over the
positions of real utterances only, whatever the batch's padding: a launch's
least bytes read each input once and write each output once.

- K3 ``dag_block``: one block of C positions of one DAG layer, forward;
- K4 ``dag_block_bwd``: the same block's backward, its weight gradients too.

Kernel names as a device trace shows them, to match launches by.
"""

F32 = 4

DAG_FWD_KERNELS = ("dag_block_cluster_kernel", "dag_block_stream_kernel")
DAG_BWD_KERNELS = ("dag_block_bwd_cluster_kernel", "dag_block_bwd_stream_kernel", "dag_block_wgrad_kernel")


def _block_positions(lengths, s: int, c: int):
    """The real positions of each dialogue in the block [s, s + c)."""
    return [min(c, int(n) - s) for n in lengths if int(n) > s]


def dag_fwd_work(lengths, s: int, c: int, d: int):
    """K3's least bytes and operations for block [s, s + c) of one layer over
    dialogues of ``lengths``: per real position the eight D×D products, the
    gates, and the attention over the earlier positions of its block; the
    weights once a launch."""
    pos = _block_positions(lengths, s, c)
    p = sum(pos)
    if not p:
        return 0, 0
    bytes_moved = F32 * (p * (1 + 6 * d + 2 * d + 2 + 2 * c) + 8 * d * d + 6 * d + d + p * (3 * d + 1))
    flops = p * (16 * d * d + 2 * d + 30 * d) + sum(q * (q - 1) // 2 for q in pos) * 4 * d
    return bytes_moved, flops


def dag_bwd_work(lengths, s: int, c: int, d: int):
    """K4's least bytes and operations for the same block: per real position
    nine D×D mat-vecs, the attention's backward over the block's columns, the
    gates; the weight gradients' D×D products and sums; the weights read and
    their gradients written once a launch."""
    p = sum(_block_positions(lengths, s, c))
    if not p:
        return 0, 0
    rows = p * (1 + 6 * d + 2 * d + 2 + 2 * c)  # K3's per-row inputs
    rows += p * (3 * d + 1 + 6 * d)  # K3's outputs and residuals
    rows += p * (3 * d + 1)  # cotangents
    rows += p * (1 + 6 * d + 2 * d + 2)  # per-row gradients
    weights = 2 * (8 * d * d + 6 * d + d)
    flops = p * (16 * d * d + 12 * c * d + 60 * d) + 16 * d * d * p + 8 * d * p
    return F32 * (rows + weights), flops
