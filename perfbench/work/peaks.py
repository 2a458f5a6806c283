"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): HBM3 bandwidth and float32 outside the tensor cores, the
precision that ``--matmul_precision=highest`` runs every product in."""

BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def least_seconds(bytes_moved: float, flops: float) -> float:
    """The least time a launch's work can take: the larger of its bytes at
    the bandwidth and its operations at the float32 peak."""
    return max(bytes_moved / BYTES_PER_S, flops / F32_FLOP_PER_S)
