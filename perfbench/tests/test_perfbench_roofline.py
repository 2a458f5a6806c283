"""The roofline arithmetic against the port's kernel table (``PERF.md``'s
"Bound" column, from ``chip_smoke.py``): with every position real, the
frozen work gives the table's least times."""


import pytest

from perfbench.core import manifest
from perfbench.core.context import Run
from perfbench.core.trace import Trace
from perfbench.work import kernels, peaks


def test_k3_bound():
    # K3 at B = 32, C = 16, D = 300: 0.011146 ms, bound by operations
    t = peaks.least_seconds(*kernels.dag_fwd_work([16] * 32, 0, 16, 300))
    assert t * 1e3 == pytest.approx(0.011146, abs=5e-7)


def test_k4_bound():
    # K4 at B = 16: 0.011302 ms, bound by operations
    t = peaks.least_seconds(*kernels.dag_bwd_work([16] * 16, 0, 16, 300))
    assert t * 1e3 == pytest.approx(0.011302, abs=5e-7)


def test_only_real_positions_count():
    full = kernels.dag_fwd_work([16] * 4, 0, 16, 300)
    half = kernels.dag_fwd_work([16, 16, 0, 0], 0, 16, 300)
    assert half[1] * 2 == full[1]
    assert kernels.dag_fwd_work([10, 5], 16, 16, 300) == (0, 0)
    assert kernels.dag_fwd_work([20], 16, 16, 300)[1] == kernels.dag_fwd_work([4], 0, 16, 300)[1]


def _run(config, lengths, ops):
    c = {"name": config + ".test", "config": config, "traffic": "lognormal-120", "chips": 1}
    r = Run(cell=c, cfg=manifest.config(c["config"]), mix=manifest.mix(c["traffic"]), seed=1, seconds=1.0,
            traced=True, device="cpu", work=manifest.work(c["config"]))
    r.data = [{"label": [0] * n} for n in lengths]
    r.segment = [list(range(len(lengths)))]
    r.trace = Trace(ops, [], (0.0, 1e6))
    return r


def test_dag_roofline_at_its_bound_reads_100():
    """A traced K3 and K4 time equal to the work's least time reads 100 %."""
    lengths = [40, 33, 16]
    least = 0.0
    for s in range(0, 40, 16):
        least += 4 * (peaks.least_seconds(*kernels.dag_fwd_work(lengths, s, 16, 300))
                      + peaks.least_seconds(*kernels.dag_bwd_work(lengths, s, 16, 300)))
    half = least * 1e6 / 2
    ops = [("void dag_block_cluster_kernel<5>(DagArgs, int)", 0.0, half),
           ("dag_block_bwd_cluster_kernel<3>", half, 2 * half), ("cutlass gemm", 0.0, 5e5)]
    r = _run("dagerc-iemocap", lengths, ops)
    v = manifest.metric_reader("dag_block_roofline.train").read(r)
    assert v == pytest.approx(100.0)


def test_no_kernel_reads_nothing():
    r = _run("dagerc-iemocap", [20], [("some other kernel", 0.0, 10.0)])
    assert manifest.metric_reader("dag_block_roofline.train").read(r) is None
