"""On the card only (marker ``cuda``; skipped where there is none): one
short run of each cell through the benchmark's command, its result's
line well formed and correct.  Run there with
``python -m pytest -m cuda perfbench/tests/test_perfbench_card.py -q``."""

import json
import subprocess
import sys

import pytest

from perfbench.core import manifest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.benchmark()["workloads"]])
def test_one_short_run(card, cell):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed", str(2**31 + 77),
                          "--seconds", "2", "--trace", "0"], capture_output=True, text=True, cwd=str(manifest.ROOT),
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
