"""What the benchmark loads: never JAX, jaxlib, flax, optax or the JAX
package (``erc_tpu``), by top-level module name compared whole; and the
plain references load nothing of the port."""

import ast
import subprocess
import tempfile
import sys
import types

import pytest

from perfbench import run
from perfbench.core import manifest


def test_names_compare_whole(monkeypatch):
    before = run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "erc_tpu_torch_extra", types.ModuleType("erc_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("jaxtyping_like"))
    assert run.loaded_forbidden() == before
    monkeypatch.setitem(sys.modules, "erc_tpu.models", types.ModuleType("erc_tpu.models"))
    monkeypatch.setitem(sys.modules, "optax", types.ModuleType("optax"))
    assert {"erc_tpu.models", "optax"} <= set(run.loaded_forbidden())


def _run_python(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=str(manifest.ROOT), env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
                                                      "HOME": tempfile.mkdtemp(prefix="perfbench-home-")})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, os, tempfile; sys.path.insert(0, '.')\n"
            "os.environ['ERC_TPU_EXPROOT'] = tempfile.mkdtemp()\n"
            "from perfbench.tests import tiny\n"
            "from perfbench.run import loaded_forbidden\n"
            "tiny.run(tiny.TRAIN)\n"
            "print(loaded_forbidden(), 'erc_tpu_torch' in sys.modules)\n")
    assert _run_python(code) == "[] True"


@pytest.mark.parametrize("name", [c["name"] for c in manifest.benchmark()["configs"]])
def test_references_import_nothing_of_the_program(name):
    for path in (manifest.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            assert not any(m.split(".")[0] in ("erc_tpu_torch", "erc_tpu", "jax", "flax", "optax") for m in mods)
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from perfbench.core import manifest, weights\n"
            f"ref = manifest.reference({name!r}); m = dict(manifest.config({name!r})['model'])\n"
            "print(sorted(k.split('.')[0] for k in sys.modules if k.split('.')[0] in "
            "('erc_tpu_torch', 'erc_tpu', 'jax', 'flax', 'optax')))\n")
    assert _run_python(code) == "[]"
