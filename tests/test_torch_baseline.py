"""``scripts/torch_baseline.py``, the port's sweep generator, ≡ the JAX
package's ``scripts/baseline.py`` run with ``--script="-m erc_tpu_torch.train"``:

- their lines are equal, line for line, at the defaults and with a
  ``--modality`` mask, ``--seeds``, ``--datasets``, ``--shard`` and all
  together (both run in this process through ``runpy``);
- the port's script, run in a fresh interpreter, leaves no module of JAX,
  flax, optax or ``erc_tpu`` in ``sys.modules``;
- the first run of a ``--datasets=synthetic-cogmen-6`` sweep, with
  ``--device=cpu --epoch=1 --batch_count=1`` and narrow widths appended,
  trains the port for one step and exits 0.
"""

import os
import runpy
import shlex
import subprocess
import sys

import pytest

from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "baseline.py")
PORT_SCRIPT = os.path.join(REPO, "scripts", "torch_baseline.py")
CASES = {"defaults": [], "modality": ["--modality=1010011"], "seeds": ["--seeds=2"],
         "datasets": ["--datasets=synthetic-cogmen-6,meld-mmgcn-7"], "shard": ["--shard=1/3"],
         "all": ["--module=dgcn", "--modality=0110001", "--seeds=2", "--datasets=a,b,c", "--shard=2/5"]}


def _lines(script, argv, capsys, monkeypatch) -> list:
    monkeypatch.setattr(sys, "argv", [script, *argv])
    monkeypatch.setattr(sys, "path", list(sys.path))  # each script puts its own entry in front
    capsys.readouterr()
    runpy.run_path(script, run_name="__main__")
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("argv", CASES.values(), ids=CASES.keys())
def test_sweep_lines_equal_the_jax_scripts(argv, capsys, monkeypatch):
    want = _lines(JAX_SCRIPT, [*argv, "--script=-m erc_tpu_torch.train"], capsys, monkeypatch)
    got = _lines(PORT_SCRIPT, argv, capsys, monkeypatch)
    assert got == want
    assert got[0] == f'echo "execute {len(got) - 1} runs."' and len(got) > 1
    assert all(line.startswith("python3 -m erc_tpu_torch.train --module=") for line in got[1:])


def test_sweep_imports_no_jax():
    code = ("import runpy, sys\n"
            f"sys.argv = [{PORT_SCRIPT!r}, '--seeds=1']\n"
            f"runpy.run_path({PORT_SCRIPT!r}, run_name='__main__')\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'erc_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0] == 'echo "execute 21 runs."' and lines[-1] == "[]"


def test_first_sweep_line_trains_the_port(tmp_path):
    argv = ["--datasets=synthetic-cogmen-6", "--seeds=1"]
    out = subprocess.run([sys.executable, PORT_SCRIPT, *argv], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    first = out.stdout.splitlines()[1]
    assert first == ("python3 -m erc_tpu_torch.train --module=cogmen --dataset=synthetic-cogmen-6 --reimplement "
                     "--modality=atv --seed=0")
    cmd = [sys.executable, *shlex.split(first)[1:], "--device=cpu", "--epoch=1", "--batch_count=1",
           "--hidden_size=16", "--max_seq_len=32", "--train.batch_size=4", "--test.batch_size=16",
           "--confusion_matrix=false", f"--save_dir={tmp_path}"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert run.returncode == 0, run.stderr[-3000:]
    assert "epoch 0:" in run.stdout and "| 1 steps" in run.stdout and (tmp_path / "model.last.ckpt").exists()
