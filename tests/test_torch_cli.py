"""The port's machine config, git snapshots and management CLI
(``erc_tpu_torch.core.machine``, ``erc_tpu_torch.cli``), mirroring
``tests/test_machine.py``.

- Config layering: the local ``.erc_tpurc.json`` over the global one, the
  environment variable over both, JSON nulls as missing.
- ``git_snapshot`` in a temporary repository: the working tree (an edit and
  an untracked file) as a commit on the snapshot branch, with the user's
  HEAD, index and status untouched, the same commit for the same tree, a
  parent chain; ``archive_snapshot`` writes it.
- The CLI: ``init``, ``extract`` (and its refusal of an unknown run),
  ``archive``, ``clone`` of a local path (no network), ``list``, ``tests``,
  ``sum``, ``board``, ``stop`` over a fabricated experiment root; ``warm``,
  ``mem`` and ``summary`` with ``--device=cpu`` (and ``mem`` refusing to fall
  back to the CPU where CUDA is absent).
"""

import json
import os
import subprocess
import zipfile

import pytest
import torch

from erc_tpu_torch import cli
from erc_tpu_torch.core import machine
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)


def _git(args, cwd):
    return subprocess.run(["git"] + args, cwd=cwd, capture_output=True, text=True)


def _mk_repo(tmp_path, name="proj"):
    repo = str(tmp_path / name)
    os.makedirs(repo)
    _git(["init", "-q"], repo)
    _git(["config", "user.email", "t@t"], repo)
    _git(["config", "user.name", "t"], repo)
    with open(os.path.join(repo, "a.py"), "w") as f:
        f.write("x = 1\n")
    _git(["add", "."], repo)
    _git(["commit", "-qm", "init"], repo)
    return repo


def test_machine_config_layering(tmp_path, monkeypatch):
    repo = _mk_repo(tmp_path)
    home = tmp_path / "home"
    home.mkdir()
    (home / ".erc_tpurc.json").write_text(json.dumps({"exproot": "/from/global", "data_root": "/g/data",
                                                      "cache_dir": "/g/cache"}))
    with open(os.path.join(repo, ".erc_tpurc.json"), "w") as f:
        json.dump({"exproot": "/from/local", "data_root": None}, f)
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.chdir(repo)
    monkeypatch.delenv("ERC_TPU_EXPROOT_X", raising=False)
    machine.machine_config.cache_clear()
    try:
        assert machine.cfg_get("exproot", env="ERC_TPU_EXPROOT_X") == "/from/local"
        assert machine.cfg_get("cache_dir") == "/g/cache"
        assert machine.cfg_get("data_root", default="/d") == "/d"  # a local null counts as missing
        monkeypatch.setenv("ERC_TPU_EXPROOT_X", "/from/env")
        assert machine.cfg_get("exproot", env="ERC_TPU_EXPROOT_X") == "/from/env"
    finally:
        machine.machine_config.cache_clear()


def test_git_snapshot_captures_working_tree(tmp_path):
    repo = _mk_repo(tmp_path)
    with open(os.path.join(repo, "a.py"), "w") as f:
        f.write("x = 2\n")
    with open(os.path.join(repo, "new.txt"), "w") as f:
        f.write("hello\n")
    status = _git(["status", "--porcelain"], repo).stdout
    c1 = machine.git_snapshot(repo)
    assert c1
    assert _git(["rev-parse", "--abbrev-ref", "HEAD"], repo).stdout.strip() != machine.SNAPSHOT_BRANCH
    assert _git(["status", "--porcelain"], repo).stdout == status
    assert _git(["show", f"{c1}:a.py"], repo).stdout == "x = 2\n"
    assert _git(["show", f"{c1}:new.txt"], repo).stdout == "hello\n"
    assert machine.git_snapshot(repo) == c1
    with open(os.path.join(repo, "a.py"), "w") as f:
        f.write("x = 3\n")
    c2 = machine.git_snapshot(repo)
    assert c2 != c1 and _git(["rev-parse", f"{c2}^"], repo).stdout.strip() == c1
    out = str(tmp_path / "snap.zip")
    assert machine.archive_snapshot(c2, out, repo) and zipfile.ZipFile(out).read("a.py") == b"x = 3\n"
    assert machine.git_snapshot(str(tmp_path / "nowhere")) is None  # outside a repository


def _fake_run(root, exp="erc_tpu_torch.COGMENTrainer", test="t1", f1=0.5):
    tdir = root / "experiment" / exp / test
    tdir.mkdir(parents=True)
    (tdir / "params.yaml").write_text("dataset: synthetic-cogmen-6\nmodality: atv\nseed: 1\n")
    (tdir / "metrics.json").write_text(json.dumps({"f1": f1, "acc": 0.25, "cls_f1": [0.1, 0.2]}))
    (tdir / "board.jsonl").write_text(json.dumps({"step": 0, "stage": "test", "f1": f1}) + "\n{torn")
    (tdir / "initial.json").write_text(json.dumps({"argv": ["x"]}))
    blob = root / "blob" / exp / test / "saver"
    blob.mkdir(parents=True)
    (blob / "model.last.ckpt").write_bytes(b"\x00\x01")
    return tdir


def test_cli_commands(tmp_path, monkeypatch, capsys):
    proj = str(tmp_path / "newproj")
    cli.main(["init", proj])
    assert os.path.isdir(os.path.join(proj, ".git")) and os.path.exists(os.path.join(proj, ".erc_tpurc.json"))

    root = tmp_path / "exp"
    monkeypatch.setenv("ERC_TPU_EXPROOT", str(root))
    tdir = _fake_run(root)
    _fake_run(root, test="t2", f1=0.75)
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    cli.main(["list"])
    assert capsys.readouterr().out.split() == ["erc_tpu_torch.COGMENTrainer"]
    cli.main(["tests", "erc_tpu_torch.COGMENTrainer"])
    assert capsys.readouterr().out.split() == ["t1", "t2"]
    cli.main(["sum", "erc_tpu_torch.COGMENTrainer", "t1"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["best_metrics"]["f1"] == 0.5 and summary["board"] == [{"step": 0, "stage": "test", "f1": 0.5}]
    assert summary["initial"] == {"argv": ["x"]}
    cli.main(["board"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["exp", "test", "dataset", "modality", "seed", "f1", "acc"]
    assert "0.7500" in lines[2] and "synthetic-cogmen-6" in lines[1]
    cli.main(["stop", "erc_tpu_torch.COGMENTrainer", "t1"])
    assert (tdir / ".stop").exists()

    out = str(tmp_path / "run.zip")
    cli.main(["extract", "erc_tpu_torch.COGMENTrainer", "t1", out])
    names = zipfile.ZipFile(out).namelist()
    assert "experiment/params.yaml" in names and "blob/saver/model.last.ckpt" in names
    with pytest.raises(SystemExit, match="no files found"):
        cli.main(["extract", "erc_tpu_torch.COGMENTrainer", "nope", str(tmp_path / "none.zip")])
    assert not os.path.exists(tmp_path / "none.zip")

    repo = _mk_repo(tmp_path, "src")
    head = _git(["rev-parse", "HEAD"], repo).stdout.strip()
    monkeypatch.chdir(repo)
    cli.main(["archive", head, str(tmp_path / "head.zip")])
    assert zipfile.ZipFile(tmp_path / "head.zip").read("a.py") == b"x = 1\n"
    monkeypatch.chdir(tmp_path)
    cli.main(["clone", repo, "copy"])  # a local path: no network
    assert (tmp_path / "copy" / "a.py").read_text() == "x = 1\n" and (tmp_path / "copy" / ".erc_tpurc.json").exists()


def test_cli_device_commands_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ERC_TPU_EXPROOT", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = cli.warm("cogmen", "synthetic-cogmen-6", 2, 8, device="cpu")
        assert res["device"] == "cpu" and res["shapes"]["input_tensor"] == [2, 8, 712]
        capsys.readouterr()
        cli.main(["mem", "--device=cpu"])
        assert capsys.readouterr().out.startswith("cpu: no allocator stats exposed")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main(["mem"])
        cli.main(["summary", "dgcn", "synthetic-cogmen-6", "--device=cpu"])
        text = capsys.readouterr().out
    finally:
        torch.set_num_threads(n)
    from erc_tpu_torch.models import dgcn

    p = dgcn.ParamsType()
    p.dataset = "synthetic-cogmen-6"
    p.iparams()
    total = sum(t.numel() for t in dgcn.build(p, generator=torch.Generator().manual_seed(1)).parameters())
    assert f"Total params: {total:,}" in text and "Model: DGCNModule" in text and "Output shape(s): 32x" in text
