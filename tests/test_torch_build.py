"""The kernel builder's host logic (erc_tpu_torch.ops.kernels.build), with a
stand-in compiler: one library per source, keyed on the sources' hash,
rebuilt when a source changes, and a failed compile raised with its log."""

import os
import stat
import sys

import pytest

from erc_tpu_torch.ops.kernels import build

FAKE_NVCC = f"""#!{sys.executable}
import sys
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
text = open(src).read()
if "#error" in text:
    print("fake-nvcc: error in " + src)
    sys.exit(2)
print("ptxas info    : Used 32 registers")
open(out, "w").write("lib of " + src)
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "one.cu").write_text("// one\n")
    (csrc / "two.cu").write_text("// two\n")
    (csrc / "common.cuh").write_text("// shared header\n")
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    return csrc


def test_builds_one_library_per_source_and_reuses_it(tree):
    libs = build.build_all()
    assert sorted(libs) == ["one", "two"]
    for name, path in libs.items():
        assert path.read_text() == f"lib of {tree / (name + '.cu')}"
        assert "registers" in (path.parent / f"{name}.log").read_text()
    mtime = libs["one"].stat().st_mtime_ns
    assert build.build_all() == libs
    assert libs["one"].stat().st_mtime_ns == mtime


def test_edited_header_builds_again_in_a_new_directory(tree):
    first = build.build_all()
    (tree / "common.cuh").write_text("// changed\n")
    second = build.build_all()
    assert first["one"].parent != second["one"].parent
    assert all(p.exists() for p in second.values())


def test_failed_compile_raises_with_its_log(tree):
    (tree / "two.cu").write_text("#error broken\n")
    with pytest.raises(RuntimeError, match="fake-nvcc: error"):
        build.build_all()
    assert not (build.build_dir() / "libtwo.so").exists()
    assert (build.build_dir() / "libone.so").exists()
    assert not [p for p in os.listdir(build.build_dir()) if p.endswith(".tmp")]
