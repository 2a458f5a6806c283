"""Build the hand-written CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``_build/<hash>/lib<name>.so``, a shared library with a plain C interface
that the wrappers load with ``ctypes``.  The hash covers every source in
``csrc/``, so an edited kernel builds again and an unchanged one loads from
the cache.  All sources compile at once, one ``nvcc`` each.  Nothing here
runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")


def build_all() -> Dict[str, Path]:
    """Compile every source that has no library in the build directory yet.

    Returns {name: path of lib<name>.so}.  The compiler's output (ptxas
    registers, shared memory and spills) goes to ``<name>.log`` beside it.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {p.stem: out_dir / f"lib{p.stem}.so" for p in _sources() if p.suffix == ".cu"}
    todo = {name: path for name, path in libs.items() if not path.exists()}
    if not todo:
        return libs
    nvcc = find_nvcc()
    procs = {}
    try:
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            with open(out_dir / f"{name}.log", "w") as log:
                procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp)
    finally:
        rcs = {name: proc.wait() for name, (proc, _) in procs.items()}
    for name, (_, tmp) in procs.items():
        if rcs[name] == 0:
            os.replace(tmp, libs[name])
    failed = [name for name, rc in rcs.items() if rc != 0]
    if failed:
        logs = "\n".join((out_dir / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _loaded[name] = lib
    return lib
