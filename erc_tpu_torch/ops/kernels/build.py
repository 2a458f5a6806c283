"""Build the hand-written CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``_build/<hash>/lib<name>.so``, a shared library with a plain C interface
that the wrappers load with ``ctypes``.  The hash covers every source in
``csrc/``, so an edited kernel builds again and an unchanged one loads from
the cache.  All sources compile at once, one ``nvcc`` each.  Nothing here
runs at import.

``build_host(name)`` builds ``csrc/<name>.cpp`` (the host-side batch
packer) with the host compiler (``g++ -O3 -shared -fPIC -pthread``) into
``_build/host-<hash>/lib<name>.so``, the hash over the source, the flags
and the compiler's version; ``load_host(name)`` loads it.  Several
processes may build it at once (the test workers): each compiles to a file
of its own and renames it into place, so a loader sees a whole library or
none.  A failed build raises with the compiler's output.
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


HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]


def _host_compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the host packer (csrc/*.cpp) needs a C++ compiler (set CXX)")
    return cxx


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cpp with the host compiler where it has no library yet; its path."""
    cxx = _host_compiler()
    src = CSRC / f"{name}.cpp"
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout.splitlines()[:1]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join([cxx, *HOST_FLAGS, *version]).encode())
    out_dir = BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *HOST_FLAGS, str(src), "-o", str(tmp)], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {src.name}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cpp, built first if need be."""
    key = f"host:{name}"
    lib = _loaded.get(key)
    if lib is None:
        lib = _loaded[key] = ctypes.CDLL(str(build_host(name)))
    return lib


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
