"""Banded gather-sum (K1) and banded dot (K2): wrappers of the CUDA kernels
in ``csrc/banded.cu`` and their plain PyTorch versions.

K1 replaces ``erc_tpu/ops/pallas/banded.py::banded_gather_sum``:
    out[b, v, :] = Σ_k coef[b, v, k] · src[b, v + offsets[k], :]
K2 replaces ``erc_tpu/ops/pallas/banded.py::banded_dot``:
    out[b, v, k] = a[b, v, :] · b[b, v + offsets[k], :]
A tap whose source row lies outside [0, L) contributes 0.

Both kernels are memory- and launch-bound (see the note in the source).
A wrapper given CPU tensors returns the plain version; given CUDA tensors
it launches its kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

MAX_TAPS = 64  # kMaxTaps in banded.cu
_DOT_WARPS = 8  # kDotWarps in banded.cu: rows of `a` one K2 block keeps in shared memory
# shared memory one block may use on Hopper (227 KB)
_MAX_SMEM = 232448

launches = {"banded_gather_sum": 0, "banded_dot": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def band_offsets(wp: int, wf: int) -> Tuple[int, ...]:
    """Offsets of sources u = v + o feeding target v: o ∈ [-wf, wp].

    (edge u→v exists iff v ∈ [u-wp, u+wf] ⟺ u-v ∈ [-wf, wp].)
    """
    return tuple(range(-wf, wp + 1))


def _tap_range(off: int, L: int) -> Tuple[int, int]:
    """Targets v in [lo, hi) whose source v + off lies in [0, L)."""
    return max(0, -off), min(L, L - off)


def banded_gather_sum_reference(coef: torch.Tensor, src: torch.Tensor, offsets) -> torch.Tensor:
    """Plain version: a loop over taps of shifted slices, summed in tap order."""
    B, L, D = src.shape
    out = torch.zeros(B, L, D, dtype=src.dtype, device=src.device)
    for k, off in enumerate(offsets):
        lo, hi = _tap_range(off, L)
        if lo < hi:
            out[:, lo:hi] += coef[:, lo:hi, k : k + 1] * src[:, lo + off : hi + off]
    return out


def banded_dot_reference(a: torch.Tensor, b: torch.Tensor, offsets) -> torch.Tensor:
    """Plain version: a loop over taps of shifted-slice dot products."""
    B, L, _ = a.shape
    out = torch.zeros(B, L, len(offsets), dtype=a.dtype, device=a.device)
    for k, off in enumerate(offsets):
        lo, hi = _tap_range(off, L)
        if lo < hi:
            out[:, lo:hi, k] = (a[:, lo:hi] * b[:, lo + off : hi + off]).sum(-1)
    return out


_I64 = ctypes.c_longlong
_PTR = ctypes.c_void_p
_SIG = [_PTR, _I64, _I64, _PTR, _I64, _I64, _PTR, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, _PTR]
_lib = None


def _library():
    global _lib
    if _lib is None:
        from erc_tpu_torch.ops.kernels.build import load

        lib = load("banded")
        for fn in (lib.erc_banded_gather_sum, lib.erc_banded_dot):
            fn.argtypes = _SIG
            fn.restype = ctypes.c_int
        lib.erc_banded_gather_sum_smem.argtypes = [ctypes.c_int] * 3
        lib.erc_banded_gather_sum_smem.restype = ctypes.c_longlong
        lib.erc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.erc_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _row_major_last(t: torch.Tensor) -> torch.Tensor:
    """t itself when its last dim has unit stride (batch and row strides go
    to the kernel as they are), else a contiguous copy."""
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def _check(name: str, offsets: Tuple[int, ...], *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32 only, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name}: expected [B, L, *] tensors, got shape {tuple(t.shape)}")
    if not 1 <= len(offsets) <= MAX_TAPS:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_TAPS} taps, got {len(offsets)}")
    if tensors[0].shape[0] > 65535:
        raise ValueError(f"{name}: batch {tensors[0].shape[0]} exceeds the grid limit 65535")


def _launch(fn, name: str, x: torch.Tensor, y: torch.Tensor, out: torch.Tensor, D: int,
            offsets: Tuple[int, ...]) -> None:
    B, L = out.shape[:2]
    offs = (ctypes.c_int * len(offsets))(*offsets)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        err = fn(x.data_ptr(), x.stride(0), x.stride(1), y.data_ptr(), y.stride(0), y.stride(1),
                 out.data_ptr(), B, L, D, offs, len(offsets), stream)
    if err != 0:
        msg = _library().erc_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")
    launches[name] += 1


def banded_gather_sum(coef: torch.Tensor, src: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """out[b, v] = Σ_k coef[b, v, k] · src[b, v + offsets[k]].

    coef: [B, L, K]; src: [B, L, D], float32; a strided ``src`` (unit stride
    in the last dim) is read in place.
    """
    offsets = tuple(int(o) for o in offsets)
    B, L, D = src.shape
    if coef.shape != (B, L, len(offsets)):
        raise ValueError(f"coef shape {tuple(coef.shape)} != {(B, L, len(offsets))}")
    if src.device.type == "cpu" and coef.device.type == "cpu":
        return banded_gather_sum_reference(coef, src, offsets)
    if src.device.type != "cuda":
        raise ValueError(f"banded_gather_sum runs on cuda or cpu tensors, not {src.device}")
    _check("banded_gather_sum", offsets, coef, src)
    out = torch.empty(B, L, D, dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    lib = _library()
    smem = lib.erc_banded_gather_sum_smem(D, max(offsets) - min(offsets), len(offsets))
    if smem > _MAX_SMEM:
        raise ValueError(f"banded_gather_sum: offsets span {max(offsets) - min(offsets)} needs "
                         f"{smem} B of shared memory, over the {_MAX_SMEM} B a block may use")
    _launch(lib.erc_banded_gather_sum, "banded_gather_sum",
            _row_major_last(coef), _row_major_last(src), out, D, offsets)
    return out


def banded_dot(a: torch.Tensor, b: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """out[b, v, k] = a[b, v] · b[b, v + offsets[k]] (0 out of range).

    a, b: [B, L, D] float32 → [B, L, K].
    """
    offsets = tuple(int(o) for o in offsets)
    if a.shape != b.shape:
        raise ValueError(f"banded_dot: shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    B, L, D = a.shape
    if a.device.type == "cpu" and b.device.type == "cpu":
        return banded_dot_reference(a, b, offsets)
    if a.device.type != "cuda":
        raise ValueError(f"banded_dot runs on cuda or cpu tensors, not {a.device}")
    _check("banded_dot", offsets, a, b)
    out = torch.empty(B, L, len(offsets), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if _DOT_WARPS * D * 4 > _MAX_SMEM:
        raise ValueError(f"banded_dot: D = {D} rows do not fit in shared memory")
    lib = _library()
    _launch(lib.erc_banded_dot, "banded_dot", _row_major_last(a), _row_major_last(b), out, D, offsets)
    return out
