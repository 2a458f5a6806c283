"""Banded gather-sum (K1) and banded dot (K2): wrappers of the CUDA kernels
in ``csrc/banded.cu`` and their plain PyTorch versions.

K1 replaces ``erc_tpu/ops/pallas/banded.py::banded_gather_sum``:
    out[b, v, :] = Σ_k coef[b, v, k] · src[b, v + offsets[k], :]
K2 replaces ``erc_tpu/ops/pallas/banded.py::banded_dot``:
    out[b, v, k] = a[b, v, :] · b[b, v + offsets[k], :]
A tap whose source row lies outside [0, L) contributes 0.

Both kernels are memory- and launch-bound (see the note in the source).
Each has two instantiations: "vec4" reads rows with 16-byte loads, where
``vec4_ok`` says the layout allows it; "scalar" reads 4 bytes at a time.
A wrapper given CPU tensors returns the plain version; given CUDA tensors
it launches its kernel or raises.  ``launches`` counts kernel launches,
``variant_launches`` the same launches by instantiation.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

MAX_TAPS = 64  # kMaxTaps in banded.cu
# the kernels index threads and rows with 32-bit ints
_MAX_ELEMENTS = 2**31 - 1

launches = {"banded_gather_sum": 0, "banded_dot": 0}
variant_launches = {f"{name}/{v}": 0 for name in launches for v in ("vec4", "scalar")}
_VARIANT_KEY = {(name, vec4): f"{name}/{'vec4' if vec4 else 'scalar'}" for name in launches
                for vec4 in (True, False)}


def reset_launches() -> None:
    for counts in (launches, variant_launches):
        for k in counts:
            counts[k] = 0


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


class LaunchArgs:
    """What a launch takes from the offsets, built once per offsets: the
    offsets as ints and as a C array.  (The kernels use no shared memory, so
    no figure depends on D.)"""

    __slots__ = ("offsets", "K", "c_offsets")

    def __init__(self, offsets: Tuple[int, ...]):
        self.offsets = offsets
        self.K = len(offsets)
        self.c_offsets = (ctypes.c_int * len(offsets))(*offsets)


_launch_args: Dict[Tuple[int, ...], LaunchArgs] = {}


def launch_args(offsets: Sequence[int]) -> LaunchArgs:
    """The cached LaunchArgs of `offsets`; equal offsets given as a tuple,
    a list or a range share one entry."""
    key = offsets if type(offsets) is tuple else tuple(offsets)
    args = _launch_args.get(key)
    if args is None:
        args = _launch_args[key] = LaunchArgs(tuple(int(o) for o in key))
    return args


def vec4_ok(D: int, *tensors: torch.Tensor) -> bool:
    """Whether the 16-byte instantiation may read `tensors` ([B, L, D], unit
    last stride): D % 4 == 0, each base 16-byte aligned, and each batch and
    row stride (of a dim longer than 1) a multiple of 4 floats."""
    if D % 4:
        return False
    for t in tensors:
        if t.data_ptr() % 16:
            return False
        (B, L), (sb, sl) = t.shape[:2], t.stride()[:2]
        if (sb % 4 and B > 1) or (sl % 4 and L > 1):
            return False
    return True


_I64 = ctypes.c_longlong
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIG = [_PTR, _I64, _I64, _PTR, _I64, _I64, _PTR, _INT, _INT, _INT,
        ctypes.POINTER(_INT), _INT, _INT, _PTR]
_lib = None


def _library():
    global _lib
    if _lib is None:
        from erc_tpu_torch.ops.kernels.build import load

        lib = load("banded")
        for fn in (lib.erc_banded_gather_sum, lib.erc_banded_dot):
            fn.argtypes = _SIG
            fn.restype = _INT
        lib.erc_cuda_error_string.argtypes = [_INT]
        lib.erc_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _row_major_last(t: torch.Tensor) -> torch.Tensor:
    """t itself when its last dim has unit stride (batch and row strides go
    to the kernel as they are), else a contiguous copy."""
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def _check(name: str, K: int, x: torch.Tensor, y: torch.Tensor) -> None:
    """Raise unless x and y are float32 [B, L, *] tensors on y's CUDA device
    and K and y's size are within the kernel's limits."""
    if x.get_device() != y.get_device():
        raise ValueError(f"{name}: tensors on {x.device} and {y.device}")
    for t in (x, y):
        if t.dtype is not torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32 only, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name}: expected [B, L, *] tensors, got shape {tuple(t.shape)}")
    if not 1 <= K <= MAX_TAPS:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_TAPS} taps, got {K}")
    if y.numel() > _MAX_ELEMENTS:
        raise ValueError(f"{name}: {y.numel()} elements exceed the kernel's 32-bit indexing")


def _launch(fn, name: str, x: torch.Tensor, y: torch.Tensor, out: torch.Tensor, D: int,
            args: LaunchArgs, vec4: bool) -> None:
    B, L = out.shape[:2]
    dev = out.get_device()
    # the raw handle of the device's current stream, read once
    call = (x.data_ptr(), x.stride(0), x.stride(1), y.data_ptr(), y.stride(0), y.stride(1),
            out.data_ptr(), B, L, D, args.c_offsets, args.K, vec4,
            torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        err = fn(*call)
    else:
        with torch.cuda.device(dev):
            err = fn(*call)
    if err != 0:
        msg = _library().erc_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")
    launches[name] += 1
    variant_launches[_VARIANT_KEY[name, vec4]] += 1


def banded_gather_sum(coef: torch.Tensor, src: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """out[b, v] = Σ_k coef[b, v, k] · src[b, v + offsets[k]].

    coef: [B, L, K]; src: [B, L, D], float32; a strided ``src`` (unit stride
    in the last dim) is read in place.
    """
    B, L, D = src.shape
    args = launch_args(offsets)
    K = args.K
    if coef.shape != (B, L, K):
        raise ValueError(f"coef shape {tuple(coef.shape)} != {(B, L, K)}")
    if not src.is_cuda:
        if src.device.type == "cpu" and coef.device.type == "cpu":
            return banded_gather_sum_reference(coef, src, args.offsets)
        raise ValueError(f"banded_gather_sum runs on cuda or cpu tensors, not {src.device}")
    _check("banded_gather_sum", K, coef, src)
    out = src.new_empty((B, L, D))
    if out.numel() == 0:
        return out
    coef, src = _row_major_last(coef), _row_major_last(src)
    _launch(_library().erc_banded_gather_sum, "banded_gather_sum", coef, src, out, D, args,
            vec4_ok(D, src))
    return out


def banded_dot(a: torch.Tensor, b: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """out[b, v, k] = a[b, v] · b[b, v + offsets[k]] (0 out of range).

    a, b: [B, L, D] float32 → [B, L, K]; strided views (unit stride in the
    last dim) are read in place.
    """
    if a.shape != b.shape:
        raise ValueError(f"banded_dot: shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    B, L, D = a.shape
    args = launch_args(offsets)
    K = args.K
    if not b.is_cuda:
        if a.device.type == "cpu" and b.device.type == "cpu":
            return banded_dot_reference(a, b, args.offsets)
        raise ValueError(f"banded_dot runs on cuda or cpu tensors, not {b.device}")
    _check("banded_dot", K, a, b)
    out = b.new_empty((B, L, K))
    if out.numel() == 0:
        return out
    a, b = _row_major_last(a), _row_major_last(b)
    _launch(_library().erc_banded_dot, "banded_dot", a, b, out, D, args,
            vec4_ok(D, a, b))
    return out
