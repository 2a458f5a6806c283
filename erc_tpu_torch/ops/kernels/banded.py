"""Banded gather-sum (K1) and banded dot (K2): wrappers of the CUDA kernels
in ``csrc/banded.cu`` and their plain PyTorch versions.

K1 replaces ``erc_tpu/ops/pallas/banded.py::banded_gather_sum``:
    out[b, v, :] = Σ_k coef[b, v, k] · src[b, v + offsets[k], :]
K2 replaces ``erc_tpu/ops/pallas/banded.py::banded_dot``:
    out[b, v, k] = a[b, v, :] · b[b, v + offsets[k], :]
K1ᵀ is K1 with the coefficient read at the source row:
    out[b, u, :] = Σ_k coef[b, u + offsets[k], k] · src[b, u + offsets[k], :]
A tap whose source row lies outside [0, L) contributes 0.

Both kernels are memory- and launch-bound (see the note in the source).
Each has two instantiations: "vec4" reads rows with 16-byte loads, where
``vec4_ok`` says the layout allows it; "scalar" reads 4 bytes at a time.
A wrapper given CPU tensors returns the plain version; given CUDA tensors
it launches its kernel or raises.  ``launches`` counts kernel launches,
``variant_launches`` the same launches by load width, and ``tap_launches``
by tap-count instantiation: ``kt{K}`` for the counts the kernels unroll
(``UNROLLED_TAPS``), ``kt0`` for the generic one that takes any count in
batches of 8 taps.

Gradients.  With grad mode on and an input that requires grad, K1 and K2
go through autograd Functions whose backward is built from the same
kernels (the JAX package's VJPs ``_bgs_bwd`` and ``_bd_bwd`` are plain
jnp):
    K1: d coef = K2(g, src, off),  d src = K1ᵀ(coef, g, −off);
    K2: d a = K1(g, b, off),       d b = K1ᵀ(g, a, −off).
Negated offsets keep the taps in the order ``_bgs_bwd`` sums them.  A
gradient nobody needs is not computed.  On CPU tensors the Functions run
the plain pieces, so the CPU tests exercise the same composition.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

MAX_TAPS = 64  # kMaxTaps in banded.cu
# the kernels index threads and rows with 32-bit ints
_MAX_ELEMENTS = 2**31 - 1

launches = {"banded_gather_sum": 0, "banded_dot": 0, "banded_gather_sum_t": 0}
variant_launches = {f"{name}/{v}": 0 for name in launches for v in ("vec4", "scalar")}
_VARIANT_KEY = {(name, vec4): f"{name}/{'vec4' if vec4 else 'scalar'}" for name in launches
                for vec4 in (True, False)}
# the tap counts with their own instantiation in banded.cu (launch_for's cases)
UNROLLED_TAPS = (5, 6, 11, 21)
tap_launches = {f"{name}/kt{kt}": 0 for name in launches for kt in (0, *UNROLLED_TAPS)}


def reset_launches() -> None:
    for counts in (launches, variant_launches, tap_launches):
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


def banded_gather_sum_t_reference(coef: torch.Tensor, src: torch.Tensor, offsets) -> torch.Tensor:
    """Plain version of K1ᵀ: shifted slices of coef and src, summed in tap order."""
    B, L, D = src.shape
    out = torch.zeros(B, L, D, dtype=src.dtype, device=src.device)
    for k, off in enumerate(offsets):
        lo, hi = _tap_range(off, L)
        if lo < hi:
            out[:, lo:hi] += coef[:, lo + off : hi + off, k : k + 1] * src[:, lo + off : hi + off]
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
    offsets as ints and as a C array, and the negated offsets the backward
    passes to K1ᵀ, and each kernel's ``tap_launches`` key.  (The kernels use
    no shared memory, so no figure depends on D.)"""

    __slots__ = ("offsets", "K", "c_offsets", "negated", "tap_key")

    def __init__(self, offsets: Tuple[int, ...]):
        self.offsets = offsets
        self.K = len(offsets)
        self.c_offsets = (ctypes.c_int * len(offsets))(*offsets)
        self.negated = tuple(-o for o in offsets)
        kt = self.K if self.K in UNROLLED_TAPS else 0
        self.tap_key = {name: f"{name}/kt{kt}" for name in launches}


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
        for fn in (lib.erc_banded_gather_sum, lib.erc_banded_gather_sum_t, lib.erc_banded_dot):
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
    tap_launches[args.tap_key[name]] += 1


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA ones; raises for anything else."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if not tensors[-1].is_cuda:
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {tensors[-1].device}")
    return False


# K1 and K1ᵀ by counter name: the plain version and the C entry point
_GATHERS = {"banded_gather_sum": (banded_gather_sum_reference, "erc_banded_gather_sum"),
            "banded_gather_sum_t": (banded_gather_sum_t_reference, "erc_banded_gather_sum_t")}


def _gather(name: str, coef: torch.Tensor, src: torch.Tensor, args: LaunchArgs) -> torch.Tensor:
    """K1 (name "banded_gather_sum") or K1ᵀ ("banded_gather_sum_t") without
    autograd: the plain version on CPU tensors, else a launch."""
    B, L, D = src.shape
    if coef.shape != (B, L, args.K):
        raise ValueError(f"{name}: coef shape {tuple(coef.shape)} != {(B, L, args.K)}")
    reference, entry = _GATHERS[name]
    if _on_cpu(name, coef, src):
        return reference(coef, src, args.offsets)
    _check(name, args.K, coef, src)
    out = src.new_empty((B, L, D))
    if out.numel() == 0:
        return out
    coef, src = _row_major_last(coef), _row_major_last(src)
    _launch(getattr(_library(), entry), name, coef, src, out, D, args, vec4_ok(D, src))
    return out


def _dot(a: torch.Tensor, b: torch.Tensor, args: LaunchArgs) -> torch.Tensor:
    """K2 without autograd: the plain version on CPU tensors, else a launch."""
    if a.shape != b.shape:
        raise ValueError(f"banded_dot: shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    B, L, D = a.shape
    if _on_cpu("banded_dot", a, b):
        return banded_dot_reference(a, b, args.offsets)
    _check("banded_dot", args.K, a, b)
    out = b.new_empty((B, L, args.K))
    if out.numel() == 0:
        return out
    a, b = _row_major_last(a), _row_major_last(b)
    _launch(_library().erc_banded_dot, "banded_dot", a, b, out, D, args, vec4_ok(D, a, b))
    return out


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _GatherSumFunction(torch.autograd.Function):
    """K1 forward; backward d coef = K2(g, src, off), d src = K1ᵀ(coef, g, −off)."""

    @staticmethod
    def forward(ctx, coef, src, args):
        ctx.args = args
        want_coef, want_src = ctx.needs_input_grad[:2]
        ctx.save_for_backward(coef if want_src else None, src if want_coef else None)
        return _gather("banded_gather_sum", coef, src, args)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        coef, src = ctx.saved_tensors
        want_coef, want_src = ctx.needs_input_grad[:2]
        dcoef = _dot(g, src, ctx.args) if want_coef else None
        dsrc = _gather("banded_gather_sum_t", coef, g, launch_args(ctx.args.negated)) if want_src else None
        return dcoef, dsrc, None


class _DotFunction(torch.autograd.Function):
    """K2 forward; backward d a = K1(g, b, off), d b = K1ᵀ(g, a, −off)."""

    @staticmethod
    def forward(ctx, a, b, args):
        ctx.args = args
        want_a, want_b = ctx.needs_input_grad[:2]
        ctx.save_for_backward(a if want_b else None, b if want_a else None)
        return _dot(a, b, args)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        want_a, want_b = ctx.needs_input_grad[:2]
        da = _gather("banded_gather_sum", g, b, ctx.args) if want_a else None
        db = _gather("banded_gather_sum_t", g, a, launch_args(ctx.args.negated)) if want_b else None
        return da, db, None


def banded_gather_sum(coef: torch.Tensor, src: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """out[b, v] = Σ_k coef[b, v, k] · src[b, v + offsets[k]].

    coef: [B, L, K]; src: [B, L, D], float32; a strided ``src`` (unit stride
    in the last dim) is read in place.  Differentiable in both (see the
    module's note) when grad mode is on and either requires grad.
    """
    args = launch_args(offsets)
    if _wants_grad(coef, src):
        return _GatherSumFunction.apply(coef, src, args)
    return _gather("banded_gather_sum", coef, src, args)


def banded_gather_sum_t(coef: torch.Tensor, src: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """K1ᵀ: out[b, u] = Σ_k coef[b, u + offsets[k], k] · src[b, u + offsets[k]].

    The shapes and layouts of ``banded_gather_sum``.  It serves the band
    kernels' backward and has no backward of its own: CUDA tensors that
    require grad under grad mode are refused.
    """
    args = launch_args(offsets)
    if _wants_grad(coef, src) and src.is_cuda:
        raise ValueError("banded_gather_sum_t has no backward; call it without grad")
    return _gather("banded_gather_sum_t", coef, src, args)


def banded_dot(a: torch.Tensor, b: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """out[b, v, k] = a[b, v] · b[b, v + offsets[k]] (0 out of range).

    a, b: [B, L, D] float32 → [B, L, K]; strided views (unit stride in the
    last dim) are read in place.  Differentiable in both (see the module's
    note) when grad mode is on and either requires grad.
    """
    args = launch_args(offsets)
    if _wants_grad(a, b):
        return _DotFunction.apply(a, b, args)
    return _dot(a, b, args)
