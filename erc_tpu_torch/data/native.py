"""ctypes bindings of the native batch packer (``csrc/collate.cpp``).

Port of ``erc_tpu.native``, with its signatures: ``pack_rows`` (float32
rows of [len_i, D] into a zero-padded [B, L, D], on ``n_threads`` threads),
``pack_labels`` (int32 rows into [B, L] with a fill) and ``fill_mask`` (the
[B, L] float32 mask of the lengths).  A row of None is padding, and its
length must be 0.  The
library is built at first use by ``ops.kernels.build.load_host``; a failed
build raises with the compiler's output (there is no numpy fallback here:
``data.collate._pack`` is the plain version that the tests hold these
against).  Each call checks that every row holds the rows and width it is
asked to copy, since the C code reads ``min(lens[i], L)`` rows of each.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

_lib = None


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from erc_tpu_torch.ops.kernels.build import load_host

        lib = load_host("collate")
        i32, vp = ctypes.c_int32, ctypes.c_void_p
        lib.pack_rows.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(i32), i32, i32, i32, vp, i32]
        lib.pack_labels.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(i32), i32, i32, i32, vp]
        lib.fill_mask.argtypes = [ctypes.POINTER(i32), i32, i32, vp]
        for fn in (lib.pack_rows, lib.pack_labels, lib.fill_mask):
            fn.restype = None
        _lib = lib
    return _lib


def _ptr_array(arrays: List[Optional[np.ndarray]]):
    ptrs = (ctypes.c_void_p * len(arrays))()
    for i, a in enumerate(arrays):
        ptrs[i] = 0 if a is None else a.ctypes.data_as(ctypes.c_void_p).value
    return ptrs


def _lens(lens: np.ndarray, rows: list, L: int, width: Optional[int]) -> np.ndarray:
    lens32 = np.ascontiguousarray(lens, np.int32)
    if len(lens32) != len(rows):
        raise ValueError(f"{len(rows)} rows and {len(lens32)} lengths")
    for i, r in enumerate(rows):
        n = min(int(lens32[i]), L)
        if r is None:
            if n > 0:  # the C code would leave those positions unwritten
                raise ValueError(f"row {i} is None with length {n}")
            continue
        if r.shape[0] < n or (width is not None and (r.ndim != 2 or r.shape[1] != width)):
            raise ValueError(f"row {i} of shape {r.shape}: {n} rows of width {width} asked for")
    return lens32


def pack_rows(rows: List[Optional[np.ndarray]], lens: np.ndarray, L: int, D: int,
              out: Optional[np.ndarray] = None, n_threads: int = 4) -> np.ndarray:
    """Pack [len_i, D] float32 rows into [B, L, D] (zero padded)."""
    B = len(rows)
    rows = [None if r is None else np.ascontiguousarray(r, dtype=np.float32) for r in rows]
    lens32 = _lens(lens, rows, L, D)
    if out is None:
        out = np.empty((B, L, D), np.float32)
    elif out.shape != (B, L, D) or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 array of {(B, L, D)}, not {out.dtype} {out.shape}")
    get_lib().pack_rows(_ptr_array(rows), lens32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), B, L, D,
                        out.ctypes.data_as(ctypes.c_void_p), n_threads)
    return out


def pack_labels(rows: List[Optional[np.ndarray]], lens: np.ndarray, L: int, fill: int = -1) -> np.ndarray:
    """Pack int32 rows into [B, L], ``fill`` past each length."""
    B = len(rows)
    rows = [None if r is None else np.ascontiguousarray(r, dtype=np.int32) for r in rows]
    lens32 = _lens(lens, rows, L, None)
    out = np.empty((B, L), np.int32)
    get_lib().pack_labels(_ptr_array(rows), lens32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), B, L, fill,
                          out.ctypes.data_as(ctypes.c_void_p))
    return out


def fill_mask(lens: np.ndarray, L: int) -> np.ndarray:
    """The [B, L] float32 mask: 1 below each length, 0 past it."""
    lens32 = np.ascontiguousarray(lens, np.int32)
    out = np.empty((len(lens32), L), np.float32)
    get_lib().fill_mask(lens32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(lens32), L,
                        out.ctypes.data_as(ctypes.c_void_p))
    return out
