"""DAG-ERC's within-block recurrence (K3): wrapper of the CUDA kernel in
``csrc/dag_block.cu`` and its plain PyTorch version.

K3 replaces ``erc_tpu/ops/pallas/dag_block.py::dag_block`` (forward).  For
one block of C positions of one DAG layer, position c in order:
  1. attends over the block's keys written so far and merges that with the
     prefix statistics ``num01, den_p, mp`` of the earlier blocks by a
     running-max rescale, giving M (zero at global position 0, ``flag``);
  2. runs the dual GRU: node GRU (x projection ``xcb``, hidden M) plus proxy
     GRU (input M, hidden projection ``hppb``, hidden ``hb``): h1 = C + P;
  3. writes V0 = h1·Wr0ᵀ, V1 = h1·Wr1ᵀ and K = h1·w_k into the block's rows.

The arguments keep the JAX kernel's layout, so the tests compare like with
like: weights as [k, d] rows (``Whc[g] = w_hh[gD:(g+1)D]ᵀ``), which is also
the layout the CUDA kernel reads coalesced, with threads over the output
column d.  A wrapper given CPU tensors returns the plain version; given CUDA
tensors it launches the kernel or raises.  There is no backward yet, so
inputs that require grad are refused while grad mode is on.  The plain
version is differentiable: it is also DAGStack's eager (training) form.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from erc_tpu_torch.ops.rnn import gru_cell_proj

ROWS_PER_BLOCK = 2  # batch rows one thread block carries; 1 where 2 do not fit in shared memory
_MAX_SMEM = 232448  # shared memory one block may use on Hopper (227 KB)

launches = {"dag_block": 0}

Flag = Union[int, bool, torch.Tensor]
Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launches() -> None:
    launches["dag_block"] = 0


def _flag(flag: Flag) -> int:
    return int(flag.reshape(-1)[0]) if isinstance(flag, torch.Tensor) else int(flag)


def _attend(qc, Kw, amw_c, smw_c, V0w, V1w, num01_c, den_p_c, mp_c):
    """Position c's attention over the block, merged with the prefix."""
    lw = qc + Kw + amw_c  # [B, C]
    mw = lw.amax(-1, keepdim=True)
    ew = torch.exp(lw - mw)
    e0w = ew * smw_c
    e1w = ew - e0w
    nw = torch.einsum("bj,bjd->bd", e0w, V0w) + torch.einsum("bj,bjd->bd", e1w, V1w)
    dnw = ew.sum(-1, keepdim=True)
    m = torch.maximum(mp_c, mw)
    sp = torch.exp(mp_c - m)
    sw = torch.exp(mw - m)
    return (num01_c * sp + nw * sw) / (den_p_c * sp + dnw * sw)


def dag_block_reference(flag: Flag, qb, xcb, hppb, hb, num01, den_p, mp, amw, smw,
                        Whc, bhc, Wip, bip, Wr0T, Wr1T, wkc) -> Outputs:
    """Plain version: the positions in order, as the JAX ``_fwd_body``
    (``_step_fwd`` per position).  The six gate products of M are one product
    and the three output products another, on the per-gate stacks laid side
    by side."""
    B, C = qb.shape
    D = hb.shape[-1]
    flag = _flag(flag)
    # M @ Wm + bm = (node GRU hidden r|z|n, proxy GRU input r|z|n), each [B, 3D]
    Wm = torch.cat([Whc.permute(1, 0, 2).reshape(D, 3 * D), Wip.permute(1, 0, 2).reshape(D, 3 * D)], 1)
    bm = torch.cat([bhc.reshape(-1), bip.reshape(-1)])
    Wout = torch.cat([Wr0T, Wr1T, wkc], 1)  # h1 @ Wout = (V0 | V1 | K)
    xc, hpp = xcb.reshape(B, C, 3 * D), hppb.reshape(B, C, 3 * D)
    V0w = qb.new_zeros(B, C, D)
    V1w = qb.new_zeros(B, C, D)
    Kw = qb.new_zeros(B, C)
    h1s = []
    for c in range(C):
        M = _attend(qb[:, c : c + 1], Kw, amw[:, c], smw[:, c], V0w, V1w,
                    num01[:, c], den_p[:, c : c + 1], mp[:, c : c + 1])
        if c == 0 and flag:
            M = torch.zeros_like(M)
        mm = M @ Wm + bm
        h1 = gru_cell_proj(xc[:, c], mm[:, : 3 * D], M) + gru_cell_proj(mm[:, 3 * D :], hpp[:, c], hb[:, c])
        o = h1 @ Wout
        V0w = V0w.select_scatter(o[:, :D], 1, c)
        V1w = V1w.select_scatter(o[:, D : 2 * D], 1, c)
        Kw = Kw.select_scatter(o[:, 2 * D], 1, c)
        h1s.append(h1)
    return torch.stack(h1s, 1), V0w, V1w, Kw


# ------------------------------------------------------------------ launch
_N_ROWS = 13  # [B, C, ...] tensors the kernel reads or writes (enum Tensor in dag_block.cu)


class _DagArgs(ctypes.Structure):
    """struct DagArgs in dag_block.cu."""

    _fields_ = [
        ("ptr", ctypes.c_void_p * _N_ROWS),
        ("sb", ctypes.c_longlong * _N_ROWS),
        ("sc", ctypes.c_longlong * _N_ROWS),
        *((name, ctypes.c_void_p) for name in ("whc", "bhc", "wip", "bip", "wr0", "wr1", "wk")),
        *((name, ctypes.c_int) for name in ("B", "C", "D", "flag")),
    ]


_lib = None


def _library():
    global _lib
    if _lib is None:
        from erc_tpu_torch.ops.kernels.build import load

        lib = load("dag_block")
        lib.erc_dag_block.argtypes = [ctypes.POINTER(_DagArgs), ctypes.c_int, ctypes.c_void_p]
        lib.erc_dag_block.restype = ctypes.c_int
        lib.erc_dag_block_smem.argtypes = [ctypes.c_int] * 3
        lib.erc_dag_block_smem.restype = ctypes.c_longlong
        lib.erc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.erc_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_shapes(qb, xcb, hppb, hb, num01, den_p, mp, amw, smw,
                  Whc, bhc, Wip, bip, Wr0T, Wr1T, wkc) -> None:
    if qb.dim() != 2:
        raise ValueError(f"dag_block: qb must be [B, C], got {tuple(qb.shape)}")
    B, C = qb.shape
    D = hb.shape[-1]
    want = {
        "xcb": (xcb, (B, C, 3, D)), "hppb": (hppb, (B, C, 3, D)), "hb": (hb, (B, C, D)),
        "num01": (num01, (B, C, D)), "den_p": (den_p, (B, C)), "mp": (mp, (B, C)),
        "amw": (amw, (B, C, C)), "smw": (smw, (B, C, C)), "Whc": (Whc, (3, D, D)),
        "bhc": (bhc, (3, D)), "Wip": (Wip, (3, D, D)), "bip": (bip, (3, D)),
        "Wr0T": (Wr0T, (D, D)), "Wr1T": (Wr1T, (D, D)), "wkc": (wkc, (D, 1)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"dag_block: {name} has shape {tuple(t.shape)}, want {shape}")


def _rows_inner_contiguous(t: torch.Tensor) -> bool:
    """Every [b, c] slice of t is contiguous (batch and position strides are free)."""
    return t[:1, :1].is_contiguous()


def _pick_rows(lib, C: int, D: int) -> int:
    """ROWS_PER_BLOCK, or 1 where that many rows' buffers do not fit in shared memory."""
    rows = ROWS_PER_BLOCK if lib.erc_dag_block_smem(ROWS_PER_BLOCK, C, D) <= _MAX_SMEM else 1
    if lib.erc_dag_block_smem(rows, C, D) > _MAX_SMEM:
        raise ValueError(f"dag_block: a block of C = {C} positions at D = {D} needs "
                         f"{lib.erc_dag_block_smem(1, C, D)} B of shared memory, over the "
                         f"{_MAX_SMEM} B a thread block may use")
    return rows


def dag_block(flag: Flag, qb, xcb, hppb, hb, num01, den_p, mp, amw, smw,
              Whc, bhc, Wip, bip, Wr0T, Wr1T, wkc, *, out: Optional[Outputs] = None) -> Outputs:
    """Fused within-block DAG recurrence.

    flag: 1 when global position 0 is in this block (its M is zeroed); qb
    [B, C] queries with the attention bias added; xcb, hppb [B, C, 3, D]
    per-gate projections; hb [B, C, D]; prefix statistics num01 [B, C, D],
    den_p, mp [B, C]; within-block additive mask amw and speaker mask smw
    [B, C, C]; weights Whc, Wip [3, D, D], bhc, bip [3, D], Wr0T, Wr1T
    [D, D], wkc [D, 1].  Returns (h1 [B, C, D], V0w, V1w [B, C, D],
    Kw [B, C]), written into ``out`` when it is given: views whose [b, c]
    slices are contiguous, such as column slices of [B, L, D] buffers.
    """
    args = (qb, xcb, hppb, hb, num01, den_p, mp, amw, smw, Whc, bhc, Wip, bip, Wr0T, Wr1T, wkc)
    _check_shapes(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("dag_block has no backward yet: call it under torch.no_grad() "
                           "or use the eager form for training")
    B, C = qb.shape
    D = hb.shape[-1]
    flag = _flag(flag)
    if out is not None and tuple(o.shape for o in out) != ((B, C, D),) * 3 + ((B, C),):
        raise ValueError(f"dag_block: out shapes {[tuple(o.shape) for o in out]} do not match")
    devices = {t.device for t in args} | ({o.device for o in out} if out is not None else set())
    if devices == {torch.device("cpu")}:
        res = dag_block_reference(flag, *args)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"dag_block runs on cuda or cpu tensors, not on {sorted(map(str, devices))}")
    for t in args + (out or ()):
        if t.dtype != torch.float32:
            raise TypeError(f"dag_block: the CUDA kernel takes float32 only, got {t.dtype}")
    if out is None:
        out = (qb.new_empty(B, C, D), qb.new_empty(B, C, D), qb.new_empty(B, C, D), qb.new_empty(B, C))
    elif not all(_rows_inner_contiguous(o) for o in out):
        raise ValueError("dag_block: each [b, c] slice of an output must be contiguous")
    if B * C * D == 0:
        return out
    lib = _library()
    rows = _pick_rows(lib, C, D)
    per_row = [t if _rows_inner_contiguous(t) else t.contiguous() for t in args[:9]] + list(out)
    a = _DagArgs()
    for i, t in enumerate(per_row):
        a.ptr[i], a.sb[i], a.sc[i] = t.data_ptr(), t.stride(0), t.stride(1)
    weights = [w.contiguous() for w in args[9:]]
    a.whc, a.bhc, a.wip, a.bip, a.wr0, a.wr1, a.wk = (w.data_ptr() for w in weights)
    a.B, a.C, a.D, a.flag = B, C, D, flag
    dev = qb.device
    with torch.cuda.device(dev):
        err = lib.erc_dag_block(ctypes.byref(a), rows, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.erc_cuda_error_string(err).decode()
        raise RuntimeError(f"dag_block kernel launch failed: {msg} (cudaError {err})")
    launches["dag_block"] += 1
    return out
