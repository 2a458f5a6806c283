"""DAG-ERC's within-block recurrence: K3 (forward) and K4 (backward), the
wrappers of the CUDA kernels in ``csrc/dag_block.cu`` and
``csrc/dag_block_bwd.cu``, their plain PyTorch versions, and the autograd
Function that joins them.

K3 replaces ``erc_tpu/ops/pallas/dag_block.py::dag_block`` (forward).  For
one block of C positions of one DAG layer, position c in order:
  1. attends over the block's keys written so far and merges that with the
     prefix statistics ``num01, den_p, mp`` of the earlier blocks by a
     running-max rescale, giving M (zero at global position 0, ``flag``);
  2. runs the dual GRU: node GRU (x projection ``xcb``, hidden M) plus proxy
     GRU (input M, hidden projection ``hppb``, hidden ``hb``): h1 = C + P;
  3. writes V0 = h1·Wr0ᵀ, V1 = h1·Wr1ᵀ and K = h1·w_k into the block's rows.
For training it also returns the gate projections hpc and xpp, which K4,
the port of ``_dag_block_bwd``, reads to sweep the positions in reverse.

K3 has two variants, chosen by shape alone (``plan``): "cluster" spreads
the weights over a cluster of 16 thread blocks, each holding a slice of
columns in shared memory for the whole launch, and exchanges M and h1
through distributed shared memory at every position (D up to 320);
"stream" gives each thread block 1 or 2 batch rows and streams the
weights from L2 at every position (any D whose rows' buffers fit).  See the
note in ``csrc/dag_block.cu``.  K4's sweep has the same two variants
(``bwd_plan``): its cluster blocks each hold rows of the weights in torch's
layout and reduce the transposed products across the cluster, adding the
16 blocks' partials in rank order; see ``csrc/dag_block_bwd.cu``.  A third,
"global", places the stream kernel's buffers in a device-memory workspace,
so K4 takes every block K3 takes (C >= 75 at D = 300 fits neither shared-
memory variant).

The arguments keep the JAX kernel's layout, so the tests compare like with
like: weights as [k, d] rows (``Whc[g] = w_hh[gD:(g+1)D]ᵀ``), which is also
the layout both variants read coalesced.  A wrapper given CPU tensors
returns the plain version; given CUDA tensors it launches the kernel or
raises.  ``dag_block`` takes the autograd Function when grad mode is on and
an input requires grad.  The plain forward is differentiable by autograd
too: it is DAGStack's eager form.  ``launches`` counts kernel launches,
``variant_launches`` K3's and K4's by variant.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from erc_tpu_torch.ops.rnn import gru_cell_proj

# batch rows one thread block of K3's and K4's stream variants carries; 1
# where 2 rows' buffers do not fit in shared memory
ROWS_PER_BLOCK = 2
_MAX_SMEM = 232448  # shared memory one block may use on Hopper (227 KB)
# K3's cluster variant (kClusterBlocks, kMaxClusterRows, kClusterThreads, kRedPerRow in dag_block.cu)
CLUSTER_BLOCKS = 16
MAX_CLUSTER_ROWS = 8
_CLUSTER_THREADS = 256
_RED_PER_ROW = _CLUSTER_THREADS
# K4's cluster variant (kClusterThreads, kStats in dag_block_bwd.cu): a warp per 32
# outputs of a transposed product
_BWD_CLUSTER_THREADS = 320
_BWD_STATS = 8

launches = {"dag_block": 0, "dag_block_bwd": 0}
variant_launches = {"dag_block/cluster": 0, "dag_block/stream": 0,
                    "dag_block_bwd/cluster": 0, "dag_block_bwd/stream": 0, "dag_block_bwd/global": 0}

Flag = Union[int, bool, torch.Tensor]
Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Grads = Tuple[torch.Tensor, ...]


def reset_launches() -> None:
    for counts in (launches, variant_launches):
        for k in counts:
            counts[k] = 0


def _flag(flag: Flag) -> int:
    return int(flag.reshape(-1)[0]) if isinstance(flag, torch.Tensor) else int(flag)


def _attend(qc, Kw, amw_c, smw_c, V0w, V1w, num01_c, den_p_c, mp_c):
    """Position c's attention over the block, merged with the prefix: M and
    what the backward reuses."""
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
    den = den_p_c * sp + dnw * sw
    return (num01_c * sp + nw * sw) / den, (lw, mw, ew, e0w, e1w, nw, dnw, sp, sw, den)


def dag_block_reference(flag: Flag, qb, xcb, hppb, hb, num01, den_p, mp, amw, smw,
                        Whc, bhc, Wip, bip, Wr0T, Wr1T, wkc, *, residuals: bool = False):
    """Plain version: the positions in order, as the JAX ``_fwd_body``
    (``_step_fwd`` per position).  The six gate products of M are one product
    and the three output products another, on the per-gate stacks laid side
    by side.  ``residuals=True`` also returns the gate projections hpc =
    M·Whc + bhc and xpp = M·Wip + bip [B, C, 3, D] that K4 reads."""
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
    h1s, mms = [], []
    for c in range(C):
        M = _attend(qb[:, c : c + 1], Kw, amw[:, c], smw[:, c], V0w, V1w,
                    num01[:, c], den_p[:, c : c + 1], mp[:, c : c + 1])[0]
        if c == 0 and flag:
            M = torch.zeros_like(M)
        mm = M @ Wm + bm
        h1 = gru_cell_proj(xc[:, c], mm[:, : 3 * D], M) + gru_cell_proj(mm[:, 3 * D :], hpp[:, c], hb[:, c])
        o = h1 @ Wout
        V0w = V0w.select_scatter(o[:, :D], 1, c)
        V1w = V1w.select_scatter(o[:, D : 2 * D], 1, c)
        Kw = Kw.select_scatter(o[:, 2 * D], 1, c)
        h1s.append(h1)
        mms.append(mm)
    outs = (torch.stack(h1s, 1), V0w, V1w, Kw)
    if not residuals:
        return outs
    mm = torch.stack(mms, 1).reshape(B, C, 2, 3, D)
    return outs + (mm[:, :, 0], mm[:, :, 1])


def _gru_bwd(g, hn_proj, h, r, z, n):
    """VJP of a GRU step from its gates: (dxr, dxz, dxn), (dhr, dhz, dhn), dh."""
    dz = g * (h - n)
    dn = g * (1.0 - z)
    dn_pre = dn * (1.0 - n * n)
    dr_pre = dn_pre * hn_proj * r * (1.0 - r)
    dz_pre = dz * z * (1.0 - z)
    return (dr_pre, dz_pre, dn_pre), (dr_pre, dz_pre, dn_pre * r), g * z


def dag_block_backward_reference(flag: Flag, qb, xcb, hppb, hb, num01, den_p, mp, amw, smw,
                                 Whc, bhc, Wip, bip, Wr0T, Wr1T, wkc, h1, V0w, V1w, Kw, hpc, xpp,
                                 dh1, dV0, dV1, dKw) -> Grads:
    """Plain version of K4: the reverse sweep of the JAX ``_bwd_kernel``, in
    torch ops and without autograd.  Takes K3's arguments, its outputs and
    residuals (h1, V0w, V1w, Kw, hpc, xpp) and the outputs' cotangents;
    returns the gradients of (qb, xcb, hppb, hb, num01, den_p, mp, Whc, bhc,
    Wip, bip, Wr0T, Wr1T, wkc).  The masks get none.  Position c's attention
    is replayed from the FINAL V0w/V1w/Kw, which is exact under the gradient
    contract (see ``dag_block``)."""
    B, C = qb.shape
    D = hb.shape[-1]
    flag = _flag(flag)
    # the nine mat-vecs per position as two products on weights laid side by side
    Wout = torch.cat([Wr0T, Wr1T, wkc], 1)  # g += (dV0 | dV1 | dK) @ Woutᵀ
    Wm = torch.cat([Whc.permute(1, 0, 2).reshape(D, 3 * D), Wip.permute(1, 0, 2).reshape(D, 3 * D)], 1)
    dV0, dV1, dKw = dV0.clone(), dV1.clone(), dKw.clone()
    dqb, dden_p, dmp = qb.new_zeros(B, C), qb.new_zeros(B, C), qb.new_zeros(B, C)
    dxcb, dhppb, dhpc, dxpp = (qb.new_zeros(B, C, 3, D) for _ in range(4))
    dhb, dnum01, Ms = (qb.new_zeros(B, C, D) for _ in range(3))
    for c in range(C - 1, -1, -1):
        M, (lw, mw, ew, e0w, e1w, nw, dnw, sp, sw, den) = _attend(
            qb[:, c : c + 1], Kw, amw[:, c], smw[:, c], V0w, V1w,
            num01[:, c], den_p[:, c : c + 1], mp[:, c : c + 1])
        if c == 0 and flag:
            M = torch.zeros_like(M)
        r1 = torch.sigmoid(xcb[:, c, 0] + hpc[:, c, 0])
        z1 = torch.sigmoid(xcb[:, c, 1] + hpc[:, c, 1])
        n1 = torch.tanh(xcb[:, c, 2] + r1 * hpc[:, c, 2])
        r2 = torch.sigmoid(xpp[:, c, 0] + hppb[:, c, 0])
        z2 = torch.sigmoid(xpp[:, c, 1] + hppb[:, c, 1])
        n2 = torch.tanh(xpp[:, c, 2] + r2 * hppb[:, c, 2])
        # the output transforms, then the dual GRU (h1 = node + proxy, both get g)
        g = dh1[:, c] + torch.cat([dV0[:, c], dV1[:, c], dKw[:, c : c + 1]], 1) @ Wout.T
        dxc3, dhpc3, dM = _gru_bwd(g, hpc[:, c, 2], M, r1, z1, n1)
        dxpp3, dhpp3, dhb[:, c] = _gru_bwd(g, hppb[:, c, 2], hb[:, c], r2, z2, n2)
        dxcb[:, c], dhppb[:, c] = torch.stack(dxc3, 1), torch.stack(dhpp3, 1)
        dhpc[:, c], dxpp[:, c] = torch.stack(dhpc3, 1), torch.stack(dxpp3, 1)
        dM = dM + torch.cat([*dhpc3, *dxpp3], 1) @ Wm.T
        Ms[:, c] = M
        if c == 0 and flag:
            dM = torch.zeros_like(dM)
        # the merge M = (num01·sp + nw·sw) / den
        dnum_v = dM / den
        dden_s = -(dM * M).sum(-1, keepdim=True) / den
        dnum01[:, c] = dnum_v * sp
        dnw_v = dnum_v * sw
        dsp = (dnum_v * num01[:, c]).sum(-1, keepdim=True) + dden_s * den_p[:, c : c + 1]
        dsw = (dnum_v * nw).sum(-1, keepdim=True) + dden_s * dnw
        dden_p[:, c] = (dden_s * sp)[:, 0]
        ddnw = dden_s * sw
        # sp = exp(mp − m), sw = exp(mw − m), m = max(mp, mw): honest partials
        mp_ge = (mp[:, c : c + 1] >= mw).to(qb.dtype)
        dmp[:, c] = (mp_ge * (-dsw * sw) + (1.0 - mp_ge) * (dsp * sp))[:, 0]
        dmw = mp_ge * (dsw * sw) + (1.0 - mp_ge) * (-dsp * sp)
        # nw = Σ e0w·V0w + Σ e1w·V1w; dnw = Σ ew
        dV0 = dV0 + e0w[:, :, None] * dnw_v[:, None, :]
        dV1 = dV1 + e1w[:, :, None] * dnw_v[:, None, :]
        dew = (torch.einsum("bd,bjd->bj", dnw_v, V0w) * smw[:, c]
               + torch.einsum("bd,bjd->bj", dnw_v, V1w) * (1.0 - smw[:, c]) + ddnw)
        dlw = dew * ew
        # mw = max_j lw (ties split evenly), and the exp shift's −Σ dlw
        dmw_tot = dmw - dlw.sum(-1, keepdim=True)
        is_max = (lw == mw).to(qb.dtype)
        dlw = dlw + is_max * (dmw_tot / is_max.sum(-1, keepdim=True).clamp_min(1.0))
        dqb[:, c] = dlw.sum(-1)
        dKw = dKw + dlw
    return (dqb, dxcb, dhppb, dhb, dnum01, dden_p, dmp,
            *weight_grads_reference(h1, Ms, dhpc, dxpp, dV0, dV1, dKw))


def weight_grads_reference(h1, Ms, dhpc, dxpp, dV0, dV1, dKw) -> Grads:
    """The weight gradients (dWhc, dbhc, dWip, dbip, dWr0T, dWr1T, dwkc) as
    contractions over every (row, position) pair, from h1, M, the final dV0,
    dV1 [B, C, D], the gates' cotangents dhpc, dxpp [B, C, 3, D] and the final
    dKw [B, C]: the end of the JAX ``_bwd_kernel`` (dag_block.py:285-304)."""
    B, C, D = h1.shape
    m2, h2 = Ms.reshape(B * C, D), h1.reshape(B * C, D)
    dhpc2, dxpp2 = dhpc.reshape(B * C, 3, D), dxpp.reshape(B * C, 3, D)
    return (torch.einsum("nk,ngd->gkd", m2, dhpc2), dhpc2.sum(0),
            torch.einsum("nk,ngd->gkd", m2, dxpp2), dxpp2.sum(0),
            h2.T @ dV0.reshape(B * C, D), h2.T @ dV1.reshape(B * C, D),
            (h2 * dKw.reshape(B * C, 1)).sum(0)[:, None])


# ------------------------------------------------------------------ launch
_N_ROWS = 15  # [B, C, ...] tensors K3 reads or writes (enum Tensor in dag_block.cu)
_N_ROWS_BWD = 31  # the same for K4's sweep (enum Tensor in dag_block_bwd.cu)
_N_PRODUCTS = 8  # K4's weight-gradient products (kProducts in dag_block_bwd.cu)


class _DagArgs(ctypes.Structure):
    """struct DagArgs in dag_block.cu."""

    _fields_ = [
        ("ptr", ctypes.c_void_p * _N_ROWS),
        ("sb", ctypes.c_longlong * _N_ROWS),
        ("sc", ctypes.c_longlong * _N_ROWS),
        *((name, ctypes.c_void_p) for name in ("whc", "bhc", "wip", "bip", "wr0", "wr1", "wk")),
        *((name, ctypes.c_int) for name in ("B", "C", "D", "flag")),
    ]


class _DagBwdArgs(ctypes.Structure):
    """struct DagBwdArgs in dag_block_bwd.cu."""

    _fields_ = [
        ("ptr", ctypes.c_void_p * _N_ROWS_BWD),
        ("sb", ctypes.c_longlong * _N_ROWS_BWD),
        ("sc", ctypes.c_longlong * _N_ROWS_BWD),
        *((name, ctypes.c_void_p) for name in ("whh", "wih", "wr0", "wr1", "wk")),
        *((name, ctypes.c_int) for name in ("B", "C", "D", "flag")),
        ("ws", ctypes.c_void_p),
    ]


class _WgradArgs(ctypes.Structure):
    """struct WgradArgs in dag_block_bwd.cu."""

    _fields_ = [
        *((name, ctypes.c_void_p * _N_PRODUCTS) for name in ("a", "b", "out")),
        *((name, ctypes.c_longlong * _N_PRODUCTS) for name in ("lda", "ldb")),
        *((name, ctypes.c_void_p * _N_PRODUCTS) for name in ("x", "w", "vout")),
        ("ldx", ctypes.c_longlong * _N_PRODUCTS),
        *((name, ctypes.c_int) for name in ("N", "D")),
    ]


_libs: Dict[str, ctypes.CDLL] = {}


def _library(name: str = "dag_block") -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (K3's or K4's), built at first use."""
    lib = _libs.get(name)
    if lib is None:
        from erc_tpu_torch.ops.kernels.build import load

        lib = load(name)
        if name == "dag_block":
            lib.erc_dag_block.argtypes = [ctypes.POINTER(_DagArgs)] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.erc_dag_block.restype = ctypes.c_int
            lib.erc_dag_block_smem.argtypes = [ctypes.c_int] * 5
            lib.erc_dag_block_smem.restype = ctypes.c_longlong
            lib.erc_dag_block_max_clusters.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
            lib.erc_dag_block_max_clusters.restype = ctypes.c_int
            lib.erc_dag_block_phase_cycles.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
            lib.erc_dag_block_phase_cycles.restype = ctypes.c_int
        else:
            lib.erc_dag_block_bwd_sweep.argtypes = [ctypes.POINTER(_DagBwdArgs)] + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            lib.erc_dag_block_bwd_sweep.restype = ctypes.c_int
            lib.erc_dag_block_bwd_wgrad.argtypes = [ctypes.POINTER(_WgradArgs), ctypes.c_void_p]
            lib.erc_dag_block_bwd_wgrad.restype = ctypes.c_int
            lib.erc_dag_block_bwd_smem.argtypes = [ctypes.c_int] * 5
            lib.erc_dag_block_bwd_smem.restype = ctypes.c_longlong
            lib.erc_dag_block_bwd_max_clusters.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
            lib.erc_dag_block_bwd_max_clusters.restype = ctypes.c_int
            lib.erc_dag_block_bwd_phase_cycles.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
            lib.erc_dag_block_bwd_phase_cycles.restype = ctypes.c_int
        lib.erc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.erc_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


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


def _device(tensors, name: str) -> torch.device:
    """The one device of `tensors`: the CPU, or a card where every tensor is float32."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return torch.device("cpu")
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not on {sorted(map(str, devices))}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32 only, got {t.dtype}")
    return next(iter(devices))


def _rows_inner_contiguous(t: torch.Tensor) -> bool:
    """Every [b, c] slice of t is contiguous (batch and position strides are free)."""
    return t[:1, :1].is_contiguous()


def _per_row(t: torch.Tensor) -> torch.Tensor:
    return t if _rows_inner_contiguous(t) else t.contiguous()


def _pick_rows(smem_bytes, C: int, D: int, name: str = "dag_block") -> int:
    """ROWS_PER_BLOCK, or 1 where that many rows' buffers do not fit in shared
    memory; `smem_bytes(rows, C, D)` is the kernel's need."""
    rows = ROWS_PER_BLOCK if smem_bytes(ROWS_PER_BLOCK, C, D) <= _MAX_SMEM else 1
    if smem_bytes(rows, C, D) > _MAX_SMEM:
        raise ValueError(f"{name}: a block of C = {C} positions at D = {D} needs "
                         f"{smem_bytes(1, C, D)} B of shared memory, over the "
                         f"{_MAX_SMEM} B a thread block may use")
    return rows


# ------------------------------------------------------------------ K3's plan
class Plan(NamedTuple):
    """How one K3 launch, or K4's sweep, covers the batch."""

    variant: str  # "cluster" or "stream"
    rows: int  # batch rows a cluster (cluster) or a thread block (stream) carries
    n: int  # clusters of CLUSTER_BLOCKS blocks (cluster) or thread blocks (stream)
    cols: int  # output columns each block of a cluster owns (0 for stream)


def cluster_cols(D: int) -> int:
    """Columns each of the 16 blocks of a cluster owns: ⌈D / 16⌉ rounded up to
    a multiple of 4, so that each row of a block's weight slice starts on 16
    bytes (20 at D = 300: rank 15 owns none)."""
    return _round4(-(-D // CLUSTER_BLOCKS))


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def cluster_smem(rows: int, C: int, D: int, cols: int) -> int:
    """Shared memory (bytes) of one block of the cluster variant: its weight
    and bias slices and the whole wk; per row the warps' partial products,
    the full M and h1, V0/V1 of its columns, keys and logits
    (``ClusterLayout`` in dag_block.cu)."""
    weights = D * (_round4(6 * cols) + _round4(2 * cols)) + 6 * cols + D
    per_row = _RED_PER_ROW + 2 * D + 2 * C * cols + 3 * C + 4
    return 4 * (weights + rows * per_row)


def stream_smem(rows: int, C: int, D: int) -> int:
    """Shared memory (bytes) of one block of the stream variant
    (``stream_smem_floats`` in dag_block.cu)."""
    return 4 * (2 * rows * C * D + 2 * rows * D + 3 * rows * C + 4 * rows + rows * 16)


def _cluster_fits(rows: int, C: int, D: int, cols: int) -> bool:
    """``cluster_ok`` in dag_block.cu."""
    return (1 <= rows <= MAX_CLUSTER_ROWS and 1 <= cols and cols * CLUSTER_BLOCKS >= D
            and _round4(6 * cols) <= _CLUSTER_THREADS and rows * cols <= _CLUSTER_THREADS
            and cluster_smem(rows, C, D, cols) <= _MAX_SMEM)


def plan(B: int, C: int, D: int, n_max: int) -> Plan:
    """K3's launch for a [B, C, D] block: the cluster variant where one row's
    weight slices and buffers fit in shared memory, with n = min(B, n_max)
    clusters of R = ⌈B / n⌉ rows (fewer rows, and then more clusters, where R
    rows do not fit); else the stream variant with ROWS_PER_BLOCK rows a
    block, or 1.  n_max is the number of clusters the card holds at once
    (``max_clusters``).  Raises ValueError where neither variant fits."""
    if B < 1 or C < 1 or D < 1:
        raise ValueError(f"dag_block: no plan for B = {B}, C = {C}, D = {D}")
    cols = cluster_cols(D)
    if _cluster_fits(1, C, D, cols):
        if n_max < 1:
            raise ValueError(f"dag_block: the card holds no cluster of {CLUSTER_BLOCKS} blocks "
                             f"with {cluster_smem(1, C, D, cols)} B of shared memory each")
        fit = max(r for r in range(1, MAX_CLUSTER_ROWS + 1) if _cluster_fits(r, C, D, cols))
        rows = min(-(-B // min(B, n_max)), fit)
        return Plan("cluster", rows, -(-B // rows), cols)
    if stream_smem(1, C, D) > _MAX_SMEM:
        raise ValueError(f"dag_block: a block of C = {C} positions at D = {D} fits neither variant: "
                         f"one row needs {cluster_smem(1, C, D, cols)} B of shared memory a block "
                         f"in a cluster, {stream_smem(1, C, D)} B streaming, over the {_MAX_SMEM} B "
                         f"a thread block may use")
    rows = _pick_rows(stream_smem, C, D)
    return Plan("stream", rows, -(-B // rows), 0)


_VARIANTS = {"stream": 0, "cluster": 1, "global": 2}  # enum Variant in dag_common.cuh
_n_max: Dict[Tuple[str, Optional[int], int, int], int] = {}


def _occupancy(kernel: str, device: torch.device, C: int, D: int, smem: int) -> int:
    """cudaOccupancyMaxActiveClusters of `kernel`'s cluster variant ("dag_block"
    or "dag_block_bwd") for one row at (C, D) on `device`, cached per device and
    shared-memory size."""
    cols = cluster_cols(D)
    key = (kernel, device.index, smem, cols)
    n = _n_max.get(key)
    if n is None:
        lib = _library(kernel)
        query = getattr(lib, f"erc_{kernel}_max_clusters")
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _check_launch(lib, query(1, C, D, cols, ctypes.byref(out)), f"{kernel} (cluster occupancy query)")
        n = _n_max[key] = out.value
    return n


def max_clusters(device: torch.device, C: int, D: int) -> int:
    """The clusters of K3's cluster variant the card holds at once, for one
    row at (C, D).  Every plan at D = 300 takes more than half an SM's shared
    memory, so one block an SM and the same number whatever the rows."""
    return _occupancy("dag_block", device, C, D, cluster_smem(1, C, D, cluster_cols(D)))


@functools.lru_cache(maxsize=None)
def launch_plan(device: torch.device, B: int, C: int, D: int) -> Plan:
    """The plan K3 takes for a [B, C, D] block on `device` (cached)."""
    n_max = max_clusters(device, C, D) if _cluster_fits(1, C, D, cluster_cols(D)) else 0
    return plan(B, C, D, n_max)


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.erc_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")


# ------------------------------------------------------------------ K4's plan
def bwd_cluster_smem(rows: int, C: int, D: int, cols: int) -> int:
    """Shared memory (bytes) of one block of K4's cluster variant: its rows
    of the eight weight panels (D rounded up to 4) and of wk; per row the
    final V0/V1 and running dV0/dV1 of its columns, the gate cotangents, the
    receive buffers of the g and dM partials and of the gathered sums
    (3 + 2C from each of 16 blocks), the keys, dK and d logits, and the
    per-position arrays twice, by the parity of the position (``BwdLayout``
    in dag_block_bwd.cu)."""
    weights = 8 * cols * _round4(D) + cols
    per_row = 4 * C * cols + 42 * cols + CLUSTER_BLOCKS * (3 + 2 * C) + 11 * C + 2 * _BWD_STATS
    return 4 * (weights + rows * per_row)


def bwd_stream_smem(rows: int, C: int, D: int) -> int:
    """Shared memory (bytes) of one block of K4's stream variant
    (``stream_smem_floats`` in dag_block_bwd.cu)."""
    return 4 * rows * (4 * C * D + 10 * D + 8 * C + _BWD_STATS + 3 * 16)


def _bwd_cluster_fits(rows: int, C: int, D: int, cols: int) -> bool:
    """``cluster_ok`` in dag_block_bwd.cu."""
    return (1 <= rows <= MAX_CLUSTER_ROWS and cols >= 4 and cols % 4 == 0 and cols * CLUSTER_BLOCKS >= D
            and -(-_round4(D) // 32) <= _BWD_CLUSTER_THREADS // 32 and rows * cols <= _BWD_CLUSTER_THREADS
            and bwd_cluster_smem(rows, C, D, cols) <= _MAX_SMEM)


def bwd_plan(B: int, C: int, D: int, n_max: int) -> Plan:
    """K4's sweep for a [B, C, D] block: the cluster variant where one row's
    weight rows and buffers fit in shared memory, with n = min(B, n_max)
    clusters of R = ⌈B / n⌉ rows (fewer rows, and then more clusters, where R
    rows do not fit); else the stream variant with ROWS_PER_BLOCK rows a
    block, or 1; else the global variant, the stream kernel with one row a
    block and its buffers in a device-memory workspace (``bwd_workspace``),
    which takes every shape.  n_max is the number of K4 clusters the card
    holds at once (``bwd_max_clusters``).  Raises ValueError only where the
    cluster variant fits and the card holds no such cluster."""
    if B < 1 or C < 1 or D < 1:
        raise ValueError(f"dag_block_backward: no plan for B = {B}, C = {C}, D = {D}")
    cols = cluster_cols(D)
    if _bwd_cluster_fits(1, C, D, cols):
        if n_max < 1:
            raise ValueError(f"dag_block_backward: the card holds no cluster of {CLUSTER_BLOCKS} blocks "
                             f"with {bwd_cluster_smem(1, C, D, cols)} B of shared memory each")
        fit = max(r for r in range(1, MAX_CLUSTER_ROWS + 1) if _bwd_cluster_fits(r, C, D, cols))
        rows = min(-(-B // min(B, n_max)), fit)
        return Plan("cluster", rows, -(-B // rows), cols)
    if bwd_stream_smem(1, C, D) > _MAX_SMEM:
        return Plan("global", 1, B, 0)
    rows = _pick_rows(bwd_stream_smem, C, D, "dag_block_backward")
    return Plan("stream", rows, -(-B // rows), 0)


def bwd_workspace(plan_: Plan, C: int, D: int) -> int:
    """Floats of the device-memory workspace a K4 sweep by `plan_` needs: the
    stream layout of each of the global variant's blocks, else none."""
    return plan_.n * bwd_stream_smem(plan_.rows, C, D) // 4 if plan_.variant == "global" else 0


def bwd_max_clusters(device: torch.device, C: int, D: int) -> int:
    """The clusters of K4's cluster variant the card holds at once, for one
    row at (C, D) (one block an SM at D = 300, whatever the rows)."""
    return _occupancy("dag_block_bwd", device, C, D, bwd_cluster_smem(1, C, D, cluster_cols(D)))


@functools.lru_cache(maxsize=None)
def bwd_launch_plan(device: torch.device, B: int, C: int, D: int) -> Plan:
    """The plan K4's sweep takes for a [B, C, D] block on `device` (cached)."""
    n_max = bwd_max_clusters(device, C, D) if _bwd_cluster_fits(1, C, D, cluster_cols(D)) else 0
    return bwd_plan(B, C, D, n_max)


def _forward(flag: int, args, out: Optional[Outputs] = None, residuals: bool = False,
             plan_: Optional[Plan] = None):
    """K3 on CUDA tensors, its plain version on CPU tensors; with `residuals`
    also hpc and xpp [B, C, 3, D].  `plan_` replaces ``launch_plan``'s (to
    time other designs)."""
    qb, hb = args[0], args[3]
    B, C = qb.shape
    D = hb.shape[-1]
    device = _device(tuple(args) + tuple(out or ()), "dag_block")
    if device.type == "cpu":
        res = dag_block_reference(flag, *args, residuals=residuals)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return tuple(out) + tuple(res[4:])
    if out is None:
        out = (qb.new_empty(B, C, D), qb.new_empty(B, C, D), qb.new_empty(B, C, D), qb.new_empty(B, C))
    elif not all(_rows_inner_contiguous(o) for o in out):
        raise ValueError("dag_block: each [b, c] slice of an output must be contiguous")
    res = (qb.new_empty(B, C, 3, D), qb.new_empty(B, C, 3, D)) if residuals else ()
    if B * C * D == 0:
        return tuple(out) + res
    lib = _library()
    p = plan_ or launch_plan(device, B, C, D)
    per_row = [_per_row(t) for t in args[:9]] + list(out) + list(res)
    a = _DagArgs()
    for i, t in enumerate(per_row):  # absent residuals stay null
        a.ptr[i], a.sb[i], a.sc[i] = t.data_ptr(), t.stride(0), t.stride(1)
    weights = [w.contiguous() for w in args[9:]]
    a.whc, a.bhc, a.wip, a.bip, a.wr0, a.wr1, a.wk = (w.data_ptr() for w in weights)
    a.B, a.C, a.D, a.flag = B, C, D, flag
    with torch.cuda.device(device):
        err = lib.erc_dag_block(ctypes.byref(a), _VARIANTS[p.variant], p.rows, p.n, p.cols,
                                torch.cuda.current_stream(device).cuda_stream)
    _check_launch(lib, err, f"dag_block ({p.variant})")
    launches["dag_block"] += 1
    variant_launches[f"dag_block/{p.variant}"] += 1
    return tuple(out) + res


class _DagBlockFunction(torch.autograd.Function):
    """K3 with its residuals forward, K4 backward; on CPU tensors their plain
    versions.  Cotangents that no later op produced (the last block's V0w,
    V1w and Kw are read by no later block) arrive as zeros: autograd
    materialises them.  ``native`` is (w_hh, w_ih, Wr0, Wr1) in torch's layout
    for K4, or None to transpose the [k, d] weights per call; it takes no
    gradient (the [k, d] weights carry it)."""

    @staticmethod
    def forward(ctx, flag, native, *args):
        outs = _forward(flag, args, residuals=True)
        ctx.flag, ctx.native = flag, native
        ctx.save_for_backward(*args, *outs)
        return outs[:4]

    @staticmethod
    def backward(ctx, dh1, dV0, dV1, dKw):
        (dqb, dxcb, dhppb, dhb, dnum01, dden_p, dmp,
         dWhc, dbhc, dWip, dbip, dWr0T, dWr1T, dwkc) = dag_block_backward(
            ctx.flag, *ctx.saved_tensors, dh1, dV0, dV1, dKw, native=ctx.native)
        return (None, None, dqb, dxcb, dhppb, dhb, dnum01, dden_p, dmp, None, None,
                dWhc, dbhc, dWip, dbip, dWr0T, dWr1T, dwkc)


def dag_block(flag: Flag, qb, xcb, hppb, hb, num01, den_p, mp, amw, smw,
              Whc, bhc, Wip, bip, Wr0T, Wr1T, wkc, *, out: Optional[Outputs] = None,
              native: Optional[Tuple[torch.Tensor, ...]] = None) -> Outputs:
    """Fused within-block DAG recurrence.

    flag: 1 when global position 0 is in this block (its M is zeroed); qb
    [B, C] queries with the attention bias added; xcb, hppb [B, C, 3, D]
    per-gate projections; hb [B, C, D]; prefix statistics num01 [B, C, D],
    den_p, mp [B, C]; within-block additive mask amw and speaker mask smw
    [B, C, C]; weights Whc, Wip [3, D, D], bhc, bip [3, D], Wr0T, Wr1T
    [D, D], wkc [D, 1].  Returns (h1 [B, C, D], V0w, V1w [B, C, D],
    Kw [B, C]), written into ``out`` when it is given: views whose [b, c]
    slices are contiguous, such as column slices of [B, L, D] buffers.

    With grad mode on and an input that requires grad, the call goes through
    an autograd Function: K3 with residuals forward, K4 backward (``out`` is
    then refused; ``native`` may carry the weights in torch's layout for K4).
    GRADIENT CONTRACT (erc_tpu/ops/pallas/dag_block.py:27-33): the backward
    replays each position's attention from the block's FINAL V0w/V1w/Kw, so
    the gradient is exact except through positions whose predecessor set is
    empty, which must be flag-gated (global position 0) or carry zero
    cotangents.  DAG-ERC keeps it: every valid position i >= 1 has i - 1 as
    a predecessor, and padding positions are loss-masked.
    """
    args = (qb, xcb, hppb, hb, num01, den_p, mp, amw, smw, Whc, bhc, Wip, bip, Wr0T, Wr1T, wkc)
    _check_shapes(*args)
    B, C = qb.shape
    D = hb.shape[-1]
    if out is not None and tuple(o.shape for o in out) != ((B, C, D),) * 3 + ((B, C),):
        raise ValueError(f"dag_block: out shapes {[tuple(o.shape) for o in out]} do not match")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if out is not None:
            raise ValueError("dag_block: out= is for the forward without grad; "
                             "with grad the outputs are new tensors")
        return _DagBlockFunction.apply(_flag(flag), native, *args)
    return _forward(_flag(flag), args, out)


def dag_block_backward(flag: Flag, qb, xcb, hppb, hb, num01, den_p, mp, amw, smw,
                       Whc, bhc, Wip, bip, Wr0T, Wr1T, wkc, h1, V0w, V1w, Kw, hpc, xpp,
                       dh1, dV0, dV1, dKw, *, native: Optional[Tuple[torch.Tensor, ...]] = None,
                       plan_: Optional[Plan] = None) -> Grads:
    """K4: the gradients of ``dag_block`` (see ``dag_block_backward_reference``
    for the arguments and results).  On CPU tensors the plain version; on
    CUDA tensors two launches, the sweep by ``bwd_launch_plan`` (or by
    `plan_`, to time other designs) and the weight gradients, counted as one
    in ``launches["dag_block_bwd"]`` and by the sweep's variant in
    ``variant_launches``."""
    args = (qb, xcb, hppb, hb, num01, den_p, mp, amw, smw, Whc, bhc, Wip, bip, Wr0T, Wr1T, wkc)
    _check_shapes(*args)
    B, C = qb.shape
    D = hb.shape[-1]
    rest = (h1, V0w, V1w, Kw, hpc, xpp, dh1, dV0, dV1, dKw)
    for name, t, shape in zip(("h1", "V0w", "V1w", "Kw", "hpc", "xpp", "dh1", "dV0", "dV1", "dKw"),
                              rest, ((B, C, D),) * 3 + ((B, C),) + ((B, C, 3, D),) * 2
                              + ((B, C, D),) * 3 + ((B, C),)):
        if tuple(t.shape) != shape:
            raise ValueError(f"dag_block_backward: {name} has shape {tuple(t.shape)}, want {shape}")
    flag = _flag(flag)
    device = _device(args + rest, "dag_block_backward")
    if device.type == "cpu":
        return dag_block_backward_reference(flag, *args, *rest)
    if native is None:
        native = (Whc.transpose(1, 2).reshape(3 * D, D), Wip.transpose(1, 2).reshape(3 * D, D),
                  Wr0T.T, Wr1T.T)
    whh, wih, wr0, wr1 = (w.contiguous() for w in native)
    if (tuple(whh.shape), tuple(wih.shape), tuple(wr0.shape), tuple(wr1.shape)) != (
            (3 * D, D), (3 * D, D), (D, D), (D, D)):
        raise ValueError("dag_block_backward: native weights must be w_hh, w_ih [3D, D], Wr0, Wr1 [D, D]")
    new = qb.new_empty
    grads = (new(B, C), new(B, C, 3, D), new(B, C, 3, D), new(B, C, D), new(B, C, D), new(B, C),
             new(B, C))
    stash = (new(B, C, D), new(B, C, 3, D), new(B, C, 3, D), new(B, C, D), new(B, C, D), new(B, C))
    wgrads = (new(3, D, D), new(3, D), new(3, D, D), new(3, D), new(D, D), new(D, D), new(D, 1))
    if B * C * D == 0:
        return tuple(g.zero_() for g in grads + wgrads)
    lib = _library("dag_block_bwd")
    p = plan_ or bwd_launch_plan(device, B, C, D)
    per_row = [_per_row(t) for t in args[:9] + (V0w, V1w, Kw, hpc, xpp, dh1, dV0, dV1, dKw)]
    a = _DagBwdArgs()
    for i, t in enumerate(per_row + list(grads) + list(stash)):
        a.ptr[i], a.sb[i], a.sc[i] = t.data_ptr(), t.stride(0), t.stride(1)
    wk = wkc.contiguous()
    a.whh, a.wih, a.wr0, a.wr1, a.wk = (w.data_ptr() for w in (whh, wih, wr0, wr1, wk))
    a.B, a.C, a.D, a.flag = B, C, D, flag
    ws = new(bwd_workspace(p, C, D)) if p.variant == "global" else None
    a.ws = ws.data_ptr() if ws is not None else None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.erc_dag_block_bwd_sweep(ctypes.byref(a), _VARIANTS[p.variant], p.rows, p.n, p.cols, stream)
        _check_launch(lib, err, f"dag_block_backward (sweep, {p.variant})")
        _weight_grads_kernel(lib, h1.contiguous(), *stash, wgrads, stream)
    launches["dag_block_bwd"] += 1
    variant_launches[f"dag_block_bwd/{p.variant}"] += 1
    return grads + wgrads


def _weight_grads_kernel(lib, h1, Ms, dhpc, dxpp, dV0, dV1, dKw, wgrads, stream) -> None:
    """Launch K4's weight-gradient kernel: ``wgrads`` = (dWhc, dbhc, dWip,
    dbip, dWr0T, dWr1T, dwkc) from contiguous h1, M, dV0, dV1 [B, C, D],
    dhpc, dxpp [B, C, 3, D] and dKw [B, C]."""
    B, C, D = h1.shape
    dWhc, dbhc, dWip, dbip, dWr0T, dWr1T, dwkc = wgrads
    f32 = 4
    w = _WgradArgs()
    w.N, w.D = B * C, D
    for g in range(3):
        for z, stacked, wout, bout in ((g, dhpc, dWhc, dbhc), (3 + g, dxpp, dWip, dbip)):
            col = stacked.data_ptr() + g * D * f32  # gate g of [N, 3, D]
            w.a[z], w.lda[z], w.b[z], w.ldb[z], w.out[z] = Ms.data_ptr(), D, col, 3 * D, wout[g].data_ptr()
            w.x[z], w.ldx[z], w.vout[z] = col, 3 * D, bout[g].data_ptr()
    for z, dV in ((6, dV0), (7, dV1)):
        w.a[z], w.lda[z], w.b[z], w.ldb[z] = h1.data_ptr(), D, dV.data_ptr(), D
    w.out[6], w.out[7] = dWr0T.data_ptr(), dWr1T.data_ptr()
    w.x[6], w.ldx[6], w.w[6], w.vout[6] = h1.data_ptr(), D, dKw.data_ptr(), dwkc.data_ptr()
    _check_launch(lib, lib.erc_dag_block_bwd_wgrad(ctypes.byref(w), stream),
                  "dag_block_backward (weight gradients)")
