#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (erc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. probe the toolchain and the card, build the CUDA kernels from csrc/;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the model paths give it (K1/K2 banded, K3 dag_block, K4
     dag_block_bwd), and time kernel, plain version and, where one exists,
     a library yardstick;
  3. drive COGMEN serving at full width (712 → 100, 2-layer encoder,
     banded graph) through InferenceEngine: predict, banded ≡ dense, a
     single-dialogue request, an HTTP round trip, latency and throughput;
  4. drive DAG-ERC serving at full width (712 → 300, 4 DAG layers, chunk
     16) through InferenceEngine: predict through K3, kernel ≡ eager form,
     card ≡ CPU, a single-dialogue request, latency, throughput, profile;
  5. drive DAG-ERC training at full width with the IEMOCAP reimplement
     settings (batch 16, AdamW 5e-4, dropout 0.2, clip 5.0, dag_remat)
     through DAGERCTrainer with dag_impl=kernel (K3 forward, K4 backward):
     gradients and 3 steps' losses ≡ the eager form, card ≡ CPU, one epoch
     and test(), launch counts, dialogues/s, profile of one step;
  6. print the run's wall time, one JSON line of kernel records, the card's
     name and power limit, and a last JSON line {"ok": true, "device": {...}}.
Each model path is driven with every launch count set to 0 just before it
and read just after.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
KERNEL_TOL = 1e-5  # float32; kernel and plain version differ only in summation order
DAG_TOL = 1e-4  # K3: the recurrence compounds the summation order over C = 16 positions
# K4, relative to max(1, max |plain|) of each gradient: the reverse sweep
# compounds the order over C positions, and the weight gradients sum B·C terms
DAG_BWD_TOL = 1e-4
PATH_TOL = 1e-4  # logits of banded vs dense / kernel vs eager on the card, and vs the CPU run
# training, relative: each parameter's gradient difference (L2) over its
# gradient's norm, or over 1e-4 of the global norm where the exact gradient is
# 0 and only rounding is left (the attention bias shifts a softmax's logits
# alike); and each step's loss
TRAIN_TOL = 1e-4
TIMING_REPS = 60  # timed samples per median
GRAPH_LAUNCHES = 20  # launches per CUDA-graph replay


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ------------------------------------------------------------------ phase 1
def probe():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    require((ROOT / "erc_tpu_torch" / "csrc").is_dir(), f"no erc_tpu_torch package in {ROOT}")
    sys.path.insert(0, str(ROOT))
    from erc_tpu_torch.ops.kernels import build

    nvcc = build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    log(f"toolchain: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, nvcc '{nvcc_ver.stdout.strip().splitlines()[-1]}'")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for matmul and cudnn (float32 products run in full float32)")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"kernel build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s -> {build.build_dir()}")
    for name in libs:
        logf = build.build_dir() / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"  ptxas[{name}]: {line.strip()}")
    return smi


# ------------------------------------------------------------------ phase 2
def _median_event_ms(fn, reps=TIMING_REPS):
    """Median over `reps` of one call timed with CUDA events (host enqueue included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _median_graph_ms(fn, reps=TIMING_REPS):
    """Device time of one call: GRAPH_LAUNCHES calls captured in a CUDA graph,
    replayed `reps` times between events; median replay time / launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / GRAPH_LAUNCHES)
    del graph
    return statistics.median(times)


def _valid_taps(L, offsets):
    return sum(max(0, min(L, L - o) - max(0, -o)) for o in offsets)


def _bound(bytes_moved, flops):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _band_matrix(coef, L, offsets):
    """Dense [B, L, L] matrix A with A[b, v, v+off_k] = coef[b, v, k] (in range)."""
    import torch

    B = coef.shape[0]
    A = torch.zeros(B, L, L, device=coef.device, dtype=coef.dtype)
    v = torch.arange(L, device=coef.device)
    for k, off in enumerate(offsets):
        keep = (v + off >= 0) & (v + off < L)
        A[:, v[keep], (v + off)[keep]] = coef[:, keep, k]
    return A


def check_kernels():
    """K1/K2 against their plain versions on the card; returns per-kernel records."""
    import torch
    from erc_tpu_torch.ops.kernels import banded as kb

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    full, neg, pos = tuple(range(-5, 6)), tuple(range(-5, 0)), tuple(range(0, 6))
    wide = tuple(range(-10, 11))
    B, L, D, S = 32, 112, 100, 2
    cases_k1, cases_k2 = [], []
    # TransformerConv's aggregation: [B, L, 11] weights over a contiguous [B, L, D]
    cases_k1.append(("full", randn(B, L, 11), randn(B, L, D), full))
    # the RGCN's sub-ranges read Ysel[:, :, s, t, :], a strided view of [B, L, S, 2, D]
    ysel = randn(B, L, S, 2, D)
    cases_k1.append(("neg-strided", randn(B, L, 5), ysel[:, :, 1, 0, :], neg))
    cases_k1.append(("pos-strided", randn(B, L, 6), ysel[:, :, 0, 1, :], pos))
    cases_k1.append(("edge-L7-D13-K21", randn(2, 7, 21), randn(2, 7, 13), wide))
    cases_k2.append(("full", randn(B, L, D), randn(B, L, D), full))
    cases_k2.append(("edge-L7-D13-K21", randn(2, 7, 13), randn(2, 7, 13), wide))

    records = {}
    for name, fn, ref, cases in (
        ("banded_gather_sum", kb.banded_gather_sum, kb.banded_gather_sum_reference, cases_k1),
        ("banded_dot", kb.banded_dot, kb.banded_dot_reference, cases_k2),
    ):
        errs = []
        for label, x, y, offs in cases:
            got = fn(x, y, offs)
            torch.cuda.synchronize()
            want = ref(x, y, offs)
            err = (got - want).abs().max().item()
            require(math.isfinite(err) and err <= KERNEL_TOL,
                    f"{name}[{label}] max abs err {err} > {KERNEL_TOL}")
            errs.append(err)
            log(f"{name}[{label}] shape {tuple(y.shape)} K={len(offs)}: max abs err {err:.3e}")
        label, x, y, offs = cases[0]
        Bm, Lm, Dm = y.shape
        K = len(offs)
        taps = Bm * _valid_taps(Lm, offs)
        if name == "banded_gather_sum":
            bytes_moved = 4 * (Bm * Lm * K + 2 * Bm * Lm * Dm)
            A = _band_matrix(x, Lm, offs)
            library = lambda: torch.bmm(A, y)  # noqa: E731
        else:
            bytes_moved = 4 * (2 * Bm * Lm * Dm + Bm * Lm * K)
            yt = y.transpose(1, 2)
            library = lambda: torch.bmm(x, yt)  # noqa: E731
        bound_ms, bound_by = _bound(bytes_moved, 2 * taps * Dm)
        records[name] = {
            "name": name,
            "route": "cuda",
            "source": "erc_tpu_torch/csrc/banded.cu",
            "replaces": ("erc_tpu/ops/pallas/banded.py:117" if name == "banded_gather_sum"
                         else "erc_tpu/ops/pallas/banded.py:222"),
            "tpu_source": f"erc_tpu/ops/pallas/banded.py:{name}",
            "shape": f"B={Bm} L={Lm} D={Dm} K={K}",
            "max_abs_err": max(errs),
            "ms": _median_graph_ms(lambda: fn(x, y, offs)),
            "eager_ms": _median_event_ms(lambda: fn(x, y, offs)),
            "plain_ms": _median_graph_ms(lambda: ref(x, y, offs)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": _median_graph_ms(library),
        }
        log(f"{name} timing at {records[name]['shape']}: kernel {records[name]['ms']:.5f} ms "
            f"(eager call {records[name]['eager_ms']:.5f}), plain {records[name]['plain_ms']:.5f}, "
            f"bound {bound_ms:.5f} ({bound_by}), bmm {records[name]['library_ms']:.5f}")
    return records


def _dag_inputs(g, B, C, D, prefix=True, pad_rows=0):
    """K3's arguments as DAGStack builds them: a causal within-block mask in
    which i-1 always precedes i, additive -1e30 masks, float32-min columns past
    the dialogue, `pad_rows` trailing positions with no predecessor, batch
    row 0 an all-padding dialogue; the first block (prefix=False) has flag 1,
    no prefix (mp = float32 min / 2, den_p = 0)."""
    import torch

    f32min = torch.finfo(torch.float32).min
    rand = lambda *s: torch.rand(*s, device="cuda", generator=g)  # noqa: E731
    randn = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=g) * scale  # noqa: E731
    adj = (rand(B, C, C) < 0.6).float().tril(-1)
    adj[:, torch.arange(1, C), torch.arange(C - 1)] = 1.0
    adj[0] = 0.0
    colpad = torch.zeros(C, device="cuda")
    if pad_rows:
        adj[:, C - pad_rows :] = 0.0
        colpad[C - pad_rows :] = f32min
    amw = -(1.0 - adj) * 1e30 + colpad
    smw = (rand(B, C, C) < 0.5).float()
    if prefix:
        num01, den_p, mp = randn(B, C, D), rand(B, C) + 0.5, randn(B, C)
    else:
        num01 = torch.zeros(B, C, D, device="cuda")
        den_p = torch.zeros(B, C, device="cuda")
        mp = torch.full((B, C), f32min / 2, device="cuda")
    s = D**-0.5
    weights = (randn(3, D, D, scale=s), randn(3, D, scale=s), randn(3, D, D, scale=s),
               randn(3, D, scale=s), randn(D, D, scale=s), randn(D, D, scale=s), randn(D, 1, scale=s))
    return (0 if prefix else 1, randn(B, C), randn(B, C, 3, D), randn(B, C, 3, D), randn(B, C, D),
            num01, den_p, mp, amw, smw, *weights)


def check_dag_block():
    """K3 against its plain version on the card; returns its record."""
    import torch
    from erc_tpu_torch.ops.kernels import dag_block as kd

    g = torch.Generator(device="cuda").manual_seed(1)
    B, C, D = 32, 16, 300  # DAG-ERC serving: batch 32, dag_chunk 16, hidden 300
    cases = [
        ("full-prefix", _dag_inputs(g, B, C, D, prefix=True)),
        ("full-first-block", _dag_inputs(g, B, C, D, prefix=False)),
        ("full-padded-rows", _dag_inputs(g, B, C, D, prefix=True, pad_rows=5)),
        ("ragged-B3-C5-D13", _dag_inputs(g, 3, 5, 13, prefix=True, pad_rows=2)),
    ]
    errs = []
    for label, args in cases:
        got = kd.dag_block(*args)
        torch.cuda.synchronize()
        want = kd.dag_block_reference(*args)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        require(finite and math.isfinite(err) and err <= DAG_TOL,
                f"dag_block[{label}] max abs err {err} > {DAG_TOL} (finite outputs: {finite})")
        errs.append(err)
        log(f"dag_block[{label}] B={args[1].shape[0]} C={args[1].shape[1]} D={args[4].shape[-1]}: "
            f"max abs err {err:.3e} (tolerance {DAG_TOL})")
    args = cases[0][1]
    # bytes: each input read once, each output written once; operations: the eight
    # D x D products per (row, position), the gates, and the attention over the
    # c columns written before position c
    f32 = 4
    bytes_moved = f32 * (B * C * (1 + 6 * D + 2 * D + 2 + 2 * C)  # q, xcb, hppb, hb, num01, den_p, mp, masks
                         + 8 * D * D + 6 * D + D  # weights and biases
                         + B * C * (3 * D + 1))  # h1, V0w, V1w, Kw
    flops = B * C * (16 * D * D + 2 * D + 30 * D) + B * (C * (C - 1) // 2) * 4 * D
    bound_ms, bound_by = _bound(bytes_moved, flops)
    rec = {
        "name": "dag_block",
        "route": "cuda",
        "source": "erc_tpu_torch/csrc/dag_block.cu",
        "replaces": "erc_tpu/ops/pallas/dag_block.py:320",
        "tpu_source": "erc_tpu/ops/pallas/dag_block.py:dag_block",
        "shape": f"B={B} C={C} D={D}",
        "max_abs_err": max(errs),
        "ms": _median_graph_ms(lambda: kd.dag_block(*args)),
        "eager_ms": _median_event_ms(lambda: kd.dag_block(*args)),
        "plain_ms": _median_graph_ms(lambda: kd.dag_block_reference(*args)),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this recurrence
    }
    log(f"dag_block timing at {rec['shape']}: kernel {rec['ms']:.5f} ms (eager call "
        f"{rec['eager_ms']:.5f}), plain {rec['plain_ms']:.5f}, bound {bound_ms:.5f} ({bound_by}: "
        f"{bytes_moved / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP)")
    return rec


def _dag_bwd_work(B, C, D):
    """K4's least bytes (each input read once, each output written once) and
    operations: per (row, position) 9 D x D mat-vecs, the attention replayed
    over all C columns with its dot products and dV updates, the gates; the
    weight gradients' 8 D x D x B·C products and their sums."""
    f32 = 4
    rows = B * C * (1 + 6 * D + 2 * D + 2 + 2 * C)  # K3's per-row inputs
    rows += B * C * (3 * D + 1 + 6 * D)  # K3's outputs h1, V0, V1, Kw and residuals hpc, xpp
    rows += B * C * (3 * D + 1)  # cotangents
    rows += B * C * (1 + 6 * D + 2 * D + 2)  # per-row gradients
    weights = 2 * (8 * D * D + 6 * D + D)  # the weights read, their gradients written
    flops = B * C * (16 * D * D + 12 * C * D + 60 * D) + 16 * D * D * B * C + 8 * D * B * C
    return f32 * (rows + weights), flops


def check_dag_block_bwd():
    """K4 against its plain version on the card in K3's four cases, and K3's
    residuals against the plain version's; times at the training shape."""
    import torch
    from erc_tpu_torch.ops.kernels import dag_block as kd

    g = torch.Generator(device="cuda").manual_seed(2)
    B, C, D = 32, 16, 300
    cases = [
        ("full-prefix", _dag_inputs(g, B, C, D, prefix=True)),
        ("full-first-block", _dag_inputs(g, B, C, D, prefix=False)),
        ("full-padded-rows", _dag_inputs(g, B, C, D, prefix=True, pad_rows=5)),
        ("ragged-B3-C5-D13", _dag_inputs(g, 3, 5, 13, prefix=True, pad_rows=2)),
    ]
    errs = []
    for label, args in cases:
        outs = kd._forward(args[0], args[1:], residuals=True)
        cts = [torch.randn(o.shape, device="cuda", generator=g) for o in outs[:4]]
        got = kd.dag_block_backward(args[0], *args[1:], *outs, *cts)
        torch.cuda.synchronize()
        want_fwd = kd.dag_block_reference(args[0], *args[1:], residuals=True)
        res_err = max((a - b).abs().max().item() for a, b in zip(outs[4:], want_fwd[4:]))
        require(math.isfinite(res_err) and res_err <= DAG_TOL,
                f"dag_block residuals[{label}] max abs err {res_err} > {DAG_TOL}")
        want = kd.dag_block_backward_reference(args[0], *args[1:], *outs, *cts)
        worst = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            err = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
            require(bool(torch.isfinite(a).all()) and err <= DAG_BWD_TOL,
                    f"dag_block_bwd[{label}] gradient {i}: error {err} > {DAG_BWD_TOL} of max(1, max|plain|)")
            worst = max(worst, err)
        again = kd.dag_block_backward(args[0], *args[1:], *outs, *cts)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)), f"dag_block_bwd[{label}] not deterministic")
        errs.append(worst)
        log(f"dag_block_bwd[{label}] B={args[1].shape[0]} C={args[1].shape[1]} D={args[4].shape[-1]}: "
            f"max error {worst:.3e} of max(1, max|plain|) (tolerance {DAG_BWD_TOL}), residuals "
            f"{res_err:.3e}, bitwise repeatable")
    # times at DAG-ERC's training shape: batch 16
    Bt = 16
    args = _dag_inputs(g, Bt, C, D, prefix=True)
    outs = kd._forward(args[0], args[1:], residuals=True)
    cts = [torch.randn(o.shape, device="cuda", generator=g) for o in outs[:4]]
    bwd = lambda: kd.dag_block_backward(args[0], *args[1:], *outs, *cts)  # noqa: E731
    plain = lambda: kd.dag_block_backward_reference(args[0], *args[1:], *outs, *cts)  # noqa: E731
    bytes_moved, flops = _dag_bwd_work(Bt, C, D)
    bound_ms, bound_by = _bound(bytes_moved, flops)
    # the weight-gradient launch alone, and torch.einsum of the same contractions
    lib = kd._library("dag_block_bwd")
    st = [torch.randn(s, device="cuda", generator=g) for s in
          ((Bt, C, D), (Bt, C, 3, D), (Bt, C, 3, D), (Bt, C, D), (Bt, C, D), (Bt, C))]
    h1 = outs[0].contiguous()
    wgrads = tuple(torch.empty(s, device="cuda") for s in ((3, D, D), (3, D), (3, D, D), (3, D), (D, D), (D, D), (D, 1)))
    # the stream is read at each call: a CUDA graph captures on a side stream
    wgrad = lambda: kd._weight_grads_kernel(lib, h1, *st, wgrads, torch.cuda.current_stream().cuda_stream)  # noqa: E731
    wgrad()
    want = kd.weight_grads_reference(h1, *st)
    torch.cuda.synchronize()
    werr = max((a - b).abs().max().item() / max(1.0, b.abs().max().item()) for a, b in zip(wgrads, want))
    require(werr <= DAG_BWD_TOL, f"dag_block_bwd weight gradients: error {werr} > {DAG_BWD_TOL}")
    N = Bt * C
    w_bytes, w_flops = 4 * (N * D * 10 + N + 8 * D * D + 7 * D), 16 * D * D * N + 8 * D * N
    rec = {
        "name": "dag_block_bwd",
        "route": "cuda",
        "source": "erc_tpu_torch/csrc/dag_block_bwd.cu",
        "replaces": "erc_tpu/ops/pallas/dag_block.py:369",
        "tpu_source": "erc_tpu/ops/pallas/dag_block.py:_dag_block_bwd",
        "shape": f"B={Bt} C={C} D={D}",
        "max_abs_err": max(errs),
        "err_is_relative_to": "max(1, max|plain|) per gradient",
        "ms": _median_graph_ms(bwd),
        "eager_ms": _median_event_ms(bwd),
        "plain_ms": _median_graph_ms(plain),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the reverse sweep
        "wgrad_ms": _median_graph_ms(wgrad),
        "wgrad_bound_ms": _bound(w_bytes, w_flops)[0],
        "wgrad_library_ms": _median_graph_ms(lambda: kd.weight_grads_reference(h1, *st)),
        "wgrad_max_err": werr,
    }
    log(f"dag_block_bwd timing at {rec['shape']}: kernel {rec['ms']:.5f} ms (eager call "
        f"{rec['eager_ms']:.5f}), plain {rec['plain_ms']:.5f}, bound {bound_ms:.5f} ({bound_by}: "
        f"{bytes_moved / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP); weight-gradient launch alone "
        f"{rec['wgrad_ms']:.5f} ms (bound {rec['wgrad_bound_ms']:.5f}), torch.einsum of the same "
        f"{rec['wgrad_library_ms']:.5f} ms, error {werr:.3e}")
    k3 = lambda: kd.dag_block(*args)  # noqa: E731
    k3_res = lambda: kd._forward(args[0], args[1:], residuals=True)  # noqa: E731
    log(f"dag_block at the training shape B={Bt}: {_median_graph_ms(k3):.5f} ms, with residuals "
        f"{_median_graph_ms(k3_res):.5f} ms")
    return rec


# ------------------------------------------------------------------ phase 3
def _reset_launches():
    from erc_tpu_torch.ops.kernels import banded as kb, dag_block as kd

    kb.reset_launches()
    kd.reset_launches()


def _read_launches():
    import torch
    from erc_tpu_torch.ops.kernels import banded as kb, dag_block as kd

    torch.cuda.synchronize()
    return {**kb.launches, **kd.launches}


def _check_results(dialogues, results, n_classes=6):
    import numpy as np

    require(len(results) == len(dialogues), "one result per dialogue")
    for d, r in zip(dialogues, results):
        probs = np.asarray(r["probs"])
        require(probs.shape == (len(d["text"]), n_classes), f"probs shape {probs.shape}")
        require(bool(np.isfinite(probs).all()), "non-finite probs")
        require(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-5)), "probs rows do not sum to 1")


def _worst_logit_diffs(engine, others, dialogues):
    """Max abs difference of `engine`'s logits from each other engine's, per batch."""
    import numpy as np

    worst = [0.0] * len(others)
    for s in range(0, len(dialogues), engine.batch_size):
        batch = engine.batcher(dialogues[s : s + engine.batch_size])
        mine = engine.logits(batch)
        for i, other in enumerate(others):
            worst[i] = max(worst[i], float(np.abs(mine - other.logits(batch)).max()))
    return worst


def _latency_throughput(engine, dialogues, card, name):
    lat = engine.benchmark_latency(n=100, L=48)
    log(f"{name} latency (1 dialogue, L 32..48, batch padded to 32): p50 {lat['p50_ms']:.3f} ms, "
        f"p95 {lat['p95_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms on {card}")
    engine.predict(dialogues)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict(dialogues)
    dt = time.perf_counter() - t0
    log(f"{name} throughput: {reps * len(dialogues) / dt:.1f} dialogues/s "
        f"({len(dialogues)} dialogues, batch 32, predict end to end) on {card}")
    return dt / reps


def _dialogues():
    from erc_tpu_torch.data.synthetic import synthetic_erc

    dialogues = synthetic_erc("iemocap-cogmen", 6, n_train=64)
    lens = [len(d["text"]) for d in dialogues]
    return dialogues, f"{len(dialogues)} dialogues (lengths {min(lens)}..{max(lens)})"


def drive_cogmen(card: str):
    import numpy as np
    import torch
    from erc_tpu_torch.serve import InferenceEngine, make_http_server

    kw = dict(dataset="synthetic-cogmen-6", encoder_mode="chained", batch_size=32)
    engine = InferenceEngine.from_module("cogmen", graph_impl="banded", **kw)
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"engine: COGMEN banded/chained, {n_params} params, batch 32, on "
        f"{torch.cuda.get_device_name(0)}")
    dialogues, desc = _dialogues()
    n_batches = -(-len(dialogues) // engine.batch_size)

    _reset_launches()
    results = engine.predict(dialogues)
    launches = _read_launches()
    log(f"COGMEN path: {desc} in {n_batches} batches; launches {launches}")
    require(launches["banded_gather_sum"] == 5 * n_batches,
            f"banded_gather_sum launched {launches['banded_gather_sum']} times, want {5 * n_batches}")
    require(launches["banded_dot"] == n_batches,
            f"banded_dot launched {launches['banded_dot']} times, want {n_batches}")
    _check_results(dialogues, results)

    # banded ≡ dense on the card, and ≡ the CPU run of the same weights
    dense = InferenceEngine.from_module("cogmen", graph_impl="dense", **kw)
    dense.model.load_state_dict(engine.model.state_dict())
    cpu = InferenceEngine.from_module("cogmen", graph_impl="banded", device="cpu", **kw)
    cpu.model.load_state_dict(engine.model.state_dict())
    worst_dense, worst_cpu = _worst_logit_diffs(engine, [dense, cpu], dialogues)
    log(f"COGMEN logits: banded vs dense on the card max abs diff {worst_dense:.3e}; "
        f"card vs CPU {worst_cpu:.3e} (tolerance {PATH_TOL})")
    require(worst_dense <= PATH_TOL, f"banded vs dense {worst_dense} > {PATH_TOL}")
    require(worst_cpu <= PATH_TOL, f"card vs CPU {worst_cpu} > {PATH_TOL}")

    # one dialogue: the batch carries 31 all-padding dialogues
    one = engine.predict([dialogues[0]])[0]
    require(bool(np.isfinite(np.asarray(one["probs"])).all()), "single-dialogue probs not finite")

    # HTTP round trip on a free port
    srv = make_http_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        for d in dialogues[:2]:
            payload = {"dialogues": [{k: np.asarray(d[k]).tolist() for k in ("text", "audio", "visual")}
                                     | {"speakers": d["speakers"]}]}
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}/", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                out = json.loads(resp.read())
            require(len(out["results"][0]["pred"]) == len(d["text"]), "HTTP result length")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    log("http: 2 requests answered")

    wall = _latency_throughput(engine, dialogues, card, "COGMEN")
    profile_predict(engine, dialogues, wall, n_batches)
    return launches


# ------------------------------------------------------------------ phase 4
def drive_dagerc(card: str):
    import torch
    from erc_tpu_torch.data.collate import bucket_length
    from erc_tpu_torch.serve import InferenceEngine

    kw = dict(dataset="synthetic-cogmen-6", batch_size=32)
    engine = InferenceEngine.from_module("dagerc", **kw)  # dag_impl=auto: K3 in eval
    p = engine.params
    n_params = sum(t.numel() for t in engine.model.parameters())
    log(f"engine: DAG-ERC {p.hidden_all} -> {p.hidden_dim}, {p.gnn_layers} layers, chunk "
        f"{p.dag_chunk}, {n_params} params, batch 32, on {torch.cuda.get_device_name(0)}")
    dialogues, desc = _dialogues()
    chunks = [dialogues[s : s + engine.batch_size] for s in range(0, len(dialogues), engine.batch_size)]
    blocks = 0
    for chunk in chunks:
        L = bucket_length(max(len(d["text"]) for d in chunk), p.length_bucket, p.max_seq_len)
        C = min(p.dag_chunk, L)
        blocks += -(-L // C)
    want = p.gnn_layers * blocks

    _reset_launches()
    results = engine.predict(dialogues)
    launches = _read_launches()
    log(f"DAG-ERC path: {desc} in {len(chunks)} batches, {blocks} blocks of {p.dag_chunk}; "
        f"launches {launches}")
    require(launches["dag_block"] == want, f"dag_block launched {launches['dag_block']} times, want {want}")
    _check_results(dialogues, results)

    # kernel ≡ the eager form on the card, and ≡ the CPU run of the same weights
    eager = InferenceEngine.from_module("dagerc", dag_impl="eager", **kw)
    eager.model.load_state_dict(engine.model.state_dict())
    cpu = InferenceEngine.from_module("dagerc", device="cpu", **kw)
    cpu.model.load_state_dict(engine.model.state_dict())
    worst_eager, worst_cpu = _worst_logit_diffs(engine, [eager, cpu], dialogues)
    log(f"DAG-ERC logits: kernel vs eager on the card max abs diff {worst_eager:.3e}; "
        f"card vs CPU {worst_cpu:.3e} (tolerance {PATH_TOL})")
    require(worst_eager <= PATH_TOL, f"kernel vs eager {worst_eager} > {PATH_TOL}")
    require(worst_cpu <= PATH_TOL, f"card vs CPU {worst_cpu} > {PATH_TOL}")

    # one dialogue: the batch carries 31 all-padding dialogues
    one = engine.predict([dialogues[0]])
    _check_results(dialogues[:1], one)
    t_eager = _latency_throughput(eager, dialogues, card, "DAG-ERC eager form")
    wall = _latency_throughput(engine, dialogues, card, "DAG-ERC")
    log(f"DAG-ERC predict of {len(dialogues)} dialogues: {wall * 1e3:.3f} ms through K3, "
        f"{t_eager * 1e3:.3f} ms in the eager form")
    profile_predict(engine, dialogues, wall, len(chunks))
    return launches


def profile_predict(engine, dialogues, wall_s: float, n_batches: int):
    """Device time by kernel over one predict of `dialogues`."""
    _profile(lambda: engine.predict(dialogues),
             f"predict of {len(dialogues)} dialogues ({n_batches} batches)", wall_s)


def _profile(fn, what: str, wall_s: float):
    """Device time by kernel over one call of `fn` (torch.profiler), against
    the unprofiled wall time of the same call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    n_kernels = sum(e.count for e in kernels)
    log(f"profile: {what}: {n_kernels} kernel launches, device busy {busy_ms:.3f} ms of "
        f"{wall_s * 1e3:.3f} ms unprofiled wall ({100 * busy_ms / (wall_s * 1e3):.1f}% busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<5d} {e.key[:100]}")


# ------------------------------------------------------------------ phase 5
TRAIN_ARGS = ["--dataset=synthetic-iemocap-6", "--reimplement", "--dag_impl=kernel"]


def _trainer(*extra, device="cuda", dropout=None):
    """A DAGERCTrainer at the IEMOCAP reimplement settings (one epoch; weights
    from seed 1, the same on every device)."""
    from erc_tpu_torch.models import dagerc

    p = dagerc.DAGERCParams()
    p.finalize([*TRAIN_ARGS, f"--device={device}", *extra])
    p.epoch = 1  # --reimplement sets the published 55
    if dropout is not None:
        p.dropout = dropout
    trainer = dagerc.DAGERCTrainer(p)
    trainer.log = lambda msg: log(f"  [trainer] {msg}")
    trainer.initialize()
    return trainer


def _blocks(batch, chunk: int) -> int:
    L = batch["input_tensor"].shape[1]
    return -(-L // min(chunk, L))


def _worst_grad_diff(model, other):
    """Worst over parameters of ||g - g_other|| / max(||g_other||, 1e-4 · global
    norm), and that parameter's name."""
    import torch

    pairs = [(n, a.grad, b.grad.to(a.device)) for (n, a), b in zip(model.named_parameters(), other.parameters())]
    total = torch.sqrt(sum((b.double() ** 2).sum() for _, _, b in pairs)).item()
    worst, name = 0.0, ""
    for n, a, b in pairs:
        d = (a.double() - b.double()).norm().item() / max(b.double().norm().item(), 1e-4 * total)
        if not math.isfinite(d) or d > worst:
            worst, name = d, n
    return worst, name


def drive_training(card: str):
    import torch
    from erc_tpu_torch.data.loader import to_device

    kern = _trainer()
    p = kern.params
    n_params = sum(t.numel() for t in kern.model.parameters())
    require(n_params == 6_026_710, f"DAG-ERC has {n_params} parameters, want 6026710")
    log(f"trainer: DAG-ERC {p.hidden_all} -> {p.hidden_dim}, {p.gnn_layers} layers, chunk {p.dag_chunk}, "
        f"dag_remat {p.dag_remat}, batch {p.train.batch_size}, {p.optim.name} lr {p.optim.lr}, dropout "
        f"{p.dropout}, clip 5.0, {n_params} params, dag_impl kernel, on {torch.cuda.get_device_name(0)}")
    eager = _trainer("--dag_impl=eager")
    require(all(torch.equal(a, b) for a, b in zip(kern.model.state_dict().values(),
                                                   eager.model.state_dict().values())),
            "kernel and eager trainers start from different weights")
    layers, chunk = int(p.gnn_layers), int(p.dag_chunk)
    host = list(kern.make_loader("train"))  # epoch 0: the batches train() will take
    batches = [to_device(b, kern.device) for b in host[:3]]

    # one forward and backward: launches by the formula, gradients ≡ the eager form
    _reset_launches()
    kern.compute_grads(batches[0])
    launches = _read_launches()
    nb = _blocks(host[0], chunk)
    log(f"train step of one batch (L {host[0]['input_tensor'].shape[1]}, {nb} blocks): launches {launches}")
    require(launches["dag_block"] == 2 * layers * nb,
            f"dag_block launched {launches['dag_block']} times, want {2 * layers * nb} (remat: twice per block)")
    require(launches["dag_block_bwd"] == layers * nb,
            f"dag_block_bwd launched {launches['dag_block_bwd']} times, want {layers * nb}")
    eager.compute_grads(batches[0])
    worst, name = _worst_grad_diff(kern.model, eager.model)
    log(f"first-batch gradients, kernel vs eager form on the card: worst {worst:.3e} ({name}), "
        f"tolerance {TRAIN_TOL}")
    require(worst <= TRAIN_TOL, f"kernel vs eager gradients {worst} ({name}) > {TRAIN_TOL}")

    # three steps of each form on the same batches and dropout masks
    secs, losses = {}, {}
    for label, t in (("kernel", kern), ("eager", eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [t.train_step(b)["Lall"] for b in batches]
        losses[label] = [x.item() for x in out]
        secs[label] = time.perf_counter() - t0
    n3 = sum(int((b["text_length"] > 0).sum()) for b in host[:3])
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernel"], losses["eager"]))
    log(f"3 train steps, losses kernel {losses['kernel']} vs eager {losses['eager']}: worst relative "
        f"diff {rel:.3e} (tolerance {TRAIN_TOL})")
    require(rel <= TRAIN_TOL, f"kernel vs eager losses differ by {rel} > {TRAIN_TOL}")
    log(f"3 train steps of {n3} dialogues: kernel form {secs['kernel'] * 1e3:.3f} ms "
        f"({n3 / secs['kernel']:.1f} dialogues/s), eager form {secs['eager'] * 1e3:.3f} ms "
        f"({n3 / secs['eager']:.1f} dialogues/s) on {card}")
    del eager

    # the card against a CPU run of the same weights, without dropout
    card0, cpu0 = _trainer(dropout=0.0), _trainer(device="cpu", dropout=0.0)
    loss_card = card0.compute_grads(batches[0])["Lall"].item()
    t0 = time.perf_counter()
    loss_cpu = cpu0.compute_grads(to_device(host[0], torch.device("cpu")))["Lall"].item()
    t_cpu = time.perf_counter() - t0
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    worst, name = _worst_grad_diff(card0.model, cpu0.model)
    log(f"card vs CPU, first batch: loss {loss_card:.7f} vs {loss_cpu:.7f} (relative {rel:.3e}), "
        f"gradients worst {worst:.3e} ({name}); tolerance {TRAIN_TOL}; CPU step {t_cpu:.2f} s")
    require(rel <= TRAIN_TOL and worst <= TRAIN_TOL, f"card vs CPU: loss {rel}, gradients {worst} ({name})")
    del card0, cpu0

    # the main path: one epoch (120 dialogues) and test() through DAGERCTrainer.train
    run = _trainer()
    train_blocks = sum(_blocks(b, chunk) for b in host)
    test_blocks = sum(_blocks(b, chunk) for b in run.make_loader("test"))
    _reset_launches()
    t0 = time.perf_counter()
    history = run.train()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    want = {"dag_block": 2 * layers * train_blocks + layers * test_blocks, "dag_block_bwd": layers * train_blocks}
    rec = history[0]
    log(f"DAG-ERC training path: {rec['steps']} steps over {rec['dialogues']} dialogues "
        f"({train_blocks} blocks), then test() ({test_blocks} blocks) in {wall:.3f} s; launches {launches}")
    for name, n in want.items():
        require(launches[name] == n, f"{name} launched {launches[name]} times on the training path, want {n}")
    res = rec["test"]
    require(all(math.isfinite(x) for x in (rec["Lall"], rec["gnorm"], res["Lall"], res["f1"])),
            f"non-finite training results {rec}")
    log(f"epoch 0: loss {rec['Lall']:.5f}, gnorm {rec['gnorm']:.5f}; test loss {res['Lall']:.5f}, "
        f"weighted F1 {res['f1']:.5f}, acc {res['acc']:.5f}")
    log(f"DAG-ERC training throughput, kernel form: {rec['dialogues'] / rec['seconds']:.1f} dialogues/s "
        f"({rec['steps']} steps, batch {p.train.batch_size}, {rec['seconds'] * 1e3:.3f} ms) on {card}")

    longest = max(host, key=lambda b: b["input_tensor"].shape[1])
    batch = to_device(longest, run.device)
    run.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.train_step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    _profile(lambda: run.train_step(batch), f"one train step of the longest batch (batch 16, L "
             f"{longest['input_tensor'].shape[1]}, {_blocks(longest, chunk)} blocks)", step_s)
    return launches


def main() -> int:
    import torch

    card = probe()
    records = check_kernels()
    records["dag_block"] = check_dag_block()
    records["dag_block_bwd"] = check_dag_block_bwd()
    launches = drive_cogmen(card)
    launches["dag_block"] = drive_dagerc(card)["dag_block"]
    train = drive_training(card)
    launches["dag_block_bwd"] = train["dag_block_bwd"]
    records["dag_block"]["train_launches"] = train["dag_block"]
    for name, rec in records.items():
        rec["launches"] = launches[name]
        require(rec["launches"] > 0, f"{name} was not launched on its path")
        rec["max_err"], rec["kernel_ms"] = rec["max_abs_err"], rec["ms"]
    log(f"chip_smoke wall time: {time.perf_counter() - T_START:.1f} s (kernel build included)")
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
