#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (erc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. probe the toolchain and the card, build the CUDA kernels from csrc/;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the serving path gives it, and time kernel, plain version and a
     library yardstick;
  3. drive COGMEN serving at full width (712 → 100, 2-layer encoder,
     banded graph) through InferenceEngine: predict, banded ≡ dense, a
     single-dialogue request, an HTTP round trip, latency and throughput;
  4. print one JSON line of kernel records, the card's name and power
     limit, and a last JSON line {"ok": true, "device": {...}}.
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

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
KERNEL_TOL = 1e-5  # float32; kernel and plain version differ only in summation order
PATH_TOL = 1e-4  # logits of banded vs dense on the card, and vs the CPU run
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


# ------------------------------------------------------------------ phase 3
def drive_main_path(card: str):
    import numpy as np
    import torch
    from erc_tpu_torch.data.synthetic import synthetic_erc
    from erc_tpu_torch.ops.kernels import banded as kb
    from erc_tpu_torch.serve import InferenceEngine, make_http_server

    kw = dict(dataset="synthetic-cogmen-6", encoder_mode="chained", batch_size=32)
    engine = InferenceEngine.from_module("cogmen", graph_impl="banded", **kw)
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"engine: COGMEN banded/chained, {n_params} params, batch 32, on "
        f"{torch.cuda.get_device_name(0)}")
    dialogues = synthetic_erc("iemocap-cogmen", 6, n_train=64)
    lens = [len(d["text"]) for d in dialogues]
    n_batches = -(-len(dialogues) // engine.batch_size)

    kb.reset_launches()
    results = engine.predict(dialogues)
    torch.cuda.synchronize()
    launches = dict(kb.launches)
    log(f"main path: {len(dialogues)} dialogues (lengths {min(lens)}..{max(lens)}) in "
        f"{n_batches} batches; launches {launches}")
    require(launches["banded_gather_sum"] == 5 * n_batches,
            f"banded_gather_sum launched {launches['banded_gather_sum']} times, want {5 * n_batches}")
    require(launches["banded_dot"] == n_batches,
            f"banded_dot launched {launches['banded_dot']} times, want {n_batches}")
    require(len(results) == len(dialogues), "one result per dialogue")
    for d, r in zip(dialogues, results):
        probs = np.asarray(r["probs"])
        require(probs.shape == (len(d["text"]), 6), f"probs shape {probs.shape}")
        require(bool(np.isfinite(probs).all()), "non-finite probs")
        require(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-5)), "probs rows do not sum to 1")

    # banded ≡ dense on the card, and ≡ the CPU run of the same weights
    dense = InferenceEngine.from_module("cogmen", graph_impl="dense", **kw)
    dense.model.load_state_dict(engine.model.state_dict())
    cpu = InferenceEngine.from_module("cogmen", graph_impl="banded", device="cpu", **kw)
    cpu.model.load_state_dict(engine.model.state_dict())
    worst_dense = worst_cpu = 0.0
    for s in range(0, len(dialogues), engine.batch_size):
        batch = engine.batcher(dialogues[s : s + engine.batch_size])
        banded = engine.logits(batch)
        worst_dense = max(worst_dense, float(np.abs(banded - dense.logits(batch)).max()))
        worst_cpu = max(worst_cpu, float(np.abs(banded - cpu.logits(batch)).max()))
    log(f"logits: banded vs dense on the card max abs diff {worst_dense:.3e}; "
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

    lat = engine.benchmark_latency(n=100, L=48)
    log(f"latency (1 dialogue, L 32..48, batch padded to 32): p50 {lat['p50_ms']:.3f} ms, "
        f"p95 {lat['p95_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms on {card}")
    engine.predict(dialogues)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict(dialogues)
    dt = time.perf_counter() - t0
    log(f"throughput: {reps * len(dialogues) / dt:.1f} dialogues/s "
        f"({len(dialogues)} dialogues, batch 32, predict end to end) on {card}")
    profile_predict(engine, dialogues, dt / reps, n_batches)
    return launches


def profile_predict(engine, dialogues, wall_s: float, n_batches: int):
    """Device time by kernel over one predict of `dialogues` (torch.profiler),
    against the unprofiled wall time of the same call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.predict(dialogues)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    n_kernels = sum(e.count for e in kernels)
    log(f"profile: predict of {len(dialogues)} dialogues ({n_batches} batches): "
        f"{n_kernels} kernel launches, device busy {busy_ms:.3f} ms of {wall_s * 1e3:.3f} ms "
        f"unprofiled wall ({100 * busy_ms / (wall_s * 1e3):.1f}% busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<5d} {e.key[:100]}")


def main() -> int:
    import torch

    card = probe()
    records = check_kernels()
    launches = drive_main_path(card)
    for name, rec in records.items():
        rec["launches"] = launches[name]
        rec["max_err"], rec["kernel_ms"] = rec["max_abs_err"], rec["ms"]
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
