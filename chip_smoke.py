#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (erc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. probe the toolchain and the card, build the CUDA kernels from csrc/ and
     the host batch packer (csrc/collate.cpp, g++);
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the model paths give it (K1/K2 banded and K1ᵀ, the band's
     transposed index mode that their backward uses, in both
     instantiations, 16-byte and 4-byte; K1/K2's autograd Functions against
     autograd through the plain versions; K3 dag_block in both variants,
     cluster and stream, and K4 dag_block_bwd in all three, cluster, stream
     and global, bit for bit across repeats, C = 64 and C = 128 at D = 300
     in K4), and time kernel (graph and eager call), plain version and,
     where one exists, a library yardstick (graph and eager call); K1/K2/K1ᵀ
     also at batch 256, K3 also at batch 16 and in its other cluster plans
     (rows a cluster, columns a block), K4 also in its stream variant and
     at C = 128 in its global one, with the cards' cluster occupancy and
     each cluster kernel's phase cycles;
  3. drive COGMEN serving at full width (712 → 100, 2-layer encoder,
     banded graph) through InferenceEngine: predict (every K1/K2 launch
     16-byte), banded ≡ dense, a single-dialogue request, an HTTP round
     trip, latency, throughput and profile;
  4. drive DAG-ERC serving at full width (712 → 300, 4 DAG layers, chunk
     16) through InferenceEngine: predict through K3 (every launch in the
     cluster variant), kernel ≡ eager form, card ≡ CPU, a single-dialogue
     request, latency, throughput, profile;
  5. drive DAG-ERC training at full width with the IEMOCAP reimplement
     settings (batch 16, AdamW 5e-4, dropout 0.2, clip 5.0, dag_remat)
     through DAGERCTrainer with dag_impl=kernel (K3 forward and K4
     backward, every launch of either in the cluster variant): gradients
     and 3 steps' losses ≡ the eager form, gradients at dag_chunk 64 and
     128 (K4's global variant) ≡ the eager form, card ≡ CPU, one epoch and
     test(), launch counts, dialogues/s, profile of one step;
  6. drive COGMEN training at full width with bench.py's parity config
     (batch 32, max_seq_len 96, Adam 1e-4, dropout 0.5) through
     COGMENTrainer with the banded graph (K1/K2 forward, K1ᵀ, K1 and K2
     backward, every launch 16-byte): launches of one step, gradients and 3
     steps' losses ≡ the dense graph's, card ≡ CPU, one epoch and test()
     with launch counts, dialogues/s banded vs dense, profile of one step,
     and main() → saved model → InferenceEngine with the trainer's logits;
  7. drive DialogueGCN serving at full width (712 → 2-layer biLSTM 200,
     wp = wf = 10, RGCN of 30 bases + GraphConv, banded graph) through
     InferenceEngine with cuDNN's TF32 flag on: predict (5 K1 and 1 K2 a
     batch, by tap-count instantiation: the RGCN's K = 10 taps in the
     generic one), banded ≡ dense, card ≡ CPU, a single-dialogue request,
     latency, throughput and profile, banded and dense;
  8. drive DialogueGCN training (DGCNParams: batch 32, Adam 3e-4, dropout
     0.4, IEMOCAP-6 class weights; max_seq_len 96) through DGCNTrainer, TF32
     flag still on: launches of one step (K1 6, K2 5, K1ᵀ 6) by
     instantiation, gradients and 3 steps' losses ≡ the dense graph's, card
     ≡ CPU at dropout 0, one epoch and test() with launch counts,
     dialogues/s banded vs dense, profile of one step, and main() → saved
     model → InferenceEngine with the trainer's logits;
  9. drive MMGCN serving at full width (712 -> 200, 2-layer text biLSTM,
     the [B, 3L, 3L] angular-similarity graph, 64 GCNII layers of 200)
     through InferenceEngine with cuDNN's TF32 flag on, dense and structured
     adjacency: predict (no hand-written kernel launched: its graph products
     are torch.bmm), structured ≡ dense, card ≡ CPU, a single-dialogue
     request, latency, throughput and profile of both forms;
 10. drive MMGCN training at the IEMOCAP reimplement settings (batch 16,
     Adam 3e-4 with L2 3e-5, dropout 0.4, gcn_remat full; max_seq_len 96)
     through MMGCNTrainer, TF32 flag still on: remat full ≡ off gradients at
     dropout 0.4 from one generator state, structured ≡ dense gradients and
     3 steps' losses, card ≡ CPU at dropout 0, one epoch and test() with no
     kernel launched, dialogues/s dense vs structured, profiles of one step,
     and main() → saved model → InferenceEngine with the trainer's logits;
 11. drive DialogueGCN v2 serving at full width (712 -> DialogueRNN with
     D_g = D_p = 150 and 100 a direction, or a 2-layer biLSTM/biGRU of 100,
     or a linear base; wp = wf = 10, RGCN of 30 bases + GraphConv, nodal
     attention) through InferenceEngine, TF32 flag still on: with the
     DialogueRNN and the biLSTM base, predict (no hand-written kernel
     launched), card ≡ CPU, a single-dialogue request, latency, throughput
     and profile; with the biGRU and the linear base, one batch card ≡ CPU;
 12. drive DialogueGCN v2 training (DGCNV2Params, DialogueRNN base: batch
     32, Adam 3e-4, dropout 0.5, IEMOCAP-6 class weights; max_seq_len 96)
     through DGCNV2Trainer: card ≡ CPU at dropout 0 (gradients and 3 steps'
     losses), one epoch and test() with no kernel launched, dialogues/s,
     profile of one step, and main() → saved model → InferenceEngine with
     the trainer's logits;
 13. drive the DailyDialog token track's training at full width
     (DGCNV2DailyParams: vocabulary 20 000, embedding 300, 50 words, TextCNN
     -> 100, biLSTM of 100, L 128, batch 32) through DGCNV2DailyTrainer:
     card ≡ CPU at dropout 0 (the embedding's gradient included), one epoch
     and test() with no kernel launched, dialogues/s, profile of one step;
 14. drive CIM serving at full width (synthetic-cogmen-6 geometry: three
     biGRUs of 200 a direction, adapters to 100, six cross-modal
     attentions, heads 6 and 7) through InferenceEngine, TF32 flag still on:
     predict (no hand-written kernel launched), card ≡ CPU for both heads, a
     single-dialogue request, latency, throughput and profile;
 15. drive CIM training on synthetic-mosei-2 (CIMParams: batch 16, Adam 1e-3,
     dropout 0.3, the multitask loss Lce + Lmulti) through CIMTrainer: card ≡
     CPU at dropout 0 (gradients and 3 steps' losses), then one epoch with
     the val stage and --select_on=val and test() with the multilabel block
     (no kernel launched), model.best_val.ckpt served with the trainer's
     logits exactly, dialogues/s, profile of one step;
 16. drive the MMIN family's training at full width on synthetic-mmin-4 (audio
     130 x up to 128 frames, visual 50 x 342, text 22 x 1024 -> LSTMs of 128,
     TextCNN 3 x 128 -> 128, classifier 128/128 -> 4; batch 32, Adam 2e-4,
     EMA 0.999) through MMINBaseTrainer, MMINMissTrainer (ResidualAE
     (256, 128, 64) x 5, a frozen pretrained encoder) and MMINMiss2Trainer
     (twin nets): parameter counts against the JAX trees', card ≡ CPU at
     dropout 0 (gradients, 3 steps' losses, the EMA shadow; the shadow also
     against its formula at alpha 0.5, where it moves), one epoch with
     the val stage and --select_on=val (Acc2 in the val row and the test
     result; no kernel launched), model.best_val.ckpt in a fresh trainer
     giving its raw and EMA logits bit for bit, mmin_base's best_val as
     --pretrain_path of the other two (loaded exactly; the frozen encoder
     does not move), utterances/s and a profile of one step;
 17. the precision knobs (drive_precision): for every configuration that
     trains in bfloat16 at its phase's width (COGMEN dense, DAG-ERC's eager
     form at L <= 32, DialogueGCN dense, MMGCN dense, DialogueGCN v2 with the
     biLSTM, the token track, CIM, the three MMIN modules): the captured
     bfloat16 step ≡ the eager one over two buckets as above, the card's
     bfloat16 gradients against the CPU port's on 4 rows (loss within 2e-2;
     each gradient within 5e-2 of its norm beyond the larger of the two
     steps' own bfloat16 errors), 3 eager steps bfloat16 vs float32 within
     5e-2 at dropout 0, and float32 -> bfloat16 wall and busy of a replayed
     step and an epoch's rate (information); then --transfer_dtype=bfloat16
     (a COGMEN epoch ≡ the float32 transfer of the rounded batches, half the
     staged bytes), a TF32 step within 1e-2 of the strict one with torch's
     settings restored, the bfloat16 refusals raising on the card, and K3's
     launches in a bfloat16-trained DAG-ERC's float32 test stage against a
     device trace;
 18. the rest of the train loop (drive_pipeline): --steps_per_call=4, one
     replay of a group of 4 batches ≡ 4 eager steps from one state bit for
     bit (each step's losses and gnorm, parameters, gradients, buffers,
     optimizer state, LR and schedule count, generator, EMA shadow) for
     COGMEN banded (K1/K2/K1ᵀ), DAG-ERC's kernel form (K3/K4), mmin_miss,
     COGMEN dense in bfloat16, lars under a Cos schedule (each step's LR
     against the host curve within 1e-6) and AdamW with split_wd=1; a
     replay's launches 4 x one step's, held against a device trace; one
     capture a (K, bucket) and a leftover batch through the single-step
     graph; --eval_steps_per_call=4 ≡ K = 1 bit for bit (COGMEN banded,
     DAG-ERC kernel form, mmin_miss's raw and EMA logits); the native
     packer's batches ≡ numpy's; and, for information, replayed step wall
     and busy at K = 1 against 4, epoch rates at K = 1 and 4 with prefetch
     on and off (DialogueRNN: the step's walls only), and host batching of a 64-dialogue
     predict, native against numpy (and its text features alone, packed on
     one thread and on 4);
 19. the runtime around the train loop (drive_runtime), in a fresh experiment
     root (every trainer of the script writes its runs under a temporary
     ERC_TPU_EXPROOT, git snapshots off, each phase's runs dropped after it):
     COGMEN banded at full width through its entry point (models.cogmen.main)
     for 2 epochs of 8 batches (one length bucket) at --steps_per_call=4 with
     --checkpoint_per_step=6, --profile_steps=4, --nan_guard, --eval_first,
     --tensorboard and --remote_url pointed at a stub HTTP server on
     127.0.0.1, MemoryMonitor and the phase's own callback hooked: the run's
     files (the JAX layout's and the knobs'), step checkpoints at the
     thresholds that its calls give (epoch_end false, the resume hash), one
     train POST an epoch and one test POST a test stage (EvalFirst's first),
     K1/K2/K1ᵀ in the profile's Chrome trace as the launch counts moved over
     the profiled steps, MemoryMonitor's in-use and peak above 0 and below the
     card's memory, device_memory_stats() not None, and the same run with every
     callback off giving the same losses, test F1 and parameters bit for bit;
     DAG-ERC's kernel form with --profile_steps=2 (K3 8 and K4 4 a block of 16
     a step in the trace); NaNGuard raising over replayed K = 4 groups after a
     parameter is set to NaN in place (its checkpoint epoch_end false) and
     --debug_nans raising, eagerly, on a NaN input with the module's name; and,
     for information, COGMEN dense's step FLOPs (core.flops, card ≡ CPU: a hard
     check) over its replayed busy time, cli mem's report, cli warm's capture
     seconds and the epoch rates with the callbacks on and off;
 20. data-parallel training (drive_ddp, parallel/mesh.py): (b) two ranks
     of scripts/torch_mp_worker.py in their own processes, sharing the card
     (so gloo, and eager steps), whose group the worker starts from the
     --coordinator flags before it builds a trainer, as the entry points do: COGMEN banded at full width and DAG-ERC's kernel form at the
     IEMOCAP reimplement settings, dropout 0, 3 steps and test() each,
     against one process on the card (losses within rtol 2e-5 and atol 2e-6,
     the ranks within rtol 1e-6 of each other, test F1 equal), the batch
     norm's running statistics equal on both ranks, one run directory that
     rank 0 alone wrote, and each rank's K1/K2/K1ᵀ (6 + 2 + 6 a step) and
     K3/K4 (8 and 4 a block of 16 a step) launches; then (a) 3 replayed
     COGMEN banded steps and a replayed group of 2 without a group (timed
     then), and the same with this process as the one rank of an NCCL group
     started from the same flags (the gradient all-reduce captured in the
     graph, twice in the group's): bit for bit in every step's metrics and
     every tensor the step touches, one capture of each, the grouped steps'
     K1/K2/K1ᵀ launches (6 + 2 + 6 a step, counted from 0 around them), a
     device trace of a replay against the launch counts (and NCCL's
     operations in it), and, for information, a replayed step's wall and
     busy time with and without the group and the ranks' step walls against
     one process's; and (b) again at MeshSpec(data=1, model=2), the mesh's
     model axis (each rank steps its half of the split parameters, views of
     the full ones, and keeps only that half's moments; the blocks are
     all-gathered after each step): the same checks against the same
     one-process run, each rank's K1/K2/K1ᵀ/K3/K4 launches
     (`model_axis_launches`, per rank), and each rank keeping fewer of the
     allocator's bytes after its steps than a data-parallel rank (which
     keeps one process's parameters and moments), the bytes and peaks
     printed beside the moments' bytes counted.  The phase's launches
     (`ddp_launches`) are the data-parallel gloo ranks' and the NCCL rank's
     steps' alone;
 21. feature extraction (drive_preprocess, erc_tpu_torch/preprocess/), with
     TF32 allowed in cuBLAS and cuDNN's convolutions for the phase, so that
     the extractors' own full-float32 scope is what keeps them exact (the
     settings checked restored after every call): the acoustic entry
     (`python -m erc_tpu_torch.preprocess acoustic`, in this process) on 16
     fabricated 16 kHz wavs of 2-8 s, fbank, MFCC and STFT, against the same
     entry with --device=cpu (fbank and MFCC 1e-4 abs beyond twice the CPU
     run's own float32 deviation from a float64 evaluation, STFT 1e-4 of
     max |X|); the TSN ResNet-50 (2048-d) on 16 clips x 8 segments x 224^2
     uint8 (card vs the CPU port on 2 clips, 1e-4 of max |feature|; the
     batch vs per-clip calls 1e-5; finite); 3 single 480 x 720 clips through
     crop_speaker_half and the frame preprocessing; TSMRecognizer (6
     classes, 8 segments) on 4 clips; X3D-M (feature 432) on 4 clips x 16 x
     224^2; the dialogue walk (a fabricated release tree and COGMEN dump, 2
     dialogues x 8 utterances of 1-3 s at 30 fps, 480 x 720, read_video
     injected) through the iemocap-cogmen-video-4 view and
     extract_dialogue_features (every dialogue (8, 2048), equal to
     per-utterance calls); the text encoder in both modes on 256 sentences
     (64 tokens, batch 64) with a random stand-in encoder at
     paraphrase-distilroberta-base widths (768, 12 heads, 6 layers, FFN
     3072, vocabulary 50265), against the CPU port on 64; K1-K4 launched 0
     times (`preprocess_launches`); for information audio seconds/s, clips/s,
     frames/s, utterances/s, sentences/s, and one extract_batch's wall and
     busy share;
 22. the image and training extras (drive_extras): each RandAugment op and
     cutout on 256 CIFAR-size uint8 images (a magnitude an image) and one
     randaugment of the batch from given draws, card vs the CPU port (the
     integer-path ops bit for bit, the blend ops on >= 99.9 % of pixels and
     none off by more than 1); WRN-28-2 at batch 64, ResNet-18 and ResNet-50
     at batch 32 with TF32 allowed in the process: float32 eval features and
     a train-mode forward (features 1e-4 of max |CPU|, running statistics
     1e-5), the gradients of (feats ** 2).mean() in float64 on both sides
     (1e-4 of each parameter's gradient norm; in float32 rounding alone
     moves the batch norms' gradients up to 7e-3 of their norms, so those
     are logged), and 3x3 convolutions' float32 gradients at WRN-28-2's
     shapes (1e-4 of max |CPU|: the backward's full-float32 guard, beside
     the same without it); the fusion modules in every att_type and
     modality subset (1e-5); the loss zoo, mixup and cutmix_apply given the same draws (1e-6);
     K1-K4 launched 0 times (`extras_launches`); for information a batched
     randaugment's images/s and WRN-28-2's train-step images/s and busy share;
 23. print the run's wall time, one JSON line of kernel records (K1/K2/K1ᵀ
     also at DialogueGCN's shapes, K = 10 and 21, D = 100 and 200, with their
     launches on its paths; K1–K4 with their launches on the ddp path,
     `ddp_launches`, in each model-axis rank, `model_axis_launches`, on the
     preprocessing path, `preprocess_launches`, and on the extras path,
     `extras_launches`),
     the card's name and power limit, and a last
     JSON line {"ok": true, "device": {...}}.
Each model path is driven with every launch count set to 0 just before it
and read just after.

The engines and the val and test stages replay the eval forward captured as
one CUDA graph per shape bucket (erc_tpu_torch/core/cuda_graphs.py): a
serving path is driven after a first predict has captured its buckets, and
a training path's launch counts include the eager warm-up that precedes
each capture.  A replay launches in no Python wrapper: CapturedForward adds
what its capture recorded to the counts on every replay, so each replayed
main-path predict (COGMEN, DAG-ERC, DialogueGCN) and each replayed test
stage of the kernel families is run under a device trace, whose K1/K2/K3
records (by kernel, load width and tap instantiation) must equal the Python
counts; the kernels line reports the traced serving counts.  Within phases 3-16, for every served family (COGMEN banded
and dense, DAG-ERC through K3, DialogueGCN banded and dense, MMGCN dense
and structured, DialogueGCN v2 with DialogueRNN and with the biLSTM, CIM):
replayed logits ≡ the eager forward's (cuda_graphs=False) bit for bit over
64 dialogues in 4 length buckets, one replay a batch, cuDNN's TF32 flag on
for the RNN families; K1/K2/K3 launch counts of a predict equal replayed and
eager; predict wall time, device busy share (kernels, copies and memsets as
the union of their intervals, never more than the call's own time between
CUDA events), p50 of single requests and the host clock split, eager and
replayed.  For every trained family (DAG-ERC, COGMEN, DialogueGCN, MMGCN,
DialogueGCN v2 and its token track, CIM, the three MMIN modules): the test
stage replayed (one replay a batch, parameters at the addresses the graphs
read) gives the eager stage's record.

Training replays the train step captured as one CUDA graph per shape bucket
(CapturedStep: forward, backward, the clip, the optimizer step with the LR a
tensor on the card, MMIN's EMA shadow), the first batch of each bucket
trained eagerly before its capture: every training phase's epoch runs on it
(one capture a bucket, one replay every other batch), its card vs CPU steps
at dropout 0 replay on the card, and for each trained configuration (COGMEN
banded and dense, DAG-ERC kernel and eager forms, DialogueGCN banded and
dense, MMGCN dense and structured, DialogueGCN v2 with DialogueRNN and with
the biLSTM, the token track, CIM, mmin_base, mmin_miss, mmin_miss2;
check_train_graphs): no host sync in an eager step; 3 replayed steps ≡ 3
eager steps from one state over two shape buckets with a plateau LR change
between (losses, gnorm, parameters, gradients, buffers, optimizer state,
LR, generator state, EMA shadow: bit for bit where two eager runs agree,
else within their spread and 1e-6 relative); a device trace of a replayed
step whose K1/K2/K1ᵀ/K3/K4 records equal the Python counts; wall, busy and
device operations of an eager and a replayed step, capture seconds per
bucket, the graph pool's bytes, and an epoch's dialogues/s eager and
replayed.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
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
    t0 = time.perf_counter()
    packer = build.build_host("collate")  # the host batch packer (g++), which every batcher packs through
    log(f"host packer build: {packer} in {time.perf_counter() - t0:.2f} s")
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


def _variant_of(kb, name: str, before: dict) -> str:
    """The instantiation ("vec4" or "scalar") of the one launch of `name`
    since the counts were `before`."""
    taken = [k.split("/")[1] for k, n in kb.variant_launches.items()
             if k.startswith(name + "/") and n - before[k] == 1]
    require(len(taken) == 1, f"{name}: no single variant launch in {kb.variant_launches} after {before}")
    return taken[0]


def _band_timings(name, fn, ref, x, y, offs):
    """Kernel (graph-timed and eager call), plain version, bound and the
    dense torch.bmm yardstick (graph-timed and eager call) on (x, y, offs)."""
    import torch

    Bm, Lm, Dm = y.shape
    K = len(offs)
    taps = Bm * _valid_taps(Lm, offs)
    # each input read once, each output written once
    if name == "banded_gather_sum":
        bytes_moved = 4 * (Bm * Lm * K + 2 * Bm * Lm * Dm)
        A = _band_matrix(x, Lm, offs)
        library = lambda: torch.bmm(A, y)  # noqa: E731
    elif name == "banded_gather_sum_t":
        # K1ᵀ with offsets o is the transposed product of K1's band matrix at offsets -o
        bytes_moved = 4 * (Bm * Lm * K + 2 * Bm * Lm * Dm)
        At = _band_matrix(x, Lm, tuple(-o for o in offs)).transpose(1, 2)
        library = lambda: torch.bmm(At, y)  # noqa: E731
    else:
        bytes_moved = 4 * (2 * Bm * Lm * Dm + Bm * Lm * K)
        yt = y.transpose(1, 2)
        library = lambda: torch.bmm(x, yt)  # noqa: E731
    bound_ms, bound_by = _bound(bytes_moved, 2 * taps * Dm)
    rec = {
        "shape": f"B={Bm} L={Lm} D={Dm} K={K}",
        "ms": _median_graph_ms(lambda: fn(x, y, offs)),
        "eager_ms": _median_event_ms(lambda: fn(x, y, offs)),
        "plain_ms": _median_graph_ms(lambda: ref(x, y, offs)),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": _median_graph_ms(library),
        "library_eager_ms": _median_event_ms(library),
    }
    log(f"{name} timing at {rec['shape']}: kernel {rec['ms']:.6f} ms (eager call "
        f"{rec['eager_ms']:.6f}), plain {rec['plain_ms']:.6f}, bound {bound_ms:.6f} ({bound_by}: "
        f"{bytes_moved / 1e6:.3f} MB), torch.bmm {rec['library_ms']:.6f} (eager call "
        f"{rec['library_eager_ms']:.6f}); kernel/bound {rec['ms'] / bound_ms:.2f}, "
        f"kernel/bmm {rec['ms'] / rec['library_ms']:.3f}")
    return rec


def check_kernels():
    """K1/K2 against their plain versions on the card in both instantiations
    (16-byte "vec4" and 4-byte "scalar"); times at COGMEN's serving batch 32
    and at its max-throughput batch 256; returns per-kernel records."""
    import torch
    from erc_tpu_torch.ops.kernels import banded as kb

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    full, neg, pos = tuple(range(-5, 6)), tuple(range(-5, 0)), tuple(range(0, 6))
    wide, k64 = tuple(range(-10, 11)), tuple(range(-32, 32))
    B, L, D, S, BT = 32, 112, 100, 2, 256
    x, y = randn(B, L, D), randn(B, L, D)
    # D = 99 one float past an aligned base; D = 100 one float past it, rows 104 apart
    x99, y99 = randn(B, L, D)[:, :, 1:], randn(B, L, D)[:, :, 1:]
    x_off, y_off = randn(B, L, D + 4)[:, :, 1 : D + 1], randn(B, L, D + 4)[:, :, 1 : D + 1]
    xt, yt = randn(BT, L, D), randn(BT, L, D)
    # (label, x, y, offsets, the instantiation the layout admits)
    cases_k1 = [
        # TransformerConv's aggregation: [B, L, 11] weights over a contiguous [B, L, D]
        ("full", randn(B, L, 11), x, full, "vec4"),
        ("edge-L7-D13-K21", randn(2, 7, 21), randn(2, 7, 13), wide, "scalar"),
        ("misaligned-D99", randn(B, L, 11), x99, full, "scalar"),
        ("offset-one-float-D100", randn(B, L, 11), x_off, full, "scalar"),
        ("L3-below-one-tile", randn(2, 3, 11), randn(2, 3, D), full, "vec4"),
        ("K64", randn(B, L, 64), x, k64, "vec4"),
        ("K21-full-width", randn(B, L, 21), x, wide, "vec4"),
        ("B256", randn(BT, L, 11), xt, full, "vec4"),
    ]
    # the RGCN's sub-ranges read Ysel[:, :, s, t, :], strided views of [B, L, S, 2, D]
    ysel = randn(B, L, S, 2, D)
    for s in range(S):
        cases_k1.append((f"neg-strided-s{s}", randn(B, L, 5), ysel[:, :, s, 0, :], neg, "vec4"))
        cases_k1.append((f"pos-strided-s{s}", randn(B, L, 6), ysel[:, :, s, 1, :], pos, "vec4"))
    # K1ᵀ as the backward calls it: negated offsets, the cotangent or q as src
    nfull, nneg, npos = (tuple(-o for o in t) for t in (full, neg, pos))
    g96 = randn(1, 1, D).expand(B, 96, D)
    cases_k1t = [
        ("full-L112", randn(B, L, 11), x, nfull, "vec4"),
        ("full-L96", randn(B, 96, 11), randn(B, 96, D), nfull, "vec4"),
        ("rgcn-neg-half-L96", randn(B, 96, 5), randn(B, 96, D), nneg, "vec4"),
        ("rgcn-pos-half-L96", randn(B, 96, 6), randn(B, 96, D), npos, "vec4"),
        ("rgcn-neg-half-L112", randn(B, L, 5), y, nneg, "vec4"),
        ("rgcn-pos-half-L112", randn(B, L, 6), y, npos, "vec4"),
        ("expanded-cotangent-L96", randn(B, 96, 11), g96, nfull, "vec4"),
        ("misaligned-D99", randn(B, L, 11), x99, nfull, "scalar"),
        ("L3-below-one-tile", randn(2, 3, 11), randn(2, 3, D), nfull, "vec4"),
        ("B256-L3-D99", randn(BT, 3, 11), randn(BT, 3, D)[:, :, 1:], nfull, "scalar"),
        ("B256", randn(BT, L, 11), xt, nfull, "vec4"),
    ]
    cases_k2 = [
        ("full", x, y, full, "vec4"),
        ("edge-L7-D13-K21", randn(2, 7, 13), randn(2, 7, 13), wide, "scalar"),
        ("misaligned-D99", x99, y99, full, "scalar"),
        ("offset-one-float-D100", x_off, y_off, full, "scalar"),
        ("L3-below-one-tile", randn(2, 3, D), randn(2, 3, D), full, "vec4"),
        ("K64", x, y, k64, "vec4"),
        ("K21-full-width", x, y, wide, "vec4"),
        ("B256", xt, yt, full, "vec4"),
    ]

    records = {}
    for name, fn, ref, cases in (
        ("banded_gather_sum", kb.banded_gather_sum, kb.banded_gather_sum_reference, cases_k1),
        ("banded_dot", kb.banded_dot, kb.banded_dot_reference, cases_k2),
        ("banded_gather_sum_t", kb.banded_gather_sum_t, kb.banded_gather_sum_t_reference, cases_k1t),
    ):
        errs, bitwise = [], []
        for label, a, b, offs, variant in cases:
            before = dict(kb.variant_launches)
            got = fn(a, b, offs)
            torch.cuda.synchronize()
            taken = _variant_of(kb, name, before)
            require(taken == variant, f"{name}[{label}] took the {taken} instantiation, want {variant}")
            want = ref(a, b, offs)
            err = (got - want).abs().max().item()
            require(math.isfinite(err) and err <= KERNEL_TOL,
                    f"{name}[{label}] max abs err {err} > {KERNEL_TOL}")
            errs.append(err)
            bitwise.append(bool(torch.equal(got, want)))
            log(f"{name}[{label}] shape {tuple(b.shape)} strides {b.stride()} K={len(offs)} "
                f"({taken}): max abs err {err:.3e}, bit for bit {bitwise[-1]}")
        _, a, b, offs, variant = cases[0]
        rec = {
            "name": name,
            "route": "cuda",
            "source": "erc_tpu_torch/csrc/banded.cu",
            # K1ᵀ replaces no pallas_call: the JAX VJPs _bgs_bwd and _bd_bwd are plain jnp
            "replaces": {"banded_gather_sum": "erc_tpu/ops/pallas/banded.py:117",
                         "banded_dot": "erc_tpu/ops/pallas/banded.py:222",
                         "banded_gather_sum_t": "erc_tpu/ops/pallas/banded.py:145"}[name],
            "tpu_source": f"erc_tpu/ops/pallas/banded.py:{name}" if name != "banded_gather_sum_t"
            else "erc_tpu/ops/pallas/banded.py:_bgs_bwd and _bd_bwd (jnp)",
            "variant": variant,
            "max_abs_err": max(errs),
            "bitwise_cases": f"{sum(bitwise)} of {len(bitwise)}",
            **_band_timings(name, fn, ref, a, b, offs),
        }
        _, a, b, offs, variant = next(c for c in cases if c[0] == "B256")
        rec["b256"] = {"variant": variant, **_band_timings(name, fn, ref, a, b, offs)}
        records[name] = rec
    return records


def check_band_functions():
    """K1's and K2's autograd Functions against autograd through their plain
    versions on the card, at COGMEN's training shape (B = 32, L = 96,
    D = 100): the RGCN's strided Ysel views with an expanded cotangent, the
    graph transformer's contiguous inputs, and inputs that need no gradient
    (their kernels not launched).  Returns the worst gradient error."""
    import torch
    from erc_tpu_torch.ops.kernels import banded as kb

    g = torch.Generator(device="cuda").manual_seed(5)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=g)  # noqa: E731
    B, L, D = 32, 96, 100
    full, neg = tuple(range(-5, 6)), tuple(range(-5, 0))
    ysel = randn(B, L, 2, 2, D)
    gd = randn(1, 1, D).expand(B, L, D)
    cases = [  # (label, function, plain version, inputs, which need grad, cotangent)
        ("K1-ysel-view-expanded-g-src-only", lambda c, y: kb.banded_gather_sum(c, y[:, :, 1, 0, :], neg),
         lambda c, y: kb.banded_gather_sum_reference(c, y[:, :, 1, 0, :], neg), (randn(B, L, 5), ysel),
         (False, True), gd),
        ("K1-aggregation-both", lambda c, v: kb.banded_gather_sum(c, v, full),
         lambda c, v: kb.banded_gather_sum_reference(c, v, full), (randn(B, L, 11), randn(B, L, D)),
         (True, True), randn(B, L, D)),
        ("K2-scores-both", lambda a, b: kb.banded_dot(a, b, full), lambda a, b: kb.banded_dot_reference(a, b, full),
         (randn(B, L, D), randn(B, L, D)), (True, True), randn(B, L, 11)),
        ("K2-ysel-views-b-only", lambda a, b: kb.banded_dot(a[:, :, 0, 1, :], b[:, :, 1, 1, :], full),
         lambda a, b: kb.banded_dot_reference(a[:, :, 0, 1, :], b[:, :, 1, 1, :], full), (ysel, randn(B, L, 2, 2, D)),
         (False, True), randn(1, 1, 11).expand(B, L, 11)),
    ]
    worst = 0.0
    for label, fn, ref, inputs, needs, cot in cases:
        grads = []
        for f in (fn, ref):
            kb.reset_launches()
            leaves = [t.detach().clone().requires_grad_(n) for t, n in zip(inputs, needs)]
            with torch.enable_grad():
                f(*leaves).backward(cot)
            torch.cuda.synchronize()
            grads.append([t.grad for t in leaves])
            if f is fn:
                launches = dict(kb.launches)
        errs = []
        for a, b, n in zip(*grads, needs):
            require((a is None) == (not n), f"band Function[{label}]: a gradient nobody asked for, or a missing one")
            if n:
                errs.append((a - b).abs().max().item())
        err = max(errs)
        require(math.isfinite(err) and err <= KERNEL_TOL,
                f"band Function[{label}]: gradient error {err} > {KERNEL_TOL}")
        worst = max(worst, err)
        log(f"band Function[{label}]: gradients vs autograd through the plain version max abs err {err:.3e}; "
            f"launches forward and backward {launches}")
    return worst


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


def _dag_work(B, C, D):
    """K3's least bytes (each input read once, each output written once) and
    operations: the eight D x D products per (row, position), the gates, and
    the attention over the c columns written before position c."""
    f32 = 4
    bytes_moved = f32 * (B * C * (1 + 6 * D + 2 * D + 2 + 2 * C)  # q, xcb, hppb, hb, num01, den_p, mp, masks
                         + 8 * D * D + 6 * D + D  # weights and biases
                         + B * C * (3 * D + 1))  # h1, V0w, V1w, Kw
    flops = B * C * (16 * D * D + 2 * D + 30 * D) + B * (C * (C - 1) // 2) * 4 * D
    return bytes_moved, flops


# the phases of one position of each cluster kernel, between its cycle stamps
# 2 .. 2 + len(phases); stamp 0 starts the launch, 1 ends the weight load, the
# last ends the loop (g_phase_cycles in dag_block.cu, g_bwd_phase_cycles in
# dag_block_bwd.cu)
PHASES = {
    "dag_block": ("(1) logits", "(2) M", "M barrier", "(3) gate products", "(3) GRUs and h1", "h1 barrier",
                  "(4) key and output products", "(4) V0/V1"),
    "dag_block_bwd": ("(5) of c+1 and (2) M", "(3) GRUs", "(3) dM product", "B barrier",
                      "(4) merge terms and (1) of c-1", "(4) sums and dV updates", "g product of c-1",
                      "X barrier"),
}


def _phase_cycles(kd, kernel: str = "dag_block") -> dict:
    """The cycle stamps of `kernel`'s latest cluster launch as cycles per
    phase: the weight load, the first cluster barrier and the whole loop,
    then each phase of position C / 2."""
    import ctypes

    names = PHASES[kernel]
    n = len(names) + 5
    st = (ctypes.c_longlong * n)()
    err = getattr(kd._library(kernel), f"erc_{kernel}_phase_cycles")(st)
    require(err == 0, f"{kernel} phase stamps: cudaError {err}")
    spans = {"load": st[1] - st[0], "first barrier": st[2] - st[1], "loop": st[n - 1] - st[2]}
    spans.update({name: st[i + 4] - st[i + 3] for i, name in enumerate(names)})
    return spans


def _dag_variant(kd, before: dict, kernel: str = "dag_block") -> str:
    """The variant ("cluster" or "stream") of the one launch of `kernel` since the counts were `before`."""
    taken = [k.split("/")[1] for k, n in kd.variant_launches.items()
             if k.startswith(kernel + "/") and n - before[k] == 1]
    require(len(taken) == 1, f"{kernel}: no single variant launch in {kd.variant_launches} after {before}")
    return taken[0]


def check_dag_block():
    """K3 against its plain version on the card in both variants, bit for bit
    across repeats; its plan, the card's cluster occupancy, and its times at
    DAG-ERC's serving (B = 32) and training (B = 16) shapes, in the committed
    plan and in the other plans of the cluster variant; returns its record."""
    import torch
    from erc_tpu_torch.ops.kernels import dag_block as kd

    g = torch.Generator(device="cuda").manual_seed(1)
    B, C, D = 32, 16, 300  # DAG-ERC serving: batch 32, dag_chunk 16, hidden 300
    cases = [
        ("full-prefix", _dag_inputs(g, B, C, D, prefix=True), "cluster"),
        ("full-first-block", _dag_inputs(g, B, C, D, prefix=False), "cluster"),
        ("full-padded-rows", _dag_inputs(g, B, C, D, prefix=True, pad_rows=5), "cluster"),
        ("ragged-B3-C5-D13", _dag_inputs(g, 3, 5, 13, prefix=True, pad_rows=2), "cluster"),
        ("stream-B4-C16-D512", _dag_inputs(g, 4, C, 512, prefix=True, pad_rows=3), "stream"),
    ]
    errs = []
    for label, args, variant in cases:
        before = dict(kd.variant_launches)
        got = kd.dag_block(*args)
        torch.cuda.synchronize()
        taken = _dag_variant(kd, before)
        require(taken == variant, f"dag_block[{label}] took the {taken} variant, want {variant}")
        want = kd.dag_block_reference(*args)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        require(finite and math.isfinite(err) and err <= DAG_TOL,
                f"dag_block[{label}] max abs err {err} > {DAG_TOL} (finite outputs: {finite})")
        again = kd.dag_block(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)), f"dag_block[{label}] not deterministic")
        errs.append(err)
        Bc, Cc, Dc = args[1].shape[0], args[1].shape[1], args[4].shape[-1]
        log(f"dag_block[{label}] B={Bc} C={Cc} D={Dc} ({taken}, {kd.launch_plan(torch.device('cuda'), Bc, Cc, Dc)}): "
            f"max abs err {err:.3e} (tolerance {DAG_TOL}), bitwise repeatable")
    device = torch.device("cuda")
    n_max = kd.max_clusters(device, C, D)
    log(f"dag_block cluster occupancy: cudaOccupancyMaxActiveClusters = {n_max} clusters of "
        f"{kd.CLUSTER_BLOCKS} blocks at C={C} D={D} ({kd.cluster_smem(1, C, D, kd.cluster_cols(D))} B "
        f"of shared memory a block at one row)")
    args = cases[0][1]
    train_args = _dag_inputs(g, 16, C, D, prefix=True)
    timed = {}
    for Bt, a in ((B, args), (16, train_args)):
        p = kd.launch_plan(device, Bt, C, D)
        bytes_moved, flops = _dag_work(Bt, C, D)
        bound_ms, bound_by = _bound(bytes_moved, flops)
        t = {
            "plan": p,
            "ms": _median_graph_ms(lambda: kd.dag_block(*a)),
            "eager_ms": _median_event_ms(lambda: kd.dag_block(*a)),
            "plain_ms": _median_graph_ms(lambda: kd.dag_block_reference(*a)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        timed[Bt] = t
        log(f"dag_block timing at B={Bt} C={C} D={D}, plan {p.variant} R={p.rows} n={p.n} w={p.cols}: "
            f"kernel {t['ms']:.6f} ms (eager call {t['eager_ms']:.6f}), plain {t['plain_ms']:.6f}, bound "
            f"{bound_ms:.6f} ({bound_by}: {bytes_moved / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP); "
            f"kernel/bound {t['ms'] / bound_ms:.1f}")
        log(f"dag_block phases at B={Bt} (cycles of thread 0 of the first block): {_phase_cycles(kd)}")
        # the other plans of the cluster variant: rows a cluster and columns a block
        designs = []
        for rows in (2, 3, 4, 5):
            for cols in (kd.cluster_cols(D), -(-D // kd.CLUSTER_BLOCKS)):
                if not kd._cluster_fits(rows, C, D, cols) or (rows, cols) == (p.rows, p.cols):
                    continue
                q = kd.Plan("cluster", rows, -(-Bt // rows), cols)
                fn = lambda q=q, a=a: kd._forward(a[0], a[1:], plan_=q)  # noqa: E731
                err = max((x - y).abs().max().item() for x, y in zip(fn(), kd.dag_block_reference(*a)))
                require(err <= DAG_TOL, f"dag_block plan {q}: max abs err {err} > {DAG_TOL}")
                designs.append(f"R={rows} n={q.n} w={cols}: {_median_graph_ms(fn):.6f} ms (err {err:.1e})")
        log(f"dag_block other cluster plans at B={Bt}: " + "; ".join(designs))
    t = timed[B]
    res_ms = _median_graph_ms(lambda: kd._forward(train_args[0], train_args[1:], residuals=True))
    log(f"dag_block at the training shape B=16 with residuals: {res_ms:.6f} ms")
    return {
        "name": "dag_block",
        "route": "cuda",
        "source": "erc_tpu_torch/csrc/dag_block.cu",
        "replaces": "erc_tpu/ops/pallas/dag_block.py:320",
        "tpu_source": "erc_tpu/ops/pallas/dag_block.py:dag_block",
        "shape": f"B={B} C={C} D={D}",
        "variant": t["plan"].variant,
        "rows": t["plan"].rows,
        "clusters": t["plan"].n,
        "cols": t["plan"].cols,
        "max_active_clusters": n_max,
        "max_abs_err": max(errs),
        "ms": t["ms"],
        "eager_ms": t["eager_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this recurrence
        "b16": {k: (v._asdict() if k == "plan" else v) for k, v in timed[16].items()} | {"residuals_ms": res_ms},
    }


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
    """K4 against its plain version on the card in every variant of its sweep
    (the stream variant at D = 512, and forced at the training shape; the
    global variant at C = 128, D = 300, and forced), C = 64 at D = 300, bit
    for bit across repeats, and K3's residuals against the plain version's;
    its plan, the card's occupancy of its clusters, times at the training
    shape in the cluster and stream variants and at C = 128 in the global
    one, and the cluster sweep's phases."""
    import torch
    from erc_tpu_torch.ops.kernels import dag_block as kd

    g = torch.Generator(device="cuda").manual_seed(2)
    B, C, D = 32, 16, 300
    device = torch.device("cuda")
    forced = kd.Plan("stream", kd.ROWS_PER_BLOCK, 16 // kd.ROWS_PER_BLOCK, 0)
    # (label, inputs, the variant the plan takes, a plan that replaces it)
    cases = [
        ("full-prefix", _dag_inputs(g, B, C, D, prefix=True), "cluster", None),
        ("full-first-block", _dag_inputs(g, B, C, D, prefix=False), "cluster", None),
        ("full-padded-rows", _dag_inputs(g, B, C, D, prefix=True, pad_rows=5), "cluster", None),
        ("training-B16", _dag_inputs(g, 16, C, D, prefix=True, pad_rows=3), "cluster", None),
        ("ragged-B3-C5-D13", _dag_inputs(g, 3, 5, 13, prefix=True, pad_rows=2), "cluster", None),
        ("chunk64-B2-C64-D300", _dag_inputs(g, 2, 64, D, prefix=True, pad_rows=4), "cluster", None),
        ("stream-B4-C16-D512", _dag_inputs(g, 4, C, 512, prefix=True, pad_rows=3), "stream", None),
        ("stream-forced-B16", _dag_inputs(g, 16, C, D, prefix=True), "stream", forced),
        ("chunk128-B16-C128-D300", _dag_inputs(g, 16, 128, D, prefix=True, pad_rows=5), "global", None),
        ("global-forced-B4", _dag_inputs(g, 4, C, D, prefix=True, pad_rows=2), "global", kd.Plan("global", 1, 4, 0)),
    ]
    errs = []
    for label, args, variant, plan_ in cases:
        outs = kd._forward(args[0], args[1:], residuals=True)
        cts = [torch.randn(o.shape, device="cuda", generator=g) for o in outs[:4]]
        before = dict(kd.variant_launches)
        got = kd.dag_block_backward(args[0], *args[1:], *outs, *cts, plan_=plan_)
        torch.cuda.synchronize()
        taken = _dag_variant(kd, before, "dag_block_bwd")
        require(taken == variant, f"dag_block_bwd[{label}] took the {taken} variant, want {variant}")
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
        again = kd.dag_block_backward(args[0], *args[1:], *outs, *cts, plan_=plan_)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)), f"dag_block_bwd[{label}] not deterministic")
        errs.append(worst)
        Bc, Cc, Dc = args[1].shape[0], args[1].shape[1], args[4].shape[-1]
        p = plan_ or kd.bwd_launch_plan(device, Bc, Cc, Dc)
        log(f"dag_block_bwd[{label}] B={Bc} C={Cc} D={Dc} ({taken}, {p}): max error {worst:.3e} of "
            f"max(1, max|plain|) (tolerance {DAG_BWD_TOL}), residuals {res_err:.3e}, bitwise repeatable")
    n_max = kd.bwd_max_clusters(device, C, D)
    log(f"dag_block_bwd cluster occupancy: cudaOccupancyMaxActiveClusters = {n_max} clusters of "
        f"{kd.CLUSTER_BLOCKS} blocks at C={C} D={D} ({kd.bwd_cluster_smem(1, C, D, kd.cluster_cols(D))} B "
        f"of shared memory a block at one row)")
    # times at DAG-ERC's training shape: batch 16
    Bt = 16
    args = _dag_inputs(g, Bt, C, D, prefix=True)
    outs = kd._forward(args[0], args[1:], residuals=True)
    cts = [torch.randn(o.shape, device="cuda", generator=g) for o in outs[:4]]
    bwd = lambda q=None: kd.dag_block_backward(args[0], *args[1:], *outs, *cts, plan_=q)  # noqa: E731
    plain = lambda: kd.dag_block_backward_reference(args[0], *args[1:], *outs, *cts)  # noqa: E731
    p = kd.bwd_launch_plan(device, Bt, C, D)
    require(p.variant == "cluster", f"dag_block_bwd at the training shape takes {p}")
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
    ms = _median_graph_ms(bwd)
    stream_ms = _median_graph_ms(lambda: bwd(forced))
    # the global variant at --dag_chunk=128's shape (B = 16, C = 128): eager calls, few
    args128 = _dag_inputs(g, Bt, 128, D, prefix=True)
    outs128 = kd._forward(args128[0], args128[1:], residuals=True)
    cts128 = [torch.randn(o.shape, device="cuda", generator=g) for o in outs128[:4]]
    global_ms = _median_event_ms(lambda: kd.dag_block_backward(args128[0], *args128[1:], *outs128, *cts128), reps=5)
    global_bound = _bound(*_dag_bwd_work(Bt, 128, D))[0]
    log(f"dag_block_bwd global variant at B={Bt} C=128 D={D}: {global_ms:.6f} ms a call (bound "
        f"{global_bound:.6f} ms)")
    bwd()
    torch.cuda.synchronize()
    phases = _phase_cycles(kd, "dag_block_bwd")
    rec = {
        "name": "dag_block_bwd",
        "route": "cuda",
        "source": "erc_tpu_torch/csrc/dag_block_bwd.cu",
        "replaces": "erc_tpu/ops/pallas/dag_block.py:369",
        "tpu_source": "erc_tpu/ops/pallas/dag_block.py:_dag_block_bwd",
        "shape": f"B={Bt} C={C} D={D}",
        "variant": p.variant,
        "rows": p.rows,
        "clusters": p.n,
        "cols": p.cols,
        "max_active_clusters": n_max,
        "max_abs_err": max(errs),
        "err_is_relative_to": "max(1, max|plain|) per gradient",
        "ms": ms,
        "eager_ms": _median_event_ms(bwd),
        "plain_ms": _median_graph_ms(plain),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the reverse sweep
        "stream_ms": stream_ms,
        "global_c128_ms": global_ms,
        "global_c128_bound_ms": global_bound,
        "phase_cycles": phases,
        "wgrad_ms": _median_graph_ms(wgrad),
        "wgrad_bound_ms": _bound(w_bytes, w_flops)[0],
        "wgrad_library_ms": _median_graph_ms(lambda: kd.weight_grads_reference(h1, *st)),
        "wgrad_max_err": werr,
    }
    log(f"dag_block_bwd timing at {rec['shape']}, plan {p.variant} R={p.rows} n={p.n} w={p.cols}: kernel "
        f"{ms:.6f} ms (eager call {rec['eager_ms']:.6f}), stream variant {stream_ms:.6f} ms, plain "
        f"{rec['plain_ms']:.6f}, bound {bound_ms:.6f} ({bound_by}: {bytes_moved / 1e6:.3f} MB, "
        f"{flops / 1e9:.4f} GFLOP); kernel/bound {ms / bound_ms:.1f}; weight-gradient launch alone "
        f"{rec['wgrad_ms']:.6f} ms (bound {rec['wgrad_bound_ms']:.6f}), torch.einsum of the same "
        f"{rec['wgrad_library_ms']:.6f} ms, error {werr:.3e}")
    log(f"dag_block_bwd phases at B={Bt} (cycles of thread 0 of the first block): {phases}")
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


def _latency_throughput(engine, dialogues, card, name, n=100):
    """p50/p95/p99 of single-dialogue requests and dialogues/s of `dialogues`;
    returns (the mean predict seconds of `dialogues`, p50 ms)."""
    lat = engine.benchmark_latency(n=n, L=48)
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
    return dt / reps, lat["p50_ms"]


def _dialogues():
    from erc_tpu_torch.data.synthetic import synthetic_erc

    dialogues = synthetic_erc("iemocap-cogmen", 6, n_train=64)
    lens = [len(d["text"]) for d in dialogues]
    return dialogues, f"{len(dialogues)} dialogues (lengths {min(lens)}..{max(lens)})"


# ------------------------------------------------------------------ the captured eval step
EAGER_LATENCY_N = 40  # single-dialogue requests timed on an eager engine (a replayed one: 100)


def _bucket_batches(engine):
    """64 dialogues in 4 length buckets: 16 dialogues of each of lengths 6..30, 36..60, 66..90 and 86..110,
    a batch each, padded to the engine's 32 rows and to L 32, 64, 96 and 112."""
    from erc_tpu_torch.data.synthetic import synthetic_erc

    return [engine.batcher(synthetic_erc("iemocap-cogmen", 6, n_train=16, min_len=hi - 24, max_len=hi, seed=20 + i))
            for i, hi in enumerate((30, 60, 90, 110))]


def _replay_vs_eager(name, engine, eager):
    """The engine's replayed logits against the eager forward's (the same weights, `cuda_graphs=False`), bit
    for bit, over 64 dialogues in 4 length buckets, one replay a batch."""
    import numpy as np

    batches = _bucket_batches(engine)
    replays, captures = engine.captured.replays, engine.captured.captures
    worst = 0.0
    for b in batches:
        worst = max(worst, float(np.abs(engine.logits(b) - eager.logits(b)).max()))
    replays, captures = engine.captured.replays - replays, engine.captured.captures - captures
    Ls = [b["attention_mask"].shape[1] for b in batches]
    log(f"{name} replayed vs eager: {len(batches) * 16} dialogues in {len(batches)} batches of L {Ls}: max abs diff "
        f"{worst:.3e} (want 0); {replays} replays ({captures} new captures; {engine.captured.captures} graphs, "
        f"inputs {sorted(engine.captured.keys)})")
    require(replays == len(batches), f"{name}: {replays} replays for {len(batches)} batches")
    require(worst == 0.0, f"{name}: replayed logits differ from the eager forward's by {worst}")


def _all_launches():
    from erc_tpu_torch.ops.kernels import banded as kb, dag_block as kd

    return {**_read_launches(), **kb.variant_launches, **kb.tap_launches, **kd.variant_launches}


# a hand-written kernel's record in a device trace, by its demangled name ("(anonymous namespace)::
# banded_gather_sum_kernel<4, 11, false>(...)"): template arguments VEC, KT and, in K1, TR (K1ᵀ); K3 by variant
_BAND_KERNEL = re.compile(r"(banded_gather_sum|banded_dot)_kernel<(\d+), (\d+)(?:, (true|false))?>")
_DAG_KERNEL = re.compile(r"dag_block_(cluster|stream)_kernel")
_DAG_BWD_KERNEL = re.compile(r"dag_block_bwd_(cluster|stream)_kernel")  # K4's sweep (its wgrad kernel beside it)


def _trace_counts(names) -> dict:
    """Launches keyed as the kernel wrappers count them (K1/K2/K1ᵀ by kernel, load width and tap
    instantiation; K3 by variant), from the names of the kernels a device trace recorded."""
    out: dict = {}
    for n in names:
        keys = ()
        m = _BAND_KERNEL.search(n)
        if m:
            vec, kt, tr = m.group(2, 3, 4)
            name = m.group(1) + ("_t" if tr == "true" else "")
            keys = (name, f"{name}/{'vec4' if vec == '4' else 'scalar'}", f"{name}/kt{kt}")
        elif m := _DAG_KERNEL.search(n):
            keys = ("dag_block", f"dag_block/{m.group(1)}")
        elif m := _DAG_BWD_KERNEL.search(n):
            keys = ("dag_block_bwd", f"dag_block_bwd/{m.group(1)}")
        for k in keys:
            out[k] = out.get(k, 0) + 1
    return out


def _trace_check(what: str, before: dict, names, after=None) -> dict:
    """The K1/K2/K1ᵀ/K3/K4 records of a device trace (`names`: its kernels' names) must equal what the Python
    counts moved since `before` (_all_launches()), up to now or to `after`: a replay adds its capture's record to
    them; K4's global variant runs its stream kernel, so it reads as stream.  Returns the traced counts."""
    counted: dict = {}
    for k, n in (after or _all_launches()).items():
        if n != before[k]:
            k = "dag_block_bwd/stream" if k == "dag_block_bwd/global" else k
            counted[k] = counted.get(k, 0) + n - before[k]
    traced = _trace_counts(names)
    log(f"{what}: kernels in the device trace {traced}")
    require(traced == counted, f"{what}: the device trace holds {traced}, the launch counts moved {counted}")
    return traced


def _traced(what: str, fn):
    """fn() under a device trace, held against the launch counts (`_trace_check`).  Returns fn's result and the
    traced counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = _all_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the card's activity alone: no host ops
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, _trace_check(what, before, names)


def _launches_replayed_vs_eager(name, engine, eager, dialogues):
    """Every launch count of a predict of `dialogues` (its buckets captured before), replayed and eager: equal."""
    engine.predict(dialogues)
    counts = []
    for eng in (engine, eager):
        _reset_launches()
        eng.predict(dialogues)
        counts.append(_all_launches())
    log(f"{name} launches of a predict, replayed {_nonzero(counts[0])}, eager {_nonzero(counts[1])}")
    require(counts[0] == counts[1], f"{name}: the replayed predict counts other launches than the eager one")


def _host_breakdown(name, engine, dialogues, reps=5):
    """Host clock of a predict of `dialogues`, split into batching (ERCBatcher), the forward with its copies
    (`logits`, which ends on a stream sync) and the rest (softmax and lists on the host); for a replayed engine
    also the staging copies into its pinned buffers, timed alone after each batch.  Medians over `reps` rounds,
    each a predict and then the split."""
    import torch
    from erc_tpu_torch.core.cuda_graphs import host_array

    bs = engine.batch_size
    rounds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.predict(dialogues)
        total = time.perf_counter() - t0
        t_batch = t_logits = t_stage = 0.0
        for s in range(0, len(dialogues), bs):
            t0 = time.perf_counter()
            batch = engine.batcher(dialogues[s : s + bs])
            t1 = time.perf_counter()
            engine.logits(batch)
            t_batch, t_logits = t_batch + t1 - t0, t_logits + time.perf_counter() - t1
            if engine.captured is not None:
                arrays = {k: host_array(v) for k, v in batch.items() if v is not None}
                bucket = engine.captured._buckets[(0, engine.captured._bucket_key(arrays))]
                t0 = time.perf_counter()
                with torch.inference_mode():  # where the buffers were made
                    for k, staged in bucket.staging.items():
                        staged.copy_(torch.from_numpy(arrays[k]))
                t_stage += time.perf_counter() - t0
        rounds.append((total, t_batch, t_logits, t_stage))
    total, t_batch, t_logits, t_stage = (statistics.median(r[i] for r in rounds) * 1e3 for i in range(4))
    staging = f" (of which staging copies {t_stage:.3f} ms)" if engine.captured is not None else ""
    log(f"{name} host clock of a predict of {len(dialogues)} dialogues, medians of {reps}: {total:.3f} ms; batching "
        f"{t_batch:.3f} ms, logits {t_logits:.3f} ms{staging}, the rest {total - t_batch - t_logits:.3f} ms")


def _eager_and_replayed(name, engine, eager, dialogues, card, show=()):
    """Wall time and device busy share of a predict of `dialogues`, and p50 of single-dialogue requests, of the
    eager engine and the replayed one; the host clock of each, split."""
    n_batches = -(-len(dialogues) // engine.batch_size)
    wall_e, p50_e = _latency_throughput(eager, dialogues, card, f"{name} eager", n=EAGER_LATENCY_N)
    wall_r, p50_r = _latency_throughput(engine, dialogues, card, f"{name} replayed")
    _host_breakdown(f"{name} eager", eager, dialogues)
    _host_breakdown(f"{name} replayed", engine, dialogues)
    busy_e = profile_predict(eager, dialogues, wall_e, n_batches, show)
    busy_r = profile_predict(engine, dialogues, wall_r, n_batches, show)

    def share(busy, wall):
        return "not measured" if busy is None else f"{100 * busy / (wall * 1e3):.1f}% busy"

    log(f"{name} predict of {len(dialogues)} dialogues, eager / replayed: {wall_e * 1e3:.3f} / {wall_r * 1e3:.3f} ms "
        f"({share(busy_e, wall_e)} / {share(busy_r, wall_r)}), p50 {p50_e:.3f} / {p50_r:.3f} ms on {card}")
    return wall_r


def _eval_warmups(loader) -> list:
    """The first batch of each length bucket of `loader`: the capture of its graph runs the eval forward
    eagerly once first, and those launches count."""
    seen, first = set(), []
    for b in loader:
        L = b["attention_mask"].shape[1] if "attention_mask" in b else 0
        if L not in seen:
            seen.add(L)
            first.append(b)
    return first


def _same_record(a, b) -> bool:
    """Equal test-stage records: floats, lists, arrays and nested dicts, NaN equal to NaN."""
    import numpy as np

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same_record(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple, np.ndarray)):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=np.asarray(a).dtype.kind == "f")
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def _test_replayed_vs_eager(name, run, traced=False):
    """The test stage replayed (one replay a batch, the addresses its graphs read unchanged since they were
    captured) and eager: the same record, loss, acc, F1 and the per-class arrays.  With `traced`, a third,
    replayed run under a device trace whose kernel records equal the launch counts."""
    n_test = len(list(run.make_loader("test")))
    captured = run.captured
    require(captured.captures > 0, f"{name}: no graph was captured in the test stages so far")
    require(captured.addresses_unchanged(), f"{name}: a parameter moved since the graphs were captured")
    replays = captured.replays
    t0 = time.perf_counter()
    replayed = run.test()
    t_replayed = time.perf_counter() - t0
    replays = captured.replays - replays
    run.eval_graphs = False
    try:
        t0 = time.perf_counter()
        eager = run.test()
        t_eager = time.perf_counter() - t0
    finally:
        run.eval_graphs = True
    log(f"{name} test stage: {n_test} batches, {replays} replays, {captured.captures} graphs; replayed "
        f"{t_replayed * 1e3:.3f} ms, eager {t_eager * 1e3:.3f} ms; records equal: {_same_record(replayed, eager)} "
        f"(loss {replayed['Lall']:.7f} / {eager['Lall']:.7f}, F1 {replayed.get('f1', math.nan):.7f} / "
        f"{eager.get('f1', math.nan):.7f})")
    require(replays == n_test, f"{name}: {replays} replays for {n_test} test batches")
    require(_same_record(replayed, eager), f"{name}: the replayed test record differs from the eager one: "
            f"{replayed} vs {eager}")
    if traced:
        again, kernels = _traced(f"{name} test stage replayed", run.test)
        require(_same_record(again, replayed) and any(kernels.values()),
                f"{name}: the traced test stage differs from the first or launched no kernel: {kernels}")


# ------------------------------------------------------------------ the captured train step
STEP_REL_TOL = 1e-6  # replayed vs eager, where two eager runs already differ: relative to the largest |value|


def _host_buckets(host) -> list:
    """The host batches grouped by shape bucket, smallest arrays first: a list of lists of batches."""
    from erc_tpu_torch.core.cuda_graphs import CapturedStep, host_array

    groups: dict = {}
    for b in host:
        key = CapturedStep._bucket_key({k: host_array(v) for k, v in b.items() if v is not None})
        groups.setdefault(key, []).append(b)
    return sorted(groups.values(), key=lambda g: sum(v.size for v in g[0].values() if v is not None))


def _state_names(run) -> list:
    """A name for each tensor of run._step_tensors(), in its order."""
    import torch

    names = {}
    for mname, m in vars(run).items():
        if isinstance(m, torch.nn.Module):
            for n, t in (*m.named_parameters(), *m.named_buffers()):
                names[id(t)] = f"{mname}.{n}"
    for n, p in run.model.named_parameters():
        if p.grad is not None:
            names[id(p.grad)] = f"grad model.{n}"
        for k, v in run.optimizer.state.get(p, {}).items():
            names[id(v)] = f"optimizer {k} model.{n}"
    return [names.get(id(t), f"hyperparameter {i}") for i, t in enumerate(run._step_tensors())]


def _snapshot(run):
    """What a train step changes, copied: every tensor the captured step reads or writes, the dropout
    generator's state and the step count."""
    import torch

    torch.cuda.synchronize()
    return [t.detach().clone() for t in run._step_tensors()], run._dropout_rng.get_state(), run.global_steps


def _restore(run, snap) -> None:
    """`run` back to a snapshot, written in place (the captured graphs read these tensors by address)."""
    import torch

    tensors, rng, steps = snap
    live = run._step_tensors()
    require(len(live) == len(tensors), "the trainer's state changed shape since the snapshot")
    with torch.no_grad():
        torch._foreach_copy_(live, tensors)
    run._dropout_rng.set_state(rng)
    run.global_steps = steps


def _plateau_change(run) -> None:
    """One LR change by the plateau controller (torch's, patience 0, stepped twice on the same loss), which
    writes the LR tensor in place."""
    import torch

    group = run.optimizer.param_groups[0]
    lr, before = group["lr"], float(group["lr"])
    sche = torch.optim.lr_scheduler.ReduceLROnPlateau(run.optimizer, "min", patience=0)
    sche.step(1.0)
    sche.step(1.0)
    require(group["lr"] is lr and float(lr) < before,
            f"the plateau controller did not reduce the LR tensor in place ({before} -> {float(group['lr'])})")


def _three_steps(run, batches, replayed: bool, sync_check: bool = False) -> dict:
    """Steps on `batches` (host batches), replayed or eager, with one plateau LR change after the first; the
    metrics of each step, every state tensor after them and the dropout generator's state.  With `sync_check`
    each step runs under torch.cuda.set_sync_debug_mode("error"): a host sync in it raises."""
    import torch

    run.train_graphs = replayed
    try:
        mets = []
        for i, b in enumerate(batches):
            if i == 1:
                _plateau_change(run)  # reads the LR back: a sync outside the step
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if sync_check else "default")
            try:
                mets.append(run.train_batch(b))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        run.train_graphs = True
    out = {f"step {i} {k}": v.detach().clone() for i, m in enumerate(mets) for k, v in m.items()}
    out.update(zip(_state_names(run), (t.detach().clone() for t in run._step_tensors())))
    out["dropout generator state"] = run._dropout_rng.get_state()
    return out


def _rel(x, ref) -> float:
    """||x - ref|| / ||ref|| in float64 (the absolute norm where ref is 0)."""
    d = float((x.double() - ref.double()).norm())
    return d / max(float(ref.double().norm()), 1e-30) if d else 0.0


def _compare_steps(name, eager_a, eager_b, replayed):
    """Replayed ≡ eager bit for bit where two eager runs agree bit for bit in every quantity.  Where they
    differ in some (a backward that adds with atomics, as a gather's or cuDNN's convolution's does), every
    quantity's replayed relative difference from the first eager run (`_rel`) is within twice the worst of the
    second eager run's and within STEP_REL_TOL, and the generator state is equal.  Returns the quantities where
    the eager runs differ and the worst relative differences, eager and replayed."""
    import torch

    require(eager_a.keys() == replayed.keys() == eager_b.keys(), f"{name}: the runs give other quantities")
    spread = [k for k, a in eager_a.items() if not torch.equal(a, eager_b[k])]
    if not spread:
        for k, a in eager_a.items():
            require(torch.equal(replayed[k], a), f"{name}: replayed {k} differs from the eager steps', which agree "
                    f"bit for bit (max abs diff {float((replayed[k].double() - a.double()).abs().max())})")
        return spread, 0.0, 0.0
    key = "dropout generator state"
    require(torch.equal(replayed[key], eager_a[key]) and key not in spread, f"{name}: the generator states differ")
    ee = max((_rel(eager_b[k], a), k) for k, a in eager_a.items())
    re = max((_rel(replayed[k], a), k) for k, a in eager_a.items())
    log(f"{name}: worst relative differences from the first eager run: eager {ee}, replayed {re}")
    ee, re = ee[0], re[0]
    require(re <= 2 * ee and re <= STEP_REL_TOL, f"{name}: replayed steps differ from eager by {re:.3e} relative, "
            f"two eager runs by {ee:.3e} (tolerance {STEP_REL_TOL}, and twice the eager spread)")
    return spread, ee, re


def _pool_bytes(graphs) -> str:
    """The bytes of the segments in the graphs' memory pool (torch.cuda.memory_snapshot), or 'not measured'."""
    import torch

    if graphs.pool is None:
        return "not measured"
    segments = [s for s in torch.cuda.memory_snapshot() if "segment_pool_id" in s]
    if not segments:
        return "not measured"
    pool = tuple(graphs.pool)
    return str(sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == pool))


def _step_time(fn) -> float:
    """Host seconds of one call of `fn` (warm: it ran before), ending on the device."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _wall_and_busy(fn, desc, reps=1, **profile):
    """(wall seconds, the median of `reps` warm calls of `fn`, each ending on the device; busy ms of one more call
    under the profiler, which logs its table as `desc` (`_profile`))."""
    wall = statistics.median(_step_time(fn) for _ in range(reps))
    return wall, _profile(fn, desc, wall, **profile)


def _replayed_vs_eager(name, run, host, card, extra=()) -> list:
    """3 replayed steps ≡ 3 eager steps of `run` from one state, over its two smallest shape buckets (of `host`
    and `extra`) with a plateau LR change after the first, no host sync in an eager step, one capture a bucket
    and one replay a step (`check_train_graphs`).  Returns the smallest bucket's batches."""
    import torch

    buckets = _host_buckets([*host, *extra])
    require(len(buckets) >= 2, f"{name}: {len(buckets)} shape bucket(s) to step over, want 2")
    a, b = buckets[0], buckets[1]
    steps = [a[0], b[0], a[1] if len(a) > 1 else a[0]]
    graphs = run.captured_step
    for batch in (a[0], b[0]):  # the first batch of a bucket trains eagerly before its capture
        run.train_batch(batch)
    captures = graphs.captures
    snap = _snapshot(run)
    runs = {}

    def three(label, replayed):
        before = graphs.replays
        runs[label] = _three_steps(run, steps, replayed, sync_check=label == "eager")
        require(graphs.replays - before == (len(steps) if replayed else 0) and graphs.captures == captures,
                f"{name} {label}: {graphs.replays - before} replays, {graphs.captures - captures} new captures")
        _restore(run, snap)

    three("eager", False)
    three("replayed", True)
    if not all(torch.equal(runs["replayed"][k], a) for k, a in runs["eager"].items()):
        three("eager again", False)  # the spread of two eager runs decides (`_compare_steps`)
    spread, ee, re = _compare_steps(name, runs["eager"], runs.get("eager again", runs["eager"]), runs["replayed"])
    shapes = [tuple(x["attention_mask" if "attention_mask" in x else "sample_mask"].shape) for x in steps]
    what = (f"losses, gnorm, parameters, gradients, buffers, optimizer state, LR, generator state"
            f"{', EMA shadow' if getattr(run, 'ema_model', None) is not None else ''}")
    if spread:
        verdict = (f"two eager runs differ in {len(spread)} of {len(runs['eager'])} quantities ({what}; e.g. "
                   f"{spread[:3]}): worst relative difference from the first eager run, eager {ee:.3e}, replayed "
                   f"{re:.3e} (tolerance {STEP_REL_TOL} and twice the eager one)")
    else:
        verdict = f"all {len(runs['eager'])} quantities bit for bit ({what})"
    log(f"{name} captured train step: 3 steps (shapes {shapes}, a plateau LR change after the first) replayed vs "
        f"eager from one state: {verdict}; no host sync in an eager step; on {card}")
    return a


def check_train_graphs(name, run, host, card, extra=(), show=(), timed=None):
    """The captured train step of `run` (a trainer on the card at its family's dropout):
    - no host sync in an eager step (torch.cuda.set_sync_debug_mode("error"));
    - 3 replayed steps ≡ 3 eager steps from one state (weights, optimizer state, LR, generator, EMA shadow),
      over two shape buckets with one plateau LR change between: bit for bit, or, where they differ, held to
      the spread of a second eager run (`_compare_steps`);
    - one capture a bucket and one replay a step;
    - wall, busy and device operations of an eager and a replayed step of `timed` (a host batch; the first
      step's by default), the replayed step's device trace holding the K1/K2/K1ᵀ/K3/K4 records that the Python
      counts moved; capture seconds per bucket and the graph pool's bytes.
    `host`: the train loader's batches; `extra`: batches of another shape where the loader has one bucket."""
    from erc_tpu_torch.data.loader import to_device

    t0 = time.perf_counter()
    a = _replayed_vs_eager(name, run, host, card, extra)
    graphs = run.captured_step

    timed = a[0] if timed is None else timed
    dev_t = to_device(timed, run.device)
    desc = f"{name} train step ({tuple(dev_t['attention_mask' if 'attention_mask' in dev_t else 'sample_mask'].shape)})"
    eager_s, busy_e = _wall_and_busy(lambda: run.train_step(dev_t), f"one eager {desc}", show=show)
    replay_s, busy_r = _wall_and_busy(lambda: run.train_batch(timed), f"one replayed {desc}", show=show,
                                      traced=f"{name} replayed train step")
    log(f"{desc}, eager / replayed: wall {eager_s * 1e3:.3f} / {replay_s * 1e3:.3f} ms, busy {busy_e} / {busy_r} "
        f"ms; {graphs.captures} captures ({graphs.replays} replays so far), capture seconds per bucket "
        f"{[round(x, 4) for x in graphs.capture_seconds]}, graph pool {_pool_bytes(graphs)} bytes on {card}; "
        f"these checks {time.perf_counter() - t0:.1f} s")


def _other_shape(run, n, **change):
    """A train batch of the first `n` training samples in another shape bucket, for a loader whose batches all
    share one: its batcher with `change` (a shorter static length, or fewer padded rows)."""
    import copy

    loader = run.make_loader("train")
    batcher = copy.copy(loader.batcher)
    for k, v in change.items():
        setattr(batcher, k, v)
    return batcher(loader.samples[:n])


def _epoch_rates(name, run, card, unit="dialogues", batch_count=None, eager=True, passes=1):
    """The train steps of one epoch's batches (`batch_count` of them where given; no val or test stage), replayed
    (one replay a batch: a first replayed pass that has to capture a bucket is run again; the median `unit`/s of
    `passes` passes) and, with `eager`, eager: logs `unit`/s of each; returns the replayed rate and the steps."""
    p = run.params
    saved = p.get("eval_per_epoch", 1), p.get("batch_count")
    p.eval_per_epoch, p.batch_count = 0, batch_count or saved[1]
    e, graphs = run.eidx + 1, run.captured_step

    def epoch(replayed):
        run.train_graphs, run.eidx, p.epoch = replayed, e, e + 1  # the same batches each time
        replays, captures = graphs.replays, graphs.captures
        rec = run.train()[-1]
        captured = graphs.captures - captures
        require(graphs.replays - replays == (rec["steps"] - captured if replayed else 0),
                f"{name}: {graphs.replays - replays} replays and {captured} captures for {rec['steps']} steps")
        return rec, captured

    try:
        rec, new = epoch(True)
        rates = [] if new else [rec["dialogues"] / rec["seconds"]]
        while len(rates) < passes:
            rec, again = epoch(True)
            require(not again, f"{name}: a second replayed epoch captured {again} graphs")
            rates.append(rec["dialogues"] / rec["seconds"])
        replayed, steps = statistics.median(rates), rec["steps"]
        if eager:
            rec, _ = epoch(False)
    finally:
        run.train_graphs = True
        p.eval_per_epoch, p.batch_count = saved
    if eager:
        log(f"{name} training throughput, an epoch's train steps ({rec['steps']} steps, {rec['dialogues']} {unit}): "
            f"eager {rec['dialogues'] / rec['seconds']:.1f}, replayed {replayed:.1f} {unit}/s ({new} buckets "
            f"captured in a pass before) on {card}")
    return replayed, steps


def _check_epoch_graphs(name, run, host, captures_before=0, replays_before=0):
    """The main path's epoch: one capture for each shape bucket of its batches, one replay for every other batch."""
    graphs = run.captured_step
    n_buckets = len(_host_buckets(host))
    captures, replays = graphs.captures - captures_before, graphs.replays - replays_before
    log(f"{name} epoch on the captured step: {len(host)} batches in {n_buckets} shape buckets, {captures} captures, "
        f"{replays} replays")
    require(captures == n_buckets and replays == len(host) - n_buckets,
            f"{name}: {captures} captures and {replays} replays for {len(host)} batches in {n_buckets} buckets")


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

    from erc_tpu_torch.ops.kernels import banded as kb

    engine.predict(dialogues)  # the first batch of each length bucket is captured
    _reset_launches()
    results, traced = _traced("COGMEN predict, replayed", lambda: engine.predict(dialogues))
    # the counts of the kernels line: the device trace's, which equal the Python counts
    launches = {k: traced.get(k, 0) for k in _read_launches()}
    variants = {k: traced.get(k, 0) for k in kb.variant_launches}
    log(f"COGMEN path: {desc} in {n_batches} batches, replayed ({engine.captured.captures} graphs); launches "
        f"{launches}; by variant {variants}")
    require(launches["banded_gather_sum"] == 5 * n_batches,
            f"banded_gather_sum launched {launches['banded_gather_sum']} times, want {5 * n_batches}")
    require(launches["banded_dot"] == n_batches,
            f"banded_dot launched {launches['banded_dot']} times, want {n_batches}")
    for name in ("banded_gather_sum", "banded_dot"):
        require(variants[f"{name}/vec4"] == launches[name] and variants[f"{name}/scalar"] == 0,
                f"{name}: not every launch on the COGMEN path took the 16-byte variant: {variants}")
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

    # the captured forward ≡ the eager one, banded and dense, and the same launches
    eager = InferenceEngine.from_module("cogmen", graph_impl="banded", cuda_graphs=False, **kw)
    eager.model.load_state_dict(engine.model.state_dict())
    dense_eager = InferenceEngine.from_module("cogmen", graph_impl="dense", cuda_graphs=False, **kw)
    dense_eager.model.load_state_dict(engine.model.state_dict())
    _replay_vs_eager("COGMEN banded", engine, eager)
    _replay_vs_eager("COGMEN dense", dense, dense_eager)
    _launches_replayed_vs_eager("COGMEN banded", engine, eager, dialogues)

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

    _eager_and_replayed("COGMEN", engine, eager, dialogues, card, show=("banded_",))
    return launches, variants


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

    from erc_tpu_torch.ops.kernels import dag_block as kd

    engine.predict(dialogues)  # the first batch of each length bucket is captured
    _reset_launches()
    results, traced = _traced("DAG-ERC predict, replayed", lambda: engine.predict(dialogues))
    launches = {k: traced.get(k, 0) for k in _read_launches()}
    variants = {k: traced.get(k, 0) for k in kd.variant_launches}
    log(f"DAG-ERC path: {desc} in {len(chunks)} batches, {blocks} blocks of {p.dag_chunk}, replayed "
        f"({engine.captured.captures} graphs); launches {launches}; by variant {variants}")
    require(launches["dag_block"] == want, f"dag_block launched {launches['dag_block']} times, want {want}")
    require(variants == {"dag_block/cluster": want, "dag_block/stream": 0, "dag_block_bwd/cluster": 0,
                         "dag_block_bwd/stream": 0, "dag_block_bwd/global": 0},
            f"dag_block: not every launch on the DAG-ERC serving path took the cluster variant: {variants}")
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

    # the captured forward (K3 in it) ≡ the eager forward through K3, and the same launches
    plain = InferenceEngine.from_module("dagerc", cuda_graphs=False, **kw)
    plain.model.load_state_dict(engine.model.state_dict())
    _replay_vs_eager("DAG-ERC", engine, plain)
    _launches_replayed_vs_eager("DAG-ERC", engine, plain, dialogues)

    # one dialogue: the batch carries 31 all-padding dialogues
    one = engine.predict([dialogues[0]])
    _check_results(dialogues[:1], one)
    t_eager, _ = _latency_throughput(eager, dialogues, card, "DAG-ERC eager form (replayed)")
    wall = _eager_and_replayed("DAG-ERC", engine, plain, dialogues, card, show=("dag_block",))
    log(f"DAG-ERC predict of {len(dialogues)} dialogues, replayed: {wall * 1e3:.3f} ms through K3, "
        f"{t_eager * 1e3:.3f} ms in the eager form")
    return launches, variants


def profile_predict(engine, dialogues, wall_s: float, n_batches: int, show=()):
    """Device time by kernel over one predict of `dialogues`; returns the busy ms."""
    return _profile(lambda: engine.predict(dialogues),
                    f"predict of {len(dialogues)} dialogues ({n_batches} batches)", wall_s, show)


# the profiler's device activities that occupy the card; a range such as Optimizer.step#Adam.step is a
# gpu_user_annotation over kernels already counted
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _profile(fn, what: str, wall_s: float, show=(), traced=None):
    """Device time over one call of `fn` (torch.profiler), against the
    unprofiled wall time of the same call: busy is the union of the intervals
    of its kernels, copies and memsets (device work only, no ranges), which
    must not exceed the profiled call's own wall time between CUDA events.
    Logs the 12 largest by name, and any other whose name holds a string in
    `show`; returns the busy ms, or None where the profiler saw no device work.
    With `traced` (a description) the same trace is also held against the
    launch counts (`_trace_check`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = _all_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the card's activity alone: no host ops
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    event_ms = start.elapsed_time(end)
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if traced is not None:
        _trace_check(traced, before, [e.name for e in cuda])
    work = [e for e in cuda if getattr(e, "activity_type", "kernel") in DEVICE_WORK and not e.is_user_annotation]
    if not work:
        log("profile: the profiler recorded no device work (not measured)")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in work)
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy_ms = (busy_us + cur_e - cur_s) / 1e3
    summed_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3
    ranges_ms = sum(e.time_range.elapsed_us() for e in cuda) / 1e3 - summed_ms
    by_name: dict = {}
    for e in work:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    n_kernels = sum(1 for e in work if not e.name.startswith(("Memcpy", "Memset")))
    log(f"profile: {what}: {len(work)} device operations ({n_kernels} kernels), device busy {busy_ms:.3f} ms "
        f"(their sum {summed_ms:.3f} ms; ranges left out {ranges_ms:.3f} ms) of {wall_s * 1e3:.3f} ms unprofiled wall ({100 * busy_ms / (wall_s * 1e3):.1f}% busy); "
        f"the profiled call {event_ms:.3f} ms between CUDA events")
    require(busy_ms <= event_ms * 1.001 + 0.005,
            f"{what}: device busy {busy_ms:.3f} ms exceeds the call's {event_ms:.3f} ms between CUDA events")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for i, (name, (t, n)) in enumerate(ranked):
        if i < 12 or any(x in name for x in show):
            log(f"  {t / 1e3:9.4f} ms  x{n:<5d} {name[:100]}")
    return busy_ms


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

    # blocks of 64 positions of the longest batch: K4 takes them in its cluster
    # variant, one row a cluster
    from erc_tpu_torch.ops.kernels import dag_block as kd

    longest = max(host, key=lambda b: b["input_tensor"].shape[1])
    batch = to_device(longest, kern.device)
    k64, e64 = _trainer("--dag_chunk=64"), _trainer("--dag_chunk=64", "--dag_impl=eager")
    _reset_launches()
    k64.compute_grads(batch)
    launches64, variants64 = _read_launches(), dict(kd.variant_launches)
    nb64 = _blocks(longest, 64)
    require(launches64["dag_block_bwd"] == layers * nb64 and variants64["dag_block_bwd/cluster"] == layers * nb64,
            f"dag_chunk 64: K4 launches {launches64}, by variant {variants64}, want {layers * nb64} cluster")
    e64.compute_grads(batch)
    worst, name = _worst_grad_diff(k64.model, e64.model)
    Bb, L = longest["input_tensor"].shape[:2]
    plan64 = kd.bwd_launch_plan(kern.device, int(Bb), min(64, int(L)), int(p.hidden_dim))
    log(f"dag_chunk 64 ({nb64} blocks of batch 16 x L {int(L)}, K4's plan for the first {plan64}): "
        f"launches {launches64}, by variant {variants64}; gradients kernel vs eager form worst "
        f"{worst:.3e} ({name}), tolerance {TRAIN_TOL}")
    require(worst <= TRAIN_TOL, f"dag_chunk 64: kernel vs eager gradients {worst} ({name}) > {TRAIN_TOL}")
    del k64, e64

    # blocks of 128 positions: K4 takes them in its global variant
    k128, e128 = _trainer("--dag_chunk=128"), _trainer("--dag_chunk=128", "--dag_impl=eager")
    _reset_launches()
    k128.compute_grads(batch)
    launches128, variants128 = _read_launches(), dict(kd.variant_launches)
    nb128 = _blocks(longest, 128)
    require(launches128["dag_block_bwd"] == layers * nb128
            and variants128["dag_block_bwd/global"] == layers * nb128,
            f"dag_chunk 128: K4 launches {launches128}, by variant {variants128}, want {layers * nb128} global")
    e128.compute_grads(batch)
    worst, name = _worst_grad_diff(k128.model, e128.model)
    log(f"dag_chunk 128 ({nb128} blocks of batch 16 x L {int(L)}): launches {launches128}, by variant "
        f"{variants128}; gradients kernel vs eager form worst {worst:.3e} ({name}), tolerance {TRAIN_TOL}")
    require(worst <= TRAIN_TOL, f"dag_chunk 128: kernel vs eager gradients {worst} ({name}) > {TRAIN_TOL}")
    del k128, e128

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
    # the eager form's captured step on dialogues cut to 32 utterances (an eager step takes about 25 ms a
    # position): buckets of L 16 and 32, its epoch rates over 1 batch
    short = _trainer("--dag_impl=eager", "--max_seq_len=32")
    check_train_graphs("DAG-ERC eager form", short, list(short.make_loader("train")), card,
                       extra=[_other_shape(short, 16, max_len=16)])
    _epoch_rates("DAG-ERC eager form", short, card, batch_count=1)
    del short

    # the card, through the captured step, against a CPU run of the same weights, without dropout
    _card_vs_cpu_steps("DAG-ERC", _trainer(dropout=0.0), _trainer(device="cpu", dropout=0.0), host)

    # the main path: one epoch (120 dialogues) and test() through DAGERCTrainer.train
    run = _trainer()
    train_blocks = sum(_blocks(b, chunk) for b in host)
    test_blocks = sum(_blocks(b, chunk) for b in run.make_loader("test"))
    # the test stage's captures run its forward eagerly first, once a length bucket
    warmup_blocks = sum(_blocks(b, chunk) for b in _eval_warmups(run.make_loader("test")))
    _reset_launches()
    t0 = time.perf_counter()
    history = run.train()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    variants = dict(kd.variant_launches)
    _check_epoch_graphs("DAG-ERC", run, host)
    require(variants == {"dag_block/cluster": launches["dag_block"], "dag_block/stream": 0,
                         "dag_block_bwd/cluster": launches["dag_block_bwd"], "dag_block_bwd/stream": 0,
                         "dag_block_bwd/global": 0},
            f"dag_block/dag_block_bwd: not every launch on the training path took the cluster variant: {variants}")
    want = {"dag_block": 2 * layers * train_blocks + layers * (test_blocks + warmup_blocks),
            "dag_block_bwd": layers * train_blocks}
    rec = history[0]
    log(f"DAG-ERC training path: {rec['steps']} steps over {rec['dialogues']} dialogues "
        f"({train_blocks} blocks), then test() ({test_blocks} blocks replayed, {warmup_blocks} run before their "
        f"capture) in {wall:.3f} s; launches {launches}; K3 and K4 by variant {variants}")
    for name, n in want.items():
        require(launches[name] == n, f"{name} launched {launches[name]} times on the training path, want {n}")
    res = rec["test"]
    require(all(math.isfinite(x) for x in (rec["Lall"], rec["gnorm"], res["Lall"], res["f1"])),
            f"non-finite training results {rec}")
    log(f"epoch 0: loss {rec['Lall']:.5f}, gnorm {rec['gnorm']:.5f}; test loss {res['Lall']:.5f}, "
        f"weighted F1 {res['f1']:.5f}, acc {res['acc']:.5f}")
    log(f"DAG-ERC training throughput, kernel form: {rec['dialogues'] / rec['seconds']:.1f} dialogues/s "
        f"({rec['steps']} steps, batch {p.train.batch_size}, {rec['seconds'] * 1e3:.3f} ms) on {card}")

    check_train_graphs("DAG-ERC kernel form", run, host, card, timed=longest, show=("dag_block",))
    _epoch_rates("DAG-ERC kernel form", run, card)
    _test_replayed_vs_eager("DAG-ERC", run, traced=True)
    return launches, variants


# ------------------------------------------------------------------ phase 6
COGMEN_TRAIN_ARGS = ["--dataset=synthetic-cogmen-6", "--encoder_mode=chained", "--max_seq_len=96",
                     "--confusion_matrix=false"]


def _cogmen_trainer(graph_impl="banded", *extra, device="cuda", dropout=None):
    """A COGMENTrainer at bench.py's parity config (712 → 100, 2-layer encoder
    of 8 heads and ff 2048, wp = wf = 5, batch 32, Adam 1e-4, L2 1e-8,
    dropout 0.5; weights from seed 1, the same on every device)."""
    from erc_tpu_torch.models import cogmen

    from erc_tpu_torch.train.trainer import start_group

    p = cogmen.COGMENParams()
    p.finalize([*COGMEN_TRAIN_ARGS, f"--graph_impl={graph_impl}", f"--device={device}", "--epoch=1", *extra])
    if dropout is not None:
        p.drop_rate = dropout
    start_group(p)  # as the entry point does: the group that --coordinator asks for, before the trainer
    trainer = cogmen.COGMENTrainer(p)
    trainer.log = lambda msg: log(f"  [trainer] {msg}")
    trainer.initialize()
    return trainer


# launches of one banded COGMEN train step (models/cogmen.py, ops/gnn_banded.py): forward K1 5 (the RGCN's
# 2 speakers x 2 directions, the graph transformer's aggregation) and K2 1 (its scores); backward K1ᵀ 6 (the
# RGCN's 4 d src, d v, d k), K1 1 (d q) and K2 1 (d alpha); the RGCN's coefficients need no gradient
TRAIN_STEP_LAUNCHES = {"banded_gather_sum": 5 + 1, "banded_dot": 1 + 1, "banded_gather_sum_t": 6}
EVAL_LAUNCHES = {"banded_gather_sum": 5, "banded_dot": 1, "banded_gather_sum_t": 0}


def drive_cogmen_training(card: str):
    """COGMEN training at full width through COGMENTrainer with the banded
    graph (K1/K2 forward, K1ᵀ/K1/K2 backward): launches of one step,
    gradients and 3 steps' losses ≡ the dense graph's, the card ≡ the CPU
    at dropout 0, an epoch and test() as the main path, dialogues/s banded
    vs dense, a profile of one step, and train → save → serve."""
    import tempfile

    import numpy as np
    import torch
    from erc_tpu_torch.data.loader import to_device
    from erc_tpu_torch.ops.kernels import banded as kb

    band = _cogmen_trainer()
    p = band.params
    n_params = sum(t.numel() for t in band.model.parameters())
    require(n_params == 10_117_874, f"COGMEN has {n_params} parameters, want 10117874")
    log(f"trainer: COGMEN {p.hidden_all} -> {p.hidden_size}, chained encoder, wp {p.wp} wf {p.wf}, batch "
        f"{p.train.batch_size}, {p.optim.name} lr {p.optim.lr} weight decay {p.optim.weight_decay}, dropout "
        f"{p.drop_rate}, no clip, {n_params} params, graph_impl banded, on {torch.cuda.get_device_name(0)}")
    dense = _cogmen_trainer("dense")
    require(all(torch.equal(a, b) for a, b in zip(band.model.state_dict().values(), dense.model.state_dict().values())),
            "banded and dense trainers start from different weights")
    host = list(band.make_loader("train"))  # epoch 0: the batches train() will take
    batches = [to_device(b, band.device) for b in host[:3]]

    # one forward and backward: launches by the formula, gradients ≡ the dense graph's
    _reset_launches()
    band.compute_grads(batches[0])
    launches, variants = _read_launches(), dict(kb.variant_launches)
    log(f"COGMEN train step of one batch (L {host[0]['input_tensor'].shape[1]}): launches {launches}; "
        f"by variant {variants}")
    for name, n in TRAIN_STEP_LAUNCHES.items():
        require(launches[name] == n, f"{name} launched {launches[name]} times in one train step, want {n}")
        require(variants[f"{name}/vec4"] == n and variants[f"{name}/scalar"] == 0,
                f"{name}: not every launch of the train step took the 16-byte variant: {variants}")
    dense.compute_grads(batches[0])
    worst, name = _worst_grad_diff(band.model, dense.model)
    log(f"first-batch gradients, banded vs dense on the card: worst {worst:.3e} ({name}), tolerance {TRAIN_TOL}")
    require(worst <= TRAIN_TOL, f"banded vs dense gradients {worst} ({name}) > {TRAIN_TOL}")

    # three steps of each on the same batches and dropout masks (the graph draws none)
    secs, losses = {}, {}
    for label, t in (("banded", band), ("dense", dense)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [t.train_step(b)["Lall"] for b in batches]
        losses[label] = [x.item() for x in out]
        secs[label] = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["banded"], losses["dense"]))
    log(f"3 COGMEN train steps, losses banded {losses['banded']} vs dense {losses['dense']}: worst relative "
        f"diff {rel:.3e} (tolerance {TRAIN_TOL})")
    require(rel <= TRAIN_TOL, f"banded vs dense losses differ by {rel} > {TRAIN_TOL}")
    del band, dense

    # the card, through the captured step, against a CPU run of the same weights, without dropout
    _card_vs_cpu_steps("COGMEN", _cogmen_trainer(dropout=0.0), _cogmen_trainer(device="cpu", dropout=0.0), host)

    # the main path: one epoch (120 dialogues) and test() through COGMENTrainer.train, banded
    run, other = _cogmen_trainer(), _cogmen_trainer("dense")
    n_test = len(list(run.make_loader("test")))
    # the test stage's captures run its forward eagerly first, once a length bucket
    n_eval = n_test + len(_eval_warmups(run.make_loader("test")))
    _reset_launches()
    t0 = time.perf_counter()
    history = run.train()
    wall = time.perf_counter() - t0
    launches, variants = _read_launches(), dict(kb.variant_launches)
    _check_epoch_graphs("COGMEN", run, host)
    rec = history[0]
    want = {k: rec["steps"] * n + n_eval * EVAL_LAUNCHES[k] for k, n in TRAIN_STEP_LAUNCHES.items()}
    log(f"COGMEN training path: {rec['steps']} steps over {rec['dialogues']} dialogues, then test() ({n_test} "
        f"batches replayed, {n_eval - n_test} run before their capture) in {wall:.3f} s; launches {launches}; by "
        f"variant {variants}")
    require({k: launches[k] for k in want} == want, f"COGMEN training path launches {launches}, want {want}")
    require(all(variants[f"{k}/scalar"] == 0 for k in want), f"a scalar launch on the COGMEN training path: {variants}")
    res = rec["test"]
    require(all(math.isfinite(x) for x in (rec["Lall"], rec["gnorm"], res["Lall"], res["f1"])),
            f"non-finite training results {rec}")
    log(f"COGMEN epoch 0: loss {rec['Lall']:.5f}, gnorm {rec['gnorm']:.5f}; test loss {res['Lall']:.5f}, "
        f"weighted F1 {res['f1']:.5f}, acc {res['acc']:.5f}")

    # train dialogues/s, banded vs dense, epochs in turns (dense, banded, dense, banded)
    rates = {"banded": [rec["dialogues"] / rec["seconds"]], "dense": []}
    for label, t in (("dense", other), ("banded", run), ("dense", other), ("banded", run)):
        if rates[label]:  # train() ends on the epoch it ran: move on by one
            t.eidx += 1
        t.params.epoch = t.eidx + 1
        r = t.train()[-1]
        rates[label].append(r["dialogues"] / r["seconds"])
    log(f"COGMEN training throughput (train steps of an epoch, {rec['dialogues']} dialogues, batch "
        f"{p.train.batch_size}): banded "
        f"{', '.join(f'{x:.1f}' for x in rates['banded'])} dialogues/s (first epoch first), dense "
        f"{', '.join(f'{x:.1f}' for x in rates['dense'])} dialogues/s on {card}")

    check_train_graphs("COGMEN banded", run, host, card, timed=host[2], show=("banded_",))
    _epoch_rates("COGMEN banded", run, card)
    check_train_graphs("COGMEN dense", other, host, card, timed=host[2])
    _epoch_rates("COGMEN dense", other, card)
    _test_replayed_vs_eager("COGMEN", run, traced=True)

    # train, save, serve: main() with two steps; the saved model serves the trainer's eval logits
    from erc_tpu_torch.models import cogmen
    from erc_tpu_torch.serve import InferenceEngine

    with tempfile.TemporaryDirectory() as tmp:
        trainer = cogmen.main([*COGMEN_TRAIN_ARGS, "--graph_impl=banded", "--epoch=1", "--batch_count=2",
                               f"--save_dir={tmp}"])
        path = Path(tmp) / "model.last.ckpt"
        require(path.exists(), f"main saved no {path}")
        tp = trainer.params
        engine = InferenceEngine.from_module("cogmen", str(path), dataset=tp.dataset,
                                             batch_size=int(tp.test.batch_size),
                                             encoder_mode=tp.encoder_mode, graph_impl=tp.graph_impl,
                                             hidden_size=tp.hidden_size, max_seq_len=tp.max_seq_len)
        test_batch = next(iter(trainer.make_loader("test")))
        trainer.model.eval()
        with torch.inference_mode():
            eval_batch = to_device(test_batch, trainer.device)
            want_logits = trainer.model(eval_batch).float().cpu().numpy()
        got = engine.logits(test_batch)
        diff = float(np.abs(got - want_logits).max())
        log(f"train -> save -> serve: {trainer.global_steps} steps, saved {path.name}; InferenceEngine logits vs "
            f"the trainer's eval logits max abs diff {diff:.3e}")
        require(diff == 0.0, f"served logits differ from the trainer's eval logits by {diff}")
    return launches, variants


# ------------------------------------------------------------------ phase 7
# DialogueGCN's band launches by tap-count instantiation (ops/kernels/banded.py::tap_launches): a forward
# runs K1 for the RGCN's 2 speakers x 2 directions (its backward taps at K = 10 in the generic
# instantiation kt0, its forward ones at K = 11) and GraphConv's window sum (K = 21), and K2 for EdgeAtt's
# scores (K = 21)
DGCN_FORWARD_TAPS = {"banded_gather_sum/kt0": 2, "banded_gather_sum/kt11": 2, "banded_gather_sum/kt21": 1,
                     "banded_dot/kt21": 1}
# a train step adds K2 for the RGCN's d coef (K = 10, 11: the edge weights learn), K1 for EdgeAtt's d a
# (K = 21), and K1ᵀ for the RGCN's 4 d src (K = 10, 11), GraphConv's d src and EdgeAtt's d b (K = 21)
DGCN_STEP_TAPS = {"banded_gather_sum/kt0": 2, "banded_gather_sum/kt11": 2, "banded_gather_sum/kt21": 2,
                  "banded_dot/kt0": 2, "banded_dot/kt11": 2, "banded_dot/kt21": 1,
                  "banded_gather_sum_t/kt0": 2, "banded_gather_sum_t/kt11": 2, "banded_gather_sum_t/kt21": 2}
DGCN_STEP_LAUNCHES = {"banded_gather_sum": 5 + 1, "banded_dot": 1 + 4, "banded_gather_sum_t": 6}
DGCN_EVAL_LAUNCHES = {"banded_gather_sum": 5, "banded_dot": 1, "banded_gather_sum_t": 0}
DGCN_PARAMS = 1_604_046


def _by_kernel(taps: dict) -> dict:
    out = {}
    for key, n in taps.items():
        name = key.split("/")[0]
        out[name] = out.get(name, 0) + n
    return out


def _scaled(counts: dict, n: int) -> dict:
    return {k: v * n for k, v in counts.items()}


def _nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def check_dgcn_kernels():
    """K1, K2 and K1ᵀ against their plain versions at DialogueGCN's shapes
    (B = 32, L = 112): the RGCN's backward taps over D = 100 (K = 10, the
    generic instantiation kt0; strided Ysel views as the RGCN passes them),
    GraphConv's window sum (K = 21, D = 100), EdgeAtt's scores and their
    gradients (K = 21, D = 200).  Times as check_kernels; one record a
    (kernel, K, D), keyed by its tap-count instantiation."""
    import torch
    from erc_tpu_torch.ops.kernels import banded as kb

    g = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=g)  # noqa: E731
    B, L = 32, 112
    back, full = tuple(range(-10, 0)), tuple(range(-10, 11))
    nback = tuple(-o for o in back)
    ysel = randn(B, L, 2, 2, 100)  # Ysel [B, L, S(tgt), 2, 100]: the RGCN's sources
    x100, y100, x200, y200 = randn(B, L, 100), randn(B, L, 100), randn(B, L, 200), randn(B, L, 200)
    fns = {"banded_gather_sum": (kb.banded_gather_sum, kb.banded_gather_sum_reference),
           "banded_dot": (kb.banded_dot, kb.banded_dot_reference),
           "banded_gather_sum_t": (kb.banded_gather_sum_t, kb.banded_gather_sum_t_reference)}
    specs = [  # (kernel, shape label, cases: (label, x, y, offsets)); the first case is timed
        ("banded_gather_sum", "K=10 D=100", [
            ("rgcn-back-taps-ysel-s0", randn(B, L, 10), ysel[:, :, 0, 0, :], back),
            ("rgcn-back-taps-ysel-s1", randn(B, L, 10), ysel[:, :, 1, 0, :], back),
            ("contiguous", randn(B, L, 10), x100, back)]),
        ("banded_gather_sum", "K=21 D=100", [
            ("graphconv-window-sum", (randn(B, L, 21) > 0).float(), x100, full),
            ("edgeatt-da-D200", randn(B, L, 21), x200, full)]),
        ("banded_dot", "K=21 D=200", [("edgeatt-scores", x200, y200, full)]),
        ("banded_dot", "K=10 D=100", [
            ("rgcn-dcoef-ysel", x100, ysel[:, :, 1, 0, :], back), ("contiguous", x100, y100, back)]),
        ("banded_gather_sum_t", "K=10 D=100", [
            ("rgcn-dsrc", randn(B, L, 10), x100, nback)]),
        ("banded_gather_sum_t", "K=21 D=200", [
            ("edgeatt-db", randn(B, L, 21), x200, full), ("graphconv-dsrc-D100", randn(B, L, 21), x100, full)]),
    ]
    records = {}
    for name, shape, cases in specs:
        fn, ref = fns[name]
        errs, bitwise = [], []
        for label, a, b, offs in cases:
            kb.reset_launches()
            got = fn(a, b, offs)
            torch.cuda.synchronize()
            key = kb.launch_args(offs).tap_key[name]
            require(_nonzero(kb.tap_launches) == {key: 1} and _nonzero(kb.variant_launches) == {f"{name}/vec4": 1},
                    f"{name}[dgcn {label}]: launches by instantiation {_nonzero(kb.tap_launches)}, by width "
                    f"{_nonzero(kb.variant_launches)}; want one {key}, 16-byte")
            want = ref(a, b, offs)
            err = (got - want).abs().max().item()
            require(math.isfinite(err) and err <= KERNEL_TOL, f"{name}[dgcn {label}] max abs err {err} > {KERNEL_TOL}")
            errs.append(err)
            bitwise.append(bool(torch.equal(got, want)))
            log(f"{name}[dgcn {label}] shape {tuple(b.shape)} strides {b.stride()} K={len(offs)} ({key}, vec4): "
                f"max abs err {err:.3e}, bit for bit {bitwise[-1]}")
        _, a, b, offs = cases[0]
        key = kb.launch_args(offs).tap_key[name]
        records[f"{name} {shape}"] = {
            "name": f"{name} (DialogueGCN, {shape})",
            "route": "cuda",
            "source": "erc_tpu_torch/csrc/banded.cu",
            "replaces": {"banded_gather_sum": "erc_tpu/ops/pallas/banded.py:117",
                         "banded_dot": "erc_tpu/ops/pallas/banded.py:222",
                         "banded_gather_sum_t": "erc_tpu/ops/pallas/banded.py:145"}[name],
            "variant": "vec4",
            "instantiation": key.split("/")[1],
            "tap_key": key,
            "max_abs_err": max(errs),
            "bitwise_cases": f"{sum(bitwise)} of {len(bitwise)}",
            **_band_timings(name, fn, ref, a, b, offs),
        }
    return records


@contextlib.contextmanager
def _cudnn_tf32_on():
    """cuDNN's TF32 flag on (torch's default) for a phase, off again after."""
    import torch

    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def drive_dgcn(card: str):
    """DialogueGCN serving at full width through InferenceEngine with the
    banded graph (K1 5 and K2 1 a batch), cuDNN's TF32 flag on: predict,
    launches by width and instantiation, banded ≡ dense, card ≡ CPU (and
    what the card gives without the LSTM's full-float32 guard, logged only),
    a single-dialogue request, latency, throughput and profile, banded and
    dense."""
    import torch
    from erc_tpu_torch.ops import rnn as rnn_ops
    from erc_tpu_torch.ops.kernels import banded as kb
    from erc_tpu_torch.serve import InferenceEngine

    kw = dict(dataset="synthetic-cogmen-6", batch_size=32)
    engine = InferenceEngine.from_module("dgcn", graph_impl="banded", **kw)
    p = engine.params
    n_params = sum(t.numel() for t in engine.model.parameters())
    require(n_params == DGCN_PARAMS, f"DialogueGCN has {n_params} parameters, want {DGCN_PARAMS}")
    log(f"engine: DialogueGCN {p.hidden_all} -> 2-layer biLSTM {p.hidden_size}, wp {p.wp} wf {p.wf}, RGCN "
        f"(30 bases, add) + GraphConv, {n_params} params, batch 32, graph_impl banded, cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32}, on {torch.cuda.get_device_name(0)}")
    dialogues, desc = _dialogues()
    n_batches = -(-len(dialogues) // engine.batch_size)

    engine.predict(dialogues)  # the first batch of each length bucket is captured
    _reset_launches()
    results, traced = _traced("DialogueGCN predict, replayed", lambda: engine.predict(dialogues))
    launches = {k: traced.get(k, 0) for k in _read_launches()}
    variants = {k: traced.get(k, 0) for k in kb.variant_launches}
    taps = {k: traced.get(k, 0) for k in kb.tap_launches}
    log(f"DialogueGCN path: {desc} in {n_batches} batches, replayed ({engine.captured.captures} graphs); launches "
        f"{launches}; by width {_nonzero(variants)}; by instantiation {_nonzero(taps)}")
    want = _scaled(DGCN_FORWARD_TAPS, n_batches)
    require(_nonzero(taps) == want, f"DialogueGCN serving launches by instantiation {_nonzero(taps)}, want {want}")
    require({k: launches[k] for k in DGCN_EVAL_LAUNCHES} == _scaled(DGCN_EVAL_LAUNCHES, n_batches),
            f"DialogueGCN serving launches {launches}")
    require(_nonzero(variants) == {"banded_gather_sum/vec4": 5 * n_batches, "banded_dot/vec4": n_batches},
            f"DialogueGCN serving: not every launch took the 16-byte variant: {variants}")
    _check_results(dialogues, results)

    # banded ≡ dense on the card, and ≡ the CPU run of the same weights
    dense = InferenceEngine.from_module("dgcn", graph_impl="dense", **kw)
    dense.model.load_state_dict(engine.model.state_dict())
    cpu = InferenceEngine.from_module("dgcn", graph_impl="banded", device="cpu", **kw)
    cpu.model.load_state_dict(engine.model.state_dict())
    eager = InferenceEngine.from_module("dgcn", graph_impl="banded", cuda_graphs=False, **kw)
    eager.model.load_state_dict(engine.model.state_dict())
    worst_dense, worst_cpu = _worst_logit_diffs(engine, [dense, cpu], dialogues)
    guard = rnn_ops.cudnn_rnn_full_fp32
    rnn_ops.cudnn_rnn_full_fp32 = contextlib.nullcontext
    try:
        (unguarded,) = _worst_logit_diffs(eager, [cpu], dialogues)
    finally:
        rnn_ops.cudnn_rnn_full_fp32 = guard
    log(f"DialogueGCN logits: banded vs dense on the card max abs diff {worst_dense:.3e}; card vs CPU "
        f"{worst_cpu:.3e} (tolerance {PATH_TOL}; cudnn.allow_tf32 on; without the LSTM's full-float32 guard "
        f"{unguarded:.3e})")
    require(worst_dense <= PATH_TOL, f"DialogueGCN banded vs dense {worst_dense} > {PATH_TOL}")
    require(worst_cpu <= PATH_TOL, f"DialogueGCN card vs CPU {worst_cpu} > {PATH_TOL}")

    # the captured forward ≡ the eager one, banded and dense
    dense_eager = InferenceEngine.from_module("dgcn", graph_impl="dense", cuda_graphs=False, **kw)
    dense_eager.model.load_state_dict(engine.model.state_dict())
    _replay_vs_eager("DialogueGCN banded", engine, eager)
    _replay_vs_eager("DialogueGCN dense", dense, dense_eager)
    _launches_replayed_vs_eager("DialogueGCN banded", engine, eager, dialogues)

    # one dialogue: the batch carries 31 all-padding dialogues (LSTM rows of length 0)
    one = engine.predict([dialogues[0]])
    _check_results(dialogues[:1], one)
    for name, eng, eag in (("DialogueGCN dense", dense, dense_eager), ("DialogueGCN banded", engine, eager)):
        _eager_and_replayed(name, eng, eag, dialogues, card, show=("banded_", "RNN", "rnn"))
    return launches, variants, taps


# ------------------------------------------------------------------ phase 8
DGCN_TRAIN_ARGS = ["--dataset=synthetic-cogmen-6", "--max_seq_len=96", "--confusion_matrix=false"]


def _dgcn_trainer(graph_impl="banded", *extra, device="cuda", dropout=None):
    """A DGCNTrainer at DGCNParams' settings (712 -> 2-layer biLSTM 200, wp = wf = 10, batch 32, Adam 3e-4,
    dropout 0.4, IEMOCAP-6 class weights; weights from seed 1, the same on every device), max_seq_len 96."""
    from erc_tpu_torch.models import dgcn

    p = dgcn.DGCNParams()
    p.finalize([*DGCN_TRAIN_ARGS, f"--graph_impl={graph_impl}", f"--device={device}", "--epoch=1", *extra])
    if dropout is not None:
        p.drop_rate = dropout
    trainer = dgcn.DGCNTrainer(p)
    trainer.log = lambda msg: log(f"  [trainer] {msg}")
    trainer.initialize()
    return trainer


DGCN_SGD = ["--optim.name=SGD", "--optim.lr=0.01", "--optim.momentum=0.9", "--optim.nesterov=true"]
# momentum 0 with Nesterov asked for (optax then steps -lr·g) under a Cos schedule long enough that each step
# reads another LR
DGCN_SGD_SCHE = ["--optim.name=SGD", "--optim.momentum=0", "--optim.nesterov=true", "--optim.sche.name=Cos",
                 "--optim.sche.start=0.01", "--optim.sche.end=0.001", "--optim.sche.left=0", "--optim.sche.right=200"]


def _dgcn_sgd(card: str, host) -> dict:
    """DialogueGCN banded trained with the port's Sgd (optax.sgd's rule, capturable), at full width:
    - momentum 0.9 with Nesterov, dropout 0: first-batch gradients and 4 steps' losses card vs CPU, the card's
      through the captured step (`_card_vs_cpu_steps`), K1/K2/K1ᵀ launches 5 x one step's over them;
    - the same at the family's dropout: the captured step's checks (`check_train_graphs`), its trace state made;
    - momentum 0 with Nesterov under a Cos schedule: 3 replayed ≡ 3 eager steps (`_replayed_vs_eager`), no
      per-parameter state, and the LR of 3 replayed steps within PIPELINE_LR_TOL of the host curve.
    Returns the K1/K2/K1ᵀ launches of the first trainer's steps."""
    from erc_tpu_torch.core.interp import Cos
    from erc_tpu_torch.train.optim import Sgd

    t0 = time.perf_counter()
    name = "DialogueGCN banded SGD (momentum 0.9, Nesterov)"
    card0 = _dgcn_trainer("banded", *DGCN_SGD, dropout=0.0)
    require(type(card0.optimizer) is Sgd and all(g["capturable"] for g in card0.optimizer.param_groups),
            f"{name}: built {type(card0.optimizer).__name__}, capturable "
            f"{[g.get('capturable') for g in card0.optimizer.param_groups]}")
    _reset_launches()
    _card_vs_cpu_steps(name, card0, _dgcn_trainer("banded", *DGCN_SGD, device="cpu", dropout=0.0), host)
    launches = _read_launches()
    want = _scaled(DGCN_STEP_LAUNCHES, 5)
    got = {k: launches[k] for k in want}
    log(f"{name}: K1/K2/K1ᵀ launches over one eager step and 4 train steps {got}, 5 x one step's "
        f"{DGCN_STEP_LAUNCHES} wanted, on {card}")
    require(got == want, f"{name}: launches {got} over 5 steps, want {want}")
    del card0
    run = _dgcn_trainer("banded", *DGCN_SGD)
    check_train_graphs(name, run, host, card, show=("banded_",))  # timed on a captured bucket's batch
    params = list(run.model.parameters())
    require(all("trace" in run.optimizer.state[p] for p in params), f"{name}: a parameter without its trace")
    del run

    name = "DialogueGCN banded SGD (momentum 0, Nesterov asked), Cos schedule"
    run = _dgcn_trainer("banded", *DGCN_SGD_SCHE)
    a = _replayed_vs_eager(name, run, host, card)
    require(list(run.optimizer.state) == ["schedule"], f"{name}: optimizer state {list(run.optimizer.state)}")
    curve = Cos(0.01, 0.001, 0, 200)
    count0, replays = int(run.optimizer.state["schedule"]["count"]), run.captured_step.replays
    lrs = []
    for _ in range(3):
        run.train_batch(a[0])
        lrs.append(float(run.optimizer.param_groups[0]["lr"]))
    want_lrs = [curve(count0 + i) for i in range(3)]
    worst = max(abs(x - y) / abs(y) for x, y in zip(lrs, want_lrs))
    log(f"{name}: LR of replayed steps {count0}..{count0 + 2} read back {lrs}; host curve {want_lrs}; worst relative "
        f"{worst:.3e} (tolerance {PIPELINE_LR_TOL}); on {card}; SGD checks {time.perf_counter() - t0:.1f} s")
    require(run.captured_step.replays == replays + 3, f"{name}: {run.captured_step.replays - replays} of 3 replayed")
    require(worst <= PIPELINE_LR_TOL, f"{name}: the scheduled LR is {worst:.3e} off the host curve")
    return got


def drive_dgcn_training(card: str):
    """DialogueGCN training at full width through DGCNTrainer with the banded
    graph, cuDNN's TF32 flag on: launches of one step by instantiation,
    gradients and 3 steps' losses ≡ the dense graph's, the card ≡ the CPU at
    dropout 0, an epoch and test() as the main path, dialogues/s banded vs
    dense, a profile of one step, the port's SGD (`_dgcn_sgd`), and train →
    save → serve.  Returns the training path's launches, variants and taps,
    and the SGD steps' launches."""
    import tempfile

    import numpy as np
    import torch
    from erc_tpu_torch.data.loader import to_device
    from erc_tpu_torch.ops.kernels import banded as kb

    band = _dgcn_trainer()
    p = band.params
    n_params = sum(t.numel() for t in band.model.parameters())
    require(n_params == DGCN_PARAMS, f"DialogueGCN has {n_params} parameters, want {DGCN_PARAMS}")
    require(band.class_weights is not None, "DGCNTrainer set no class weights for 6 classes")
    log(f"trainer: DialogueGCN {p.hidden_all} -> {p.hidden_size}, wp {p.wp} wf {p.wf}, batch {p.train.batch_size}, "
        f"{p.optim.name} lr {p.optim.lr} weight decay {p.optim.weight_decay}, dropout {p.drop_rate}, class weights, "
        f"{n_params} params, graph_impl banded, on {torch.cuda.get_device_name(0)}")
    dense = _dgcn_trainer("dense")
    host = list(band.make_loader("train"))  # epoch 0: the batches train() will take
    batches = [to_device(b, band.device) for b in host[:3]]

    _reset_launches()
    band.compute_grads(batches[0])
    launches, variants, taps = _read_launches(), dict(kb.variant_launches), dict(kb.tap_launches)
    log(f"DialogueGCN train step of one batch (L {host[0]['input_tensor'].shape[1]}): launches {launches}; by "
        f"instantiation {_nonzero(taps)}")
    require({k: launches[k] for k in DGCN_STEP_LAUNCHES} == DGCN_STEP_LAUNCHES,
            f"DialogueGCN train step launches {launches}, want {DGCN_STEP_LAUNCHES}")
    require(_nonzero(taps) == DGCN_STEP_TAPS, f"DialogueGCN train step by instantiation {_nonzero(taps)}")
    require(all(variants[f"{k}/scalar"] == 0 for k in DGCN_STEP_LAUNCHES), f"a 4-byte launch: {variants}")
    dense.compute_grads(batches[0])
    worst, name = _worst_grad_diff(band.model, dense.model)
    log(f"DialogueGCN first-batch gradients, banded vs dense on the card: worst {worst:.3e} ({name}), "
        f"tolerance {TRAIN_TOL}")
    require(worst <= TRAIN_TOL, f"DialogueGCN banded vs dense gradients {worst} ({name}) > {TRAIN_TOL}")

    losses = {}
    for label, t in (("banded", band), ("dense", dense)):
        losses[label] = [t.train_step(b)["Lall"].item() for b in batches]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["banded"], losses["dense"]))
    log(f"3 DialogueGCN train steps, losses banded {losses['banded']} vs dense {losses['dense']}: worst relative "
        f"diff {rel:.3e} (tolerance {TRAIN_TOL})")
    require(rel <= TRAIN_TOL, f"DialogueGCN banded vs dense losses differ by {rel} > {TRAIN_TOL}")
    del band, dense

    _card_vs_cpu_steps("DialogueGCN", _dgcn_trainer(dropout=0.0), _dgcn_trainer(device="cpu", dropout=0.0), host)

    # the main path: one epoch (120 dialogues) and test() through DGCNTrainer.train, banded
    run, other = _dgcn_trainer(), _dgcn_trainer("dense")
    n_test = len(list(run.make_loader("test")))
    # the test stage's captures run its forward eagerly first, once a length bucket
    n_eval = n_test + len(_eval_warmups(run.make_loader("test")))
    _reset_launches()
    t0 = time.perf_counter()
    history = run.train()
    wall = time.perf_counter() - t0
    launches, variants, taps = _read_launches(), dict(kb.variant_launches), dict(kb.tap_launches)
    _check_epoch_graphs("DialogueGCN", run, host)
    rec = history[0]
    want = {k: rec["steps"] * DGCN_STEP_TAPS.get(k, 0) + n_eval * DGCN_FORWARD_TAPS.get(k, 0)
            for k in set(DGCN_STEP_TAPS) | set(DGCN_FORWARD_TAPS)}
    log(f"DialogueGCN training path: {rec['steps']} steps over {rec['dialogues']} dialogues, then test() "
        f"({n_test} batches replayed, {n_eval - n_test} run before their capture) in {wall:.3f} s; launches "
        f"{launches}; by instantiation {_nonzero(taps)}")
    require(_nonzero(taps) == want, f"DialogueGCN training path by instantiation {_nonzero(taps)}, want {want}")
    require({k: launches[k] for k in DGCN_STEP_LAUNCHES} == _by_kernel(want), f"DialogueGCN training launches {launches}")
    require(all(variants[f"{k}/scalar"] == 0 for k in DGCN_STEP_LAUNCHES), f"a 4-byte launch: {variants}")
    res = rec["test"]
    require(all(math.isfinite(x) for x in (rec["Lall"], rec["gnorm"], res["Lall"], res["f1"])),
            f"non-finite DialogueGCN training results {rec}")
    log(f"DialogueGCN epoch 0: loss {rec['Lall']:.5f}, gnorm {rec['gnorm']:.5f}; test loss {res['Lall']:.5f}, "
        f"weighted F1 {res['f1']:.5f}, acc {res['acc']:.5f}")

    rates = {"banded": [rec["dialogues"] / rec["seconds"]], "dense": []}
    for label, t in (("dense", other), ("banded", run), ("dense", other), ("banded", run)):
        if rates[label]:
            t.eidx += 1
        t.params.epoch = t.eidx + 1
        r = t.train()[-1]
        rates[label].append(r["dialogues"] / r["seconds"])
    log(f"DialogueGCN training throughput (train steps of an epoch, {rec['dialogues']} dialogues, batch "
        f"{p.train.batch_size}): banded {', '.join(f'{x:.1f}' for x in rates['banded'])} dialogues/s (first epoch "
        f"first), dense {', '.join(f'{x:.1f}' for x in rates['dense'])} dialogues/s on {card}")

    check_train_graphs("DialogueGCN banded", run, host, card, timed=host[2], show=("banded_", "RNN", "rnn"))
    _epoch_rates("DialogueGCN banded", run, card)
    check_train_graphs("DialogueGCN dense", other, host, card, timed=host[2], show=("RNN", "rnn"))
    _epoch_rates("DialogueGCN dense", other, card)
    _test_replayed_vs_eager("DialogueGCN", run, traced=True)
    del run, other
    sgd = _dgcn_sgd(card, host)

    from erc_tpu_torch.models import dgcn
    from erc_tpu_torch.serve import InferenceEngine

    with tempfile.TemporaryDirectory() as tmp:
        trainer = dgcn.main([*DGCN_TRAIN_ARGS, "--graph_impl=banded", "--epoch=1", "--batch_count=2",
                             f"--save_dir={tmp}"])
        path = Path(tmp) / "model.last.ckpt"
        require(path.exists(), f"main saved no {path}")
        tp = trainer.params
        engine = InferenceEngine.from_module("dgcn", str(path), dataset=tp.dataset,
                                             batch_size=int(tp.test.batch_size), graph_impl=tp.graph_impl,
                                             max_seq_len=tp.max_seq_len)
        test_batch = next(iter(trainer.make_loader("test")))
        trainer.model.eval()
        with torch.inference_mode():
            eval_batch = to_device(test_batch, trainer.device)
            want_logits = trainer.model(eval_batch).float().cpu().numpy()
        got = engine.logits(test_batch)
        diff = float(np.abs(got - want_logits).max())
        log(f"DialogueGCN train -> save -> serve: {trainer.global_steps} steps, saved {path.name}; InferenceEngine "
            f"logits vs the trainer's eval logits max abs diff {diff:.3e}")
        require(diff == 0.0, f"served DialogueGCN logits differ from the trainer's eval logits by {diff}")
    return launches, variants, taps, sgd


# ------------------------------------------------------------------ phases 9 and 10
MMGCN_PARAMS = 5_794_006


def _no_kernel_launches(what: str) -> dict:
    """MMGCN's and DialogueGCN v2's graph products and CIM's attentions are torch.bmm / torch.matmul, and MMIN
    runs cuDNN's LSTM and convolutions and dense layers: no hand-written kernel runs on their paths."""
    launches = _read_launches()
    require(not any(launches.values()), f"{what}: a hand-written kernel launched on the path: {launches}")
    return launches


def drive_mmgcn(card: str):
    """MMGCN serving at full width through InferenceEngine, dense and
    structured adjacency, cuDNN's TF32 flag on: predict (every launch count
    stays 0), structured ≡ dense, card ≡ CPU, a single-dialogue request,
    latency, throughput and profile of both forms."""
    import torch
    from erc_tpu_torch.serve import InferenceEngine

    kw = dict(dataset="synthetic-cogmen-6", batch_size=32)
    engine = InferenceEngine.from_module("mmgcn", **kw)
    p = engine.params
    n_params = sum(t.numel() for t in engine.model.parameters())
    require(n_params == MMGCN_PARAMS, f"MMGCN has {n_params} parameters, want {MMGCN_PARAMS}")
    log(f"engine: MMGCN {p.hidden_audio}/{p.hidden_visual}/{p.hidden_text} (a/v/t) -> 200, text 2-layer biLSTM "
        f"200, {p.gcn_layers} GCNII layers of {p.graph_hidden_size} (chunk {p.gcn_chunk}), adj_impl "
        f"{p.adj_impl}, {n_params} params, batch 32, cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, on "
        f"{torch.cuda.get_device_name(0)}")
    dialogues, desc = _dialogues()
    n_batches = -(-len(dialogues) // engine.batch_size)

    engine.predict(dialogues)  # the first batch of each length bucket is captured
    _reset_launches()
    results = engine.predict(dialogues)
    launches = _no_kernel_launches("MMGCN serving")
    log(f"MMGCN path: {desc} in {n_batches} batches, replayed ({engine.captured.captures} graphs); launches "
        f"{launches}")
    _check_results(dialogues, results)

    # structured ≡ dense on the card, and ≡ the CPU run of the same weights
    structured = InferenceEngine.from_module("mmgcn", adj_impl="structured", **kw)
    structured.model.load_state_dict(engine.model.state_dict())
    cpu = InferenceEngine.from_module("mmgcn", device="cpu", **kw)
    cpu.model.load_state_dict(engine.model.state_dict())
    t0 = time.perf_counter()
    worst_struct, worst_cpu = _worst_logit_diffs(engine, [structured, cpu], dialogues)
    log(f"MMGCN logits: structured vs dense on the card max abs diff {worst_struct:.3e}; card vs CPU "
        f"{worst_cpu:.3e} (tolerance {PATH_TOL}; cudnn.allow_tf32 on; {time.perf_counter() - t0:.2f} s)")
    require(worst_struct <= PATH_TOL, f"MMGCN structured vs dense {worst_struct} > {PATH_TOL}")
    require(worst_cpu <= PATH_TOL, f"MMGCN card vs CPU {worst_cpu} > {PATH_TOL}")

    # the captured forward ≡ the eager one in both forms
    eagers = {}
    for adj in ("dense", "structured"):
        eagers[adj] = InferenceEngine.from_module("mmgcn", adj_impl=adj, cuda_graphs=False, **kw)
        eagers[adj].model.load_state_dict(engine.model.state_dict())
    _replay_vs_eager("MMGCN dense", engine, eagers["dense"])
    _replay_vs_eager("MMGCN structured", structured, eagers["structured"])

    # one dialogue: the batch carries 31 all-padding dialogues (LSTM rows of length 0)
    one = engine.predict([dialogues[0]])
    _check_results(dialogues[:1], one)
    for name, eng, eag in (("MMGCN dense", engine, eagers["dense"]),
                           ("MMGCN structured", structured, eagers["structured"])):
        _eager_and_replayed(name, eng, eag, dialogues, card, show=("RNN", "rnn"))
    return launches


MMGCN_TRAIN_ARGS = ["--dataset=synthetic-cogmen-6", "--max_seq_len=96", "--confusion_matrix=false"]


def _mmgcn_trainer(adj_impl="dense", *extra, device="cuda", dropout=None):
    """An MMGCNTrainer at MMGCNParams' settings, which are IEMOCAP's reimplement ones (712 -> 200, 64 GCNII
    layers of 200, batch 16, Adam 3e-4 with L2 3e-5, dropout 0.4, gcn_remat full in trips of 8; weights from
    seed 1, the same on every device), max_seq_len 96, one epoch."""
    from erc_tpu_torch.models import mmgcn

    p = mmgcn.MMGCNParams()
    p.finalize([*MMGCN_TRAIN_ARGS, f"--adj_impl={adj_impl}", f"--device={device}", "--epoch=1", *extra])
    if dropout is not None:
        p.drop_rate = dropout
    trainer = mmgcn.MMGCNTrainer(p)
    trainer.log = lambda msg: log(f"  [trainer] {msg}")
    trainer.initialize()
    return trainer


def drive_mmgcn_training(card: str):
    """MMGCN training at full width through MMGCNTrainer, cuDNN's TF32 flag
    on: remat full ≡ off gradients at dropout 0.4 from one generator state
    (the recompute draws no masks), structured ≡ dense gradients and 3
    steps' losses, the card ≡ the CPU at dropout 0, an epoch and test() as
    the main path (no hand-written kernel launched), dialogues/s dense vs
    structured, a profile of one step, and train → save → serve."""
    import tempfile

    import numpy as np
    import torch
    from erc_tpu_torch.data.loader import to_device

    dense = _mmgcn_trainer()
    p = dense.params
    n_params = sum(t.numel() for t in dense.model.parameters())
    require(n_params == MMGCN_PARAMS, f"MMGCN has {n_params} parameters, want {MMGCN_PARAMS}")
    require(dense.grad_clip_norm is None and dense.lr_sche is None and dense.class_weights is None,
            "MMGCNTrainer set a clip, a plateau controller or class weights")
    log(f"trainer: MMGCN {p.hidden_all} -> 200, {p.gcn_layers} GCNII layers of {p.graph_hidden_size}, batch "
        f"{p.train.batch_size}, {p.optim.name} lr {p.optim.lr} L2 {p.optim.weight_decay}, dropout {p.drop_rate}, "
        f"gcn_remat {p.gcn_remat} (chunk {p.gcn_chunk}), {n_params} params, adj_impl dense, on "
        f"{torch.cuda.get_device_name(0)}")
    host = list(dense.make_loader("train"))  # epoch 0: the batches train() will take
    batches = [to_device(b, dense.device) for b in host[:3]]

    # remat full ≡ off at dropout 0.4: the trip's masks are drawn before its checkpoint
    off = _mmgcn_trainer("dense", "--gcn_remat=off")
    _reset_launches()
    dense.compute_grads(batches[0])
    launches = _no_kernel_launches("MMGCN train step")
    off.compute_grads(batches[0])
    worst, name = _worst_grad_diff(dense.model, off.model)
    same_rng = bool(torch.equal(dense._dropout_rng.get_state(), off._dropout_rng.get_state()))
    log(f"MMGCN first-batch gradients at dropout {p.drop_rate}, gcn_remat full vs off on the card: worst "
        f"{worst:.3e} ({name}), tolerance {TRAIN_TOL}; generators in the same state after both: {same_rng}")
    require(worst <= TRAIN_TOL, f"MMGCN remat full vs off gradients {worst} ({name}) > {TRAIN_TOL}")
    require(same_rng, "the checkpointed run drew from the dropout generator a different number of times")
    del off

    # structured ≡ dense: gradients of the first batch, then 3 steps on the same dropout masks
    struct = _mmgcn_trainer("structured")
    struct.compute_grads(batches[0])
    worst, name = _worst_grad_diff(struct.model, dense.model)
    log(f"MMGCN first-batch gradients, structured vs dense on the card: worst {worst:.3e} ({name}), "
        f"tolerance {TRAIN_TOL}")
    require(worst <= TRAIN_TOL, f"MMGCN structured vs dense gradients {worst} ({name}) > {TRAIN_TOL}")
    losses = {}
    for label, t in (("structured", struct), ("dense", dense)):
        losses[label] = [t.train_step(b)["Lall"].item() for b in batches]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["structured"], losses["dense"]))
    log(f"3 MMGCN train steps, losses structured {losses['structured']} vs dense {losses['dense']}: worst "
        f"relative diff {rel:.3e} (tolerance {TRAIN_TOL})")
    require(rel <= TRAIN_TOL, f"MMGCN structured vs dense losses differ by {rel} > {TRAIN_TOL}")
    del struct, dense

    _card_vs_cpu_steps("MMGCN", _mmgcn_trainer(dropout=0.0), _mmgcn_trainer(device="cpu", dropout=0.0), host)

    # the main path: one epoch (120 dialogues) and test() through MMGCNTrainer.train, dense
    run, other = _mmgcn_trainer(), _mmgcn_trainer("structured")
    n_test = len(list(run.make_loader("test")))
    _reset_launches()
    t0 = time.perf_counter()
    history = run.train()
    wall = time.perf_counter() - t0
    launches = _no_kernel_launches("MMGCN training path")
    _check_epoch_graphs("MMGCN", run, host)
    rec = history[0]
    log(f"MMGCN training path: {rec['steps']} steps over {rec['dialogues']} dialogues, then test() ({n_test} "
        f"batches) in {wall:.3f} s; launches {launches}")
    res = rec["test"]
    require(all(math.isfinite(x) for x in (rec["Lall"], rec["gnorm"], res["Lall"], res["f1"])),
            f"non-finite MMGCN training results {rec}")
    log(f"MMGCN epoch 0: loss {rec['Lall']:.5f}, gnorm {rec['gnorm']:.5f}; test loss {res['Lall']:.5f}, "
        f"weighted F1 {res['f1']:.5f}, acc {res['acc']:.5f}")

    rates = {"dense": [rec["dialogues"] / rec["seconds"]], "structured": []}
    for label, t in (("structured", other), ("dense", run), ("structured", other), ("dense", run)):
        if rates[label]:
            t.eidx += 1
        t.params.epoch = t.eidx + 1
        r = t.train()[-1]
        rates[label].append(r["dialogues"] / r["seconds"])
    log(f"MMGCN training throughput (train steps of an epoch, {rec['dialogues']} dialogues, batch "
        f"{p.train.batch_size}): dense {', '.join(f'{x:.1f}' for x in rates['dense'])} dialogues/s (first epoch "
        f"first), structured {', '.join(f'{x:.1f}' for x in rates['structured'])} dialogues/s on {card}")

    for label, t in (("dense", run), ("structured", other)):
        check_train_graphs(f"MMGCN {label}", t, host, card, timed=host[2], show=("RNN", "rnn"))
        _epoch_rates(f"MMGCN {label}", t, card)
    _test_replayed_vs_eager("MMGCN", run)

    from erc_tpu_torch.models import mmgcn
    from erc_tpu_torch.serve import InferenceEngine

    with tempfile.TemporaryDirectory() as tmp:
        trainer = mmgcn.main([*MMGCN_TRAIN_ARGS, "--adj_impl=structured", "--epoch=1", "--batch_count=2",
                              f"--save_dir={tmp}"])
        path = Path(tmp) / "model.last.ckpt"
        require(path.exists(), f"main saved no {path}")
        tp = trainer.params
        engine = InferenceEngine.from_module("mmgcn", str(path), dataset=tp.dataset,
                                             batch_size=int(tp.test.batch_size), adj_impl=tp.adj_impl,
                                             max_seq_len=tp.max_seq_len)
        test_batch = next(iter(trainer.make_loader("test")))
        trainer.model.eval()
        with torch.inference_mode():
            eval_batch = to_device(test_batch, trainer.device)
            want_logits = trainer.model(eval_batch).float().cpu().numpy()
        got = engine.logits(test_batch)
        diff = float(np.abs(got - want_logits).max())
        log(f"MMGCN train -> save -> serve: {trainer.global_steps} steps, saved {path.name}; InferenceEngine "
            f"logits vs the trainer's eval logits max abs diff {diff:.3e}")
        require(diff == 0.0, f"served MMGCN logits differ from the trainer's eval logits by {diff}")
    return launches


# ------------------------------------------------------------------ phases 11 to 13
DGCNV2_PARAMS = {"DialogRNN": 2_977_146, "LSTM": 1_679_946, "GRU": 1_456_746, "None": 929_746}
DGCNV2_DAILY_PARAMS = 7_385_697
DGCNV2_TRAIN_PARAMS = 2_970_746  # DialogRNN at max_seq_len 96: the edge attention's W has 96 rows, not 128


def drive_dgcnv2(card: str):
    """DialogueGCN v2 serving (the feature track) at full width through
    InferenceEngine, cuDNN's TF32 flag on: with DialogueRNN and the biLSTM as
    base encoder, predict (every launch count stays 0), card ≡ CPU, a
    single-dialogue request, latency, throughput and profile; with the biGRU
    and the linear base, one batch card ≡ CPU."""
    import numpy as np
    import torch
    from erc_tpu_torch.serve import InferenceEngine

    kw = dict(dataset="synthetic-cogmen-6", batch_size=32)
    dialogues, desc = _dialogues()
    n_batches = -(-len(dialogues) // 32)
    for base in ("DialogRNN", "LSTM", "GRU", "None"):
        engine = InferenceEngine.from_module("dgcnv2", base_model=base, **kw)
        p = engine.params
        n_params = sum(t.numel() for t in engine.model.parameters())
        require(n_params == DGCNV2_PARAMS[base], f"dgcnv2 {base} has {n_params} parameters, want {DGCNV2_PARAMS[base]}")
        cpu = InferenceEngine.from_module("dgcnv2", base_model=base, device="cpu", **kw)
        cpu.model.load_state_dict(engine.model.state_dict())
        name = f"DialogueGCN v2 ({base})"
        if base in ("GRU", "None"):
            batch = engine.batcher(dialogues[:32])
            engine.logits(batch)  # captured
            _reset_launches()
            diff = float(np.abs(engine.logits(batch) - cpu.logits(batch)).max())
            _no_kernel_launches(f"{name} serving")
            log(f"{name} serving, one batch of 32 (L {batch['input_tensor'].shape[1]}): {n_params} params; card vs CPU "
                f"logits max abs diff {diff:.3e} (tolerance {PATH_TOL})")
            require(diff <= PATH_TOL, f"{name} card vs CPU {diff} > {PATH_TOL}")
            continue
        log(f"engine: {name} {p.hidden_all} -> base {base} of {p.hidden_size} a direction (D_g {p.get('d_g', 150)}), "
            f"wp {p.wp} wf {p.wf}, RGCN (30 bases, add) + GraphConv, nodal attention, {n_params} params, batch 32, "
            f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, on {torch.cuda.get_device_name(0)}")
        engine.predict(dialogues)  # the first batch of each length bucket is captured
        _reset_launches()
        results = engine.predict(dialogues)
        launches = _no_kernel_launches(f"{name} serving")
        log(f"{name} path: {desc} in {n_batches} batches, replayed ({engine.captured.captures} graphs); launches "
            f"{launches}")
        _check_results(dialogues, results)
        t0 = time.perf_counter()
        (worst_cpu,) = _worst_logit_diffs(engine, [cpu], dialogues)
        log(f"{name} logits: card vs CPU max abs diff {worst_cpu:.3e} (tolerance {PATH_TOL}; cudnn.allow_tf32 on; "
            f"{time.perf_counter() - t0:.2f} s)")
        require(worst_cpu <= PATH_TOL, f"{name} card vs CPU {worst_cpu} > {PATH_TOL}")
        # one dialogue: the batch carries 31 all-padding dialogues
        _check_results(dialogues[:1], engine.predict([dialogues[0]]))
        # the captured forward ≡ the eager one
        eager = InferenceEngine.from_module("dgcnv2", base_model=base, cuda_graphs=False, **kw)
        eager.model.load_state_dict(engine.model.state_dict())
        _replay_vs_eager(name, engine, eager)
        _eager_and_replayed(name, engine, eager, dialogues, card, show=("RNN", "rnn"))


DGCNV2_TRAIN_ARGS = ["--dataset=synthetic-cogmen-6", "--base_model=DialogRNN", "--max_seq_len=96",
                     "--confusion_matrix=false"]
# the token track at full width: 96 train dialogues (3 steps of 32), 32 test ones (1 batch), L = 128 static
DGCNV2_DAILY_TRAIN_ARGS = ["--dataset=synthetic-daily-token-7", "--synthetic_n_train=96", "--confusion_matrix=false"]


def _dgcnv2_trainer(daily=False, *extra, device="cuda", dropout_off=False):
    """A DGCNV2Trainer at DGCNV2Params' settings (712 -> DialogueRNN, D_g = D_p = 150, 100 a direction, wp = wf
    = 10, batch 32, Adam 3e-4, dropouts 0.5 (DialogueRNN) and 0.5 (head), IEMOCAP-6 class weights), max_seq_len
    96; or a DGCNV2DailyTrainer at DGCNV2DailyParams' (vocabulary 20 000, embedding 300, 50 words, TextCNN 50
    filters of 3/4/5 -> 100, biLSTM of 100, max_seq_len 128, batch 32, Adam 3e-4, dropouts 0.5/0.4/0.5). One
    epoch; weights from seed 1, the same on every device.  `dropout_off` sets every dropout to 0."""
    from erc_tpu_torch.models import dgcnv2
    from erc_tpu_torch.ops.dropout import Dropout

    p = dgcnv2.DGCNV2DailyParams() if daily else dgcnv2.DGCNV2Params()
    p.finalize([*(DGCNV2_DAILY_TRAIN_ARGS if daily else DGCNV2_TRAIN_ARGS), f"--device={device}", "--epoch=1",
                *extra])
    trainer = (dgcnv2.DGCNV2DailyTrainer if daily else dgcnv2.DGCNV2Trainer)(p)
    trainer.log = lambda msg: log(f"  [trainer] {msg}")
    trainer.initialize()
    if dropout_off:
        for m in trainer.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return trainer


def _replayed_batches(host) -> list:
    """Four steps' host batches of which the last two replay a captured step: the first two batches of the two
    smallest shape buckets in turns (of the one bucket, its first four, where all share one)."""
    buckets = _host_buckets(host)
    if len(buckets) == 1:
        return buckets[0][:4]
    a, b = buckets[0], buckets[1]
    return [a[0], b[0], a[-1], b[-1]]


def _card_vs_cpu_steps(name, card0, cpu0, host):
    """At dropout 0: the first batch's gradients (eager on both), then 4 steps' losses and gnorm, the card's
    through the captured step (its last two replays) against the CPU's eager steps."""
    import torch
    from erc_tpu_torch.data.loader import to_device

    cuda, cpu = card0.device, torch.device("cpu")
    batches = _replayed_batches(host)
    card0.compute_grads(to_device(batches[0], cuda))
    t0 = time.perf_counter()
    cpu0.compute_grads(to_device(batches[0], cpu))
    t_cpu = time.perf_counter() - t0
    worst, pname = _worst_grad_diff(card0.model, cpu0.model)
    losses = []
    for b in batches:
        mc, mp = card0.train_batch(b), cpu0.train_step(to_device(b, cpu))
        losses.append((mc["Lall"].item(), mp["Lall"].item(), mc["gnorm"].item(), mp["gnorm"].item()))
    replays = card0.captured_step.replays
    rel = max(abs(a - b) / abs(b) for a, b, _, _ in losses)
    rel_g = max(abs(c - d) / abs(d) for _, _, c, d in losses)
    log(f"{name} card (captured step, {replays} of {len(batches)} steps replayed) vs CPU at dropout 0 "
        f"(cudnn.allow_tf32 on): first-batch gradients worst {worst:.3e} ({pname}); {len(losses)} steps' (loss, loss, "
        f"gnorm, gnorm) {losses}, losses worst relative {rel:.3e}, tolerance {TRAIN_TOL} (gnorm {rel_g:.3e}, logged "
        f"only: Adam's steps on near-zero gradients move the weights apart); CPU forward and backward {t_cpu:.2f} s")
    require(replays >= 2, f"{name}: {replays} of the card's steps replayed, want 2")
    require(worst <= TRAIN_TOL, f"{name} card vs CPU gradients {worst} ({pname}) > {TRAIN_TOL}")
    require(rel <= TRAIN_TOL, f"{name} card vs CPU losses differ by {rel} > {TRAIN_TOL}")


def _epoch_and_step(name, run, host, card, check_first=None, unit="dialogues", show=("RNN", "rnn"), extra=(),
                    timed=None):
    """The main path: one epoch and test() on the captured step, with every launch count at 0 before it and none
    launched, one capture a shape bucket and one replay every other batch; then the captured step's checks
    (`check_train_graphs`, timing `timed` or the epoch's last batch), an epoch's `unit`/s (dialogues, or MMIN's
    utterances) eager and replayed, and the test stage replayed vs eager.  `check_first(rec)` runs on the first
    epoch's record."""
    import torch

    n_test = len(list(run.make_loader("test")))
    _reset_launches()
    t0 = time.perf_counter()
    rec = run.train()[0]
    wall = time.perf_counter() - t0
    launches = _no_kernel_launches(f"{name} training path")
    res = rec["test"]
    log(f"{name} training path: {rec['steps']} steps over {rec['dialogues']} {unit}, then test() ({n_test} "
        f"batches) in {wall:.3f} s; launches {launches}")
    _check_epoch_graphs(name, run, host)
    require(all(math.isfinite(x) for x in (rec["Lall"], rec["gnorm"], res["Lall"], res["f1"])),
            f"non-finite {name} training results {rec}")
    log(f"{name} epoch 0: loss {rec['Lall']:.5f}, gnorm {rec['gnorm']:.5f}; test loss {res['Lall']:.5f}, weighted "
        f"F1 {res['f1']:.5f}, acc {res['acc']:.5f}; training throughput (train steps of the first epoch, "
        f"{rec['dialogues']} {unit}, batch {run.params.train.batch_size}, captures included): "
        f"{rec['dialogues'] / rec['seconds']:.1f} {unit}/s on {torch.cuda.get_device_name(0)}")
    if check_first is not None:
        check_first(rec)
    check_train_graphs(name, run, host, card, extra, show=show, timed=host[-1] if timed is None else timed)
    _epoch_rates(name, run, card, unit)
    _test_replayed_vs_eager(name, run)


def drive_dgcnv2_training(card: str):
    """DialogueGCN v2 training (the feature track, DialogueRNN base) at full
    width through DGCNV2Trainer, cuDNN's TF32 flag on: the card ≡ the CPU at
    dropout 0 (gradients and 3 steps' losses), an epoch and test() as the
    main path (no hand-written kernel launched), dialogues/s, a profile of
    one step, and train → save → serve."""
    import tempfile

    import numpy as np
    import torch
    from erc_tpu_torch.data.loader import to_device

    run = _dgcnv2_trainer()
    p = run.params
    n_params = sum(t.numel() for t in run.model.parameters())
    require(n_params == DGCNV2_TRAIN_PARAMS, f"dgcnv2 has {n_params} parameters, want {DGCNV2_TRAIN_PARAMS}")
    require(run.class_weights is not None and run.grad_clip_norm is None and run.lr_sche is None,
            "DGCNV2Trainer: want the class weights at 6 classes, no clip and no plateau controller")
    log(f"trainer: DialogueGCN v2 {p.hidden_all} -> DialogueRNN (D_g {p.get('d_g', 150)}, {p.hidden_size} a "
        f"direction), max_seq_len {p.max_seq_len}, batch "
        f"{p.train.batch_size}, {p.optim.name} lr {p.optim.lr} weight decay {p.optim.weight_decay}, dropout 0.5 "
        f"(DialogueRNN and head), class weights, {n_params} params, on {torch.cuda.get_device_name(0)}")
    host = list(run.make_loader("train"))  # epoch 0: the batches train() will take
    _card_vs_cpu_steps("DialogueGCN v2", _dgcnv2_trainer(dropout_off=True),
                       _dgcnv2_trainer(device="cpu", dropout_off=True), host)
    _epoch_and_step("DialogueGCN v2", run, host, card)
    lstm = _dgcnv2_trainer(False, "--base_model=LSTM")
    lhost = list(lstm.make_loader("train"))
    _card_vs_cpu_steps("DialogueGCN v2 biLSTM", _dgcnv2_trainer(False, "--base_model=LSTM", dropout_off=True),
                       _dgcnv2_trainer(False, "--base_model=LSTM", device="cpu", dropout_off=True), lhost)
    check_train_graphs("DialogueGCN v2 biLSTM", lstm, lhost, card, timed=lhost[-1])
    _epoch_rates("DialogueGCN v2 biLSTM", lstm, card)
    del lstm

    from erc_tpu_torch.models import dgcnv2
    from erc_tpu_torch.serve import InferenceEngine

    with tempfile.TemporaryDirectory() as tmp:
        trainer = dgcnv2.main([*DGCNV2_TRAIN_ARGS, "--epoch=1", "--batch_count=2", f"--save_dir={tmp}"])
        path = Path(tmp) / "model.last.ckpt"
        require(path.exists(), f"main saved no {path}")
        tp = trainer.params
        engine = InferenceEngine.from_module("dgcnv2", str(path), dataset=tp.dataset,
                                             batch_size=int(tp.test.batch_size), base_model=tp.base_model,
                                             max_seq_len=tp.max_seq_len)
        test_batch = next(iter(trainer.make_loader("test")))
        trainer.model.eval()
        with torch.inference_mode():
            eval_batch = to_device(test_batch, trainer.device)
            want_logits = trainer.model(eval_batch).float().cpu().numpy()
        diff = float(np.abs(engine.logits(test_batch) - want_logits).max())
        log(f"DialogueGCN v2 train -> save -> serve: {trainer.global_steps} steps, saved {path.name}; "
            f"InferenceEngine logits vs the trainer's eval logits max abs diff {diff:.3e}")
        require(diff == 0.0, f"served dgcnv2 logits differ from the trainer's eval logits by {diff}")


def drive_dgcnv2_daily_training(card: str):
    """DialogueGCN v2's DailyDialog token track at full width through
    DGCNV2DailyTrainer, cuDNN's TF32 flag on: the card (through the captured
    step) ≡ the CPU at dropout 0 (gradients, the embedding's included, and
    the steps' losses), an epoch and test() as the main path (no hand-written
    kernel launched), the captured step's checks, dialogues/s and a profile
    of an eager and a replayed step."""
    import torch

    run = _dgcnv2_trainer(True)
    p = run.params
    n_params = sum(t.numel() for t in run.model.parameters())
    require(n_params == DGCNV2_DAILY_PARAMS, f"dgcnv2_daily has {n_params} parameters, want {DGCNV2_DAILY_PARAMS}")
    log(f"trainer: DialogueGCN v2 daily, vocabulary {p.vocab_size}, embedding {p.embedding_dim}, {p.n_words} words, "
        f"TextCNN 3/4/5 x 50 -> 100, base {p.base_model} of {p.hidden_size} a direction, L {p.max_seq_len}, batch "
        f"{p.train.batch_size}, {p.optim.name} lr {p.optim.lr}, {n_params} params, on {torch.cuda.get_device_name(0)}")
    host = list(run.make_loader("train"))
    _card_vs_cpu_steps("DialogueGCN v2 daily", _dgcnv2_trainer(True, dropout_off=True),
                       _dgcnv2_trainer(True, device="cpu", dropout_off=True), host)
    # every batch of the track has the static length; a shorter one gives the captured step a second bucket
    _epoch_and_step("DialogueGCN v2 daily", run, host, card,
                    extra=[_other_shape(run, 32, max_len=int(p.max_seq_len) // 2)])


# ------------------------------------------------------------------ phases 14 and 15
CIM_PARAMS = 1_713_613  # CIMParams on synthetic-cogmen-6: audio 100, visual 512, text 100
CIM_MOSEI_PARAMS = 1_346_409  # on synthetic-mosei-2: text 300, audio 74, visual 35


def drive_cim(card: str):
    """CIM serving at full width (synthetic-cogmen-6 geometry: three biGRUs of
    200 a direction, adapters to 100, six cross-modal attentions, heads 6 and 7)
    through InferenceEngine, cuDNN's TF32 flag on: predict (every launch count
    stays 0), card ≡ CPU (the served head, and both heads of one batch), a
    single-dialogue request, latency, throughput and profile."""
    import numpy as np
    import torch
    from erc_tpu_torch.data.loader import to_device
    from erc_tpu_torch.serve import InferenceEngine

    kw = dict(dataset="synthetic-cogmen-6", batch_size=32)
    engine = InferenceEngine.from_module("cim", **kw)
    p = engine.params
    n_params = sum(t.numel() for t in engine.model.parameters())
    require(n_params == CIM_PARAMS, f"CIM has {n_params} parameters, want {CIM_PARAMS}")
    log(f"engine: CIM {p.hidden_audio}/{p.hidden_visual}/{p.hidden_text} (a/v/t) -> biGRU {p.hidden_size} a "
        f"direction each -> adapters 100 -> 6 cross-modal attentions -> heads {p.n_classes} and 7, {n_params} "
        f"params, batch 32, cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, on {torch.cuda.get_device_name(0)}")
    dialogues, desc = _dialogues()
    n_batches = -(-len(dialogues) // engine.batch_size)

    engine.predict(dialogues)  # the first batch of each length bucket is captured
    _reset_launches()
    results = engine.predict(dialogues)
    launches = _no_kernel_launches("CIM serving")
    log(f"CIM path: {desc} in {n_batches} batches, replayed ({engine.captured.captures} graphs); launches "
        f"{launches}")
    _check_results(dialogues, results)

    cpu = InferenceEngine.from_module("cim", device="cpu", **kw)
    cpu.model.load_state_dict(engine.model.state_dict())
    t0 = time.perf_counter()
    (worst_cpu,) = _worst_logit_diffs(engine, [cpu], dialogues)
    batch = engine.batcher(dialogues[:32])
    with torch.inference_mode():
        card7 = engine.model(to_device(batch, engine.device))[1].float().cpu().numpy()
        cpu7 = cpu.model(to_device(batch, cpu.device))[1].numpy()
    worst7 = float(np.abs(card7 - cpu7).max())
    log(f"CIM logits: card vs CPU max abs diff {worst_cpu:.3e} (served head cls2), {worst7:.3e} (cls7, one batch); "
        f"tolerance {PATH_TOL}; cudnn.allow_tf32 on; {time.perf_counter() - t0:.2f} s")
    require(worst_cpu <= PATH_TOL and worst7 <= PATH_TOL, f"CIM card vs CPU {worst_cpu}, {worst7} > {PATH_TOL}")
    # one dialogue: the batch carries 31 all-padding dialogues (uniform attention, finite logits)
    _check_results(dialogues[:1], engine.predict([dialogues[0]]))
    # the captured forward ≡ the eager one
    eager = InferenceEngine.from_module("cim", cuda_graphs=False, **kw)
    eager.model.load_state_dict(engine.model.state_dict())
    _replay_vs_eager("CIM", engine, eager)
    _eager_and_replayed("CIM", engine, eager, dialogues, card, show=("RNN", "rnn", "gemm"))


CIM_TRAIN_ARGS = ["--dataset=synthetic-mosei-2", "--confusion_matrix=false"]


def _cim_trainer(*extra, device="cuda", dropout_off=False):
    """A CIMTrainer at CIMParams' settings on synthetic-mosei-2 (300/74/35 -> biGRUs of 200, batch 16, Adam 1e-3,
    dropout 0.3 twice, the multitask loss Lce + Lmulti; weights from seed 1, the same on every device), one
    epoch; `dropout_off` sets both dropouts to 0."""
    from erc_tpu_torch.models import cim

    p = cim.CIMParams()
    p.finalize([*CIM_TRAIN_ARGS, f"--device={device}", "--epoch=1", *extra])
    trainer = cim.CIMTrainer(p)
    trainer.log = lambda msg: log(f"  [trainer] {msg}")
    trainer.initialize()
    if dropout_off:
        trainer.model.drop0.p = trainer.model.drop1.p = 0.0
    return trainer


def drive_cim_training(card: str):
    """CIM training on synthetic-mosei-2 at full width through CIMTrainer,
    cuDNN's TF32 flag on: the card ≡ the CPU at dropout 0 (gradients and 3
    steps' losses of Lce + Lmulti), then an epoch with the val stage and
    --select_on=val, and test() with the multilabel block, as the main path
    (no hand-written kernel launched); model.best_val.ckpt serves the
    trainer's logits exactly; dialogues/s and a profile of one step."""
    import tempfile

    import numpy as np
    import torch
    from erc_tpu_torch.data.loader import to_device
    from erc_tpu_torch.serve import InferenceEngine

    with tempfile.TemporaryDirectory() as tmp:
        run = _cim_trainer("--select_on=val", f"--save_dir={tmp}")
        p = run.params
        n_params = sum(t.numel() for t in run.model.parameters())
        require(n_params == CIM_MOSEI_PARAMS, f"CIM on MOSEI has {n_params} parameters, want {CIM_MOSEI_PARAMS}")
        require(p.apply_multi and p.mosei_metric == "multiemo" and run.grad_clip_norm is None and run.lr_sche is None,
                "CIMTrainer on synthetic-mosei-2: want the multitask loss and the multilabel metric, no clip and no "
                "plateau controller")
        log(f"trainer: CIM {p.hidden_text}/{p.hidden_audio}/{p.hidden_visual} (t/a/v) -> biGRU {p.hidden_size} a "
            f"direction each, heads {p.n_classes} and 7, batch {p.train.batch_size}, {p.optim.name} lr {p.optim.lr}, "
            f"dropout 0.3 twice, Lce + Lmulti, select_on {p.select_on}, {n_params} params, on "
            f"{torch.cuda.get_device_name(0)}")
        host = list(run.make_loader("train"))
        card0 = _cim_trainer(dropout_off=True)
        require("Lmulti" in card0.compute_grads(to_device(host[0], card0.device)), "no Lmulti in CIM's metrics")
        _card_vs_cpu_steps("CIM", card0, _cim_trainer(device="cpu", dropout_off=True), host)
        del card0

        def check_first(rec):
            val, multi = rec.get("val"), rec["test"].get("multilabel")
            require(val is not None and all(math.isfinite(val[k]) for k in ("Lall", "f1", "acc", "wa")),
                    f"CIM's epoch record has no finite val stage: {val}")
            require(multi is not None and all(math.isfinite(multi[k]) for k in ("emo_acc", "emo_f1", "emo_wa")),
                    f"CIM's test record has no finite multilabel block: {multi}")
            require(math.isfinite(rec["Lmulti"]), f"non-finite CIM Lmulti {rec['Lmulti']}")
            path = Path(tmp) / "model.best_val.ckpt"
            require(path.exists(), f"--select_on=val saved no {path.name}")
            engine = InferenceEngine.from_module("cim", str(path), dataset=p.dataset,
                                                 batch_size=int(p.test.batch_size))
            test_batch = next(iter(run.make_loader("test")))
            run.model.eval()
            with torch.inference_mode():
                want = run.model(to_device(test_batch, run.device))[0].float().cpu().numpy()
            diff = float(np.abs(engine.logits(test_batch) - want).max())
            log(f"CIM epoch 0: val Lall {val['Lall']:.5f}, F1 {val['f1']:.5f}, acc {val['acc']:.5f}; test multilabel "
                f"emo_acc {multi['emo_acc']:.5f}, emo_f1 {multi['emo_f1']:.5f}, emo_wa {multi['emo_wa']:.5f}; "
                f"{path.name} served vs the trainer's eval logits max abs diff {diff:.3e}")
            require(diff == 0.0, f"served best_val logits differ from the trainer's by {diff}")

        longest = max(host, key=lambda b: b["text_feature"].shape[1])  # the step profiled
        _epoch_and_step("CIM", run, host, card, check_first=check_first, timed=longest)


# ------------------------------------------------------------------ phase 16
# the JAX trees' counts (tests/test_torch_mmin_models.py); mmin_miss's frozen encoder is an MMINBaseModule apart
MMIN_PARAMS = {"mmin_base": 2_063_620, "mmin_miss": 5_444_228, "mmin_miss2": 4_127_240}
MMIN_TRAIN_ARGS = ["--dataset=synthetic-mmin-4", "--confusion_matrix=false"]
MMIN_EMA_TOL = 1e-5  # absolute, the EMA shadow after 3 steps: against its formula, and card vs CPU
MMIN_EMA_CHECK_ALPHA = 0.5  # the card vs CPU trainers' alpha: 3 steps move the shadow > 10 x MMIN_EMA_TOL


def _mmin_trainer(module, *extra, device="cuda", dropout_off=False):
    """An MMIN trainer (`module`: mmin_base, mmin_miss or mmin_miss2) at its published settings on synthetic-mmin-4:
    audio 130 x up to 128 frames, visual 50 x 342, text 22 x 1024 -> LSTMs of 128 and a TextCNN of 3 x 128 -> 128,
    classifier 128/128 -> 4 (mmin_miss: ResidualAE (256, 128, 64) x 5 blocks, twice), batch 32, Adam 2e-4, EMA
    0.999; one epoch; weights from seed 1, the same on every device.  `dropout_off` sets every dropout to 0."""
    import importlib

    from erc_tpu_torch.ops.dropout import Dropout

    mod = importlib.import_module(f"erc_tpu_torch.models.{module}")
    p = mod.ParamsType()
    p.finalize([*MMIN_TRAIN_ARGS, f"--device={device}", "--epoch=1", *extra])
    trainer = {"mmin_base": "MMINBaseTrainer", "mmin_miss": "MMINMissTrainer", "mmin_miss2": "MMINMiss2Trainer"}
    trainer = getattr(mod, trainer[module])(p)
    trainer.log = lambda msg: log(f"  [trainer] {msg}")
    trainer.initialize()
    if dropout_off:
        for m in trainer.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return trainer


def _mmin_card_vs_cpu(name, card0, cpu0, host, published):
    """At dropout 0 on the same host batches (the same Missing patterns): the first batch's gradients, 4 steps'
    losses (each of Lall, Lce, Lmse, Lcycle, Lrce the trainer has; the card's through the captured step, the
    last three replayed) and the EMA shadow after them.  The trainers run at
    alpha MMIN_EMA_CHECK_ALPHA, where 3 steps move the shadow by more than 10 x MMIN_EMA_TOL: each device's shadow
    is held against the EMA formula replayed in float32 on the host over that device's weights after each step, so
    a shadow that is not updated, or is updated with another alpha, fails.  Card vs CPU, the shadow that the
    published alpha gives, replayed from each device's weights: the weights' own card vs CPU drift (Adam's steps on
    near-zero gradients) is larger than MMIN_EMA_TOL at alpha 0.5."""
    import torch
    from erc_tpu_torch.data.loader import to_device

    cuda, cpu = card0.device, torch.device("cpu")
    alpha = float(card0.params.ema_alpha)
    require(alpha == MMIN_EMA_CHECK_ALPHA == float(cpu0.params.ema_alpha), f"{name}: EMA check alpha {alpha}")
    batches = _replayed_batches(host)
    card0.compute_grads(to_device(batches[0], cuda))
    t0 = time.perf_counter()
    cpu0.compute_grads(to_device(batches[0], cpu))
    t_cpu = time.perf_counter() - t0
    worst, pname = _worst_grad_diff(card0.model, cpu0.model)

    def weights(t):
        return [w.detach().to("cpu", copy=True) for w in t.model.parameters()]

    def replay(ws, a):
        e = [w.clone() for w in ws[0]]
        for step in ws[1:]:
            e = [x * a + w * (1 - a) for x, w in zip(e, step, strict=True)]
        return e

    def max_abs(xs, ys):
        return max(float((x.cpu() - y.cpu()).abs().max()) for x, y in zip(xs, ys, strict=True))

    losses, traj = [], {"card": [weights(card0)], "cpu": [weights(cpu0)]}
    for b in batches:
        mc, mp = card0.train_batch(b), cpu0.train_step(to_device(b, cpu))
        losses.append({k: (mc[k].item(), mp[k].item()) for k in ("Lall", "Lce", "Lmse", "Lcycle", "Lrce") if k in mp})
        traj["card"].append(weights(card0))
        traj["cpu"].append(weights(cpu0))
    rel = max(abs(a - b) / abs(b) for step in losses for a, b in step.values())
    formula = max(max_abs(list(t.ema_model.parameters()), replay(traj[k], alpha))
                  for k, t in (("card", card0), ("cpu", cpu0)))
    moved = max_abs(replay(traj["card"], alpha), traj["card"][0])
    ema = max_abs(replay(traj["card"], published), replay(traj["cpu"], published))
    replays = card0.captured_step.replays
    require(replays >= 2, f"{name}: {replays} of the card's steps replayed, want 2")
    log(f"{name} card (captured step, {replays} of {len(batches)} steps replayed) vs CPU at dropout 0 (cudnn."
        f"allow_tf32 on): first-batch gradients worst {worst:.3e} ({pname}); {len(losses)} steps' losses {losses}, worst relative {rel:.3e}; tolerance "
        f"{TRAIN_TOL}; EMA shadow at alpha {alpha} vs its formula over each device's weights max abs {formula:.3e}, moved {moved:.3e}; card vs CPU shadow at "
        f"alpha {published} max abs diff {ema:.3e} (tolerance {MMIN_EMA_TOL}); CPU forward and backward {t_cpu:.2f} s")
    require(worst <= TRAIN_TOL, f"{name} card vs CPU gradients {worst} ({pname}) > {TRAIN_TOL}")
    require(rel <= TRAIN_TOL, f"{name} card vs CPU losses differ by {rel} > {TRAIN_TOL}")
    require(moved > 10 * MMIN_EMA_TOL, f"{name}: {len(losses)} steps moved the EMA shadow by {moved}, too little")
    require(formula <= MMIN_EMA_TOL, f"{name}: the EMA shadow differs from its formula by {formula} > {MMIN_EMA_TOL}")
    require(ema <= MMIN_EMA_TOL, f"{name} card vs CPU EMA shadow differs by {ema} > {MMIN_EMA_TOL}")


def _same_weights(module, state) -> bool:
    import torch

    got = module.state_dict()
    return got.keys() == state.keys() and all(torch.equal(got[k].cpu(), state[k].cpu()) for k in state)


def drive_mmin_training(card: str):
    """The MMIN family at full width through its three trainers, cuDNN's TF32 flag on: for each, the parameter
    count against the JAX tree's, card ≡ CPU at dropout 0 (gradients, 3 steps' losses, the EMA shadow, see
    _mmin_card_vs_cpu), then an
    epoch with the val stage and --select_on=val and test() as the main path (no hand-written kernel launched; Acc2
    finite in the val row and the test result; model.best_val.ckpt loaded into a fresh trainer gives its raw and
    EMA eval logits bit for bit), utterances/s and a profile of one step.  mmin_miss and mmin_miss2 take
    mmin_base's model.best_val.ckpt as --pretrain_path: the frozen encoder equals it and does not move; netB and
    its EMA shadow equal it and net does not."""
    import tempfile

    import torch
    from erc_tpu_torch.data.loader import to_device

    with tempfile.TemporaryDirectory() as tmp:
        pretrain = Path(tmp) / "mmin_base" / "model.best_val.ckpt"
        for module in ("mmin_base", "mmin_miss", "mmin_miss2"):
            extra = () if module == "mmin_base" else (f"--pretrain_path={pretrain}",)
            run = _mmin_trainer(module, "--select_on=val", f"--save_dir={Path(tmp) / module}", *extra)
            p = run.params
            n_params = sum(t.numel() for t in run.model.parameters())
            require(n_params == MMIN_PARAMS[module], f"{module} has {n_params} parameters, want {MMIN_PARAMS[module]}")
            require(run.ema_model is not None and run.plateau_source == "val" and run.lr_sche is not None,
                    f"{module}: want the EMA shadow and the plateau controller on the val loss")
            frozen = ""
            if module == "mmin_miss":
                n_frozen = sum(t.numel() for t in run.pretrained_model.parameters())
                require(n_frozen == MMIN_PARAMS["mmin_base"], f"the frozen encoder has {n_frozen} parameters")
                frozen = f" (+ a frozen MMINBaseModule of {n_frozen})"
            log(f"trainer: {module} audio {p.hidden_audio} x {p.max_audio_len} frames, visual {p.hidden_visual}, "
                f"text {p.hidden_text} -> LSTMs 128, TextCNN 3 x 128 -> 128, classifier 128/128 -> {p.n_classes}, "
                f"batch {p.train.batch_size}, {p.optim.name} lr {p.optim.lr}, EMA {p.ema_alpha}, select_on "
                f"{p.select_on}, {n_params} params{frozen}, on {torch.cuda.get_device_name(0)}")
            if module != "mmin_base":
                want = torch.load(pretrain, map_location="cpu", weights_only=True)["model"]
                if module == "mmin_miss":
                    require(_same_weights(run.pretrained_model, want), "the frozen encoder is not the pretrained file")
                    before = {k: v.clone() for k, v in run.pretrained_model.state_dict().items()}
                else:
                    require(_same_weights(run.model.netB, want) and _same_weights(run.ema_model.netB, want),
                            "mmin_miss2's netB or its EMA shadow is not the pretrained file")
                    require(not _same_weights(run.model.net, want), "mmin_miss2's net took the pretrained file")
            host = list(run.make_loader("train"))  # epoch 0: the batches train() will take
            require(("text_feature_reverse" in host[0]) == (module != "mmin_base"), "Missing patterns on the wrong path")
            check = (*extra, f"--ema_alpha={MMIN_EMA_CHECK_ALPHA}")
            _mmin_card_vs_cpu(module, _mmin_trainer(module, *check, dropout_off=True),
                              _mmin_trainer(module, *check, device="cpu", dropout_off=True), host, float(p.ema_alpha))

            def check_first(rec, module=module, run=run):
                val, res = rec.get("val"), rec["test"]
                require(val is not None and all(math.isfinite(val[k]) for k in ("Lall", "f1", "Acc2")),
                        f"{module}'s epoch record has no finite val stage with Acc2: {val}")
                require(math.isfinite(res.get("Acc2", math.nan)), f"{module}'s test result has no finite Acc2: {res}")
                path = Path(run.params.save_dir) / "model.best_val.ckpt"
                require(path.exists(), f"--select_on=val saved no {path.name}")
                fresh = _mmin_trainer(module, *extra)
                fresh.load_state_tree(torch.load(path, map_location="cpu", weights_only=True))
                batch = to_device(next(iter(run.make_loader("test"))), run.device)
                run.model.eval()
                fresh.model.eval()
                with torch.inference_mode():
                    pairs = list(zip(run.to_logits(batch), fresh.to_logits(batch), strict=True))
                diff = max(float((a - b).abs().max()) for a, b in pairs)
                log(f"{module} epoch 0: val Lall {val['Lall']:.5f}, F1 {val['f1']:.5f}, Acc2 {val['Acc2']:.5f}; test "
                    f"Acc2 {res['Acc2']:.5f}; {path.name} in a fresh trainer vs the trainer's raw and EMA eval "
                    f"logits max abs diff {diff:.3e}")
                require(diff == 0.0, f"{module}: best_val in a fresh trainer differs from the trainer by {diff}")

            # every batch is padded to 32 utterances; one of 16 gives the captured step a second bucket
            _epoch_and_step(module, run, host, card, check_first=check_first, unit="utterances",
                            show=("RNN", "rnn", "conv", "fft", "Conv"), extra=[_other_shape(run, 16, pad_batch_to=16)])
            if module == "mmin_miss":
                require(_same_weights(run.pretrained_model, before), "the frozen encoder moved in training")
                log("mmin_miss: the frozen encoder equals the pretrained file before and after the epochs")


# ------------------------------------------------------------------ the precision phase
BF16_VS_F32_TOL = 5e-2  # bfloat16 against float32 losses, 3 steps: the JAX package's bound (test_round2_fixes.py)
CPU_LOSS_TOL, CPU_GRAD_TOL, CPU_GRAD_FLOOR = 2e-2, 5e-2, 1e-3  # the card's bfloat16 step vs the CPU's: the CPU tests'
TF32_TOL = 1e-2  # a TF32 step against the strict one
CPU_ROWS = 4  # rows of the batch that the card's bfloat16 gradients are held to the CPU's on (CPU time) ...
WHOLE_BATCH = ("mmin_base", "mmin_miss", "mmin_miss2")  # ... or all 32, where that is cheap on the CPU: on 4 rows,
# a few ReLU inputs near 0 that take another sign on the card move mmin_miss's classifier's bfloat16 gradients by up
# to 13 % of their norm (PERF.md §6, `scripts/torch_train_numerics.py bf16`)


def _precision_configs():
    """(name, trainer factory (extra args, device, dropout off), the second shape bucket's batches or None, unit)
    of every configuration that trains in bfloat16, at the widths of its earlier phase."""
    def off(dropout):
        return 0.0 if dropout else None

    return [
        ("COGMEN dense", lambda *e, device="cuda", d=False: _cogmen_trainer("dense", *e, device=device,
                                                                            dropout=off(d)), None, "dialogues"),
        ("DAG-ERC eager form", lambda *e, device="cuda", d=False: _trainer("--dag_impl=auto", "--max_seq_len=32", *e,
                                                                           device=device, dropout=off(d)),
         lambda run: [_other_shape(run, 16, max_len=16)], "dialogues"),
        ("DialogueGCN dense", lambda *e, device="cuda", d=False: _dgcn_trainer("dense", *e, device=device,
                                                                               dropout=off(d)), None, "dialogues"),
        ("MMGCN dense", lambda *e, device="cuda", d=False: _mmgcn_trainer("dense", *e, device=device, dropout=off(d)),
         None, "dialogues"),
        ("DialogueGCN v2 biLSTM", lambda *e, device="cuda", d=False: _dgcnv2_trainer(
            False, "--base_model=LSTM", *e, device=device, dropout_off=d), None, "dialogues"),
        ("DialogueGCN v2 token track", lambda *e, device="cuda", d=False: _dgcnv2_trainer(
            True, *e, device=device, dropout_off=d),
         lambda run: [_other_shape(run, 32, max_len=int(run.params.max_seq_len) // 2)], "dialogues"),
        ("CIM", lambda *e, device="cuda", d=False: _cim_trainer(*e, device=device, dropout_off=d), None, "dialogues"),
        *[(m, lambda *e, device="cuda", d=False, m=m: _mmin_trainer(m, *e, device=device, dropout_off=d),
           lambda run: [_other_shape(run, 16, pad_batch_to=16)], "utterances")
          for m in ("mmin_base", "mmin_miss", "mmin_miss2")],
    ]


def _rows(batch, n):
    """The first `n` rows of a host batch."""
    return {k: None if v is None else v[:n] for k, v in batch.items()}


def _grads(run, batch):
    """The loss and every parameter's gradient (float64, on the host) of one compute_grads of a host batch."""
    from erc_tpu_torch.data.loader import to_device

    loss = run.compute_grads(to_device(batch, run.device))["Lall"].item()
    return loss, {n: p.grad.double().cpu() for n, p in run.model.named_parameters()}


def _bf16_runs(make, card16, card32):
    """card16's weights (and frozen encoder) in card32 and in a bfloat16 and a float32 CPU trainer at dropout 0:
    {"card16", "card32", "cpu16", "cpu32"} -> trainer."""
    runs = {"card16": card16, "card32": card32, "cpu16": make("--compute_dtype=bfloat16", device="cpu", d=True),
            "cpu32": make(device="cpu", d=True)}
    for t in list(runs.values())[1:]:
        t.model.load_state_dict(card16.model.state_dict())
        if getattr(t, "pretrained_model", None) is not None:
            t.pretrained_model.load_state_dict(card16.pretrained_model.state_dict())
    return runs


def _bf16_gaps(g):
    """Gaps between the gradients of the four runs of `_bf16_runs` (`g`: run -> name -> gradient), each relative
    to max(the second gradient's norm, CPU_GRAD_FLOOR · the float32 CPU gradients' global norm):
    - per parameter whose float32 CPU gradient is over that floor: (name, the card's bfloat16 gradient to the
      CPU's, the CPU's own bfloat16 error (its bfloat16 gradient to its float32 one), the card's own, and two
      planted faults: the card's float32 gradient to the CPU's bfloat16 one, 1.25 × the card's bfloat16 gradient
      to the CPU's);
    - the names under the floor, with the card's bfloat16 norm over the floor there;
    - the float32 gradients' largest gap, card to CPU."""
    gnorm = math.sqrt(sum(float((x ** 2).sum()) for x in g["cpu32"].values()))
    floor = CPU_GRAD_FLOOR * gnorm

    def gap(a, b):
        return float((a - b).norm()) / max(float(b.norm()), floor)

    rows, under = [], []
    for n, g32 in g["cpu32"].items():
        if float(g32.norm()) <= floor:
            under.append((n, float(g["card16"][n].norm()) / floor))
            continue
        card, cpu = g["card16"][n], g["cpu16"][n]
        rows.append((n, gap(card, cpu), gap(cpu, g32), gap(card, g["card32"][n]), gap(g["card32"][n], cpu),
                     gap(1.25 * card, cpu)))
    return rows, under, max(gap(g["card32"][n], x) for n, x in g["cpu32"].items())


def _bf16_tolerance(own_cpu):
    """The card's bfloat16 gradient's allowed gap to the CPU's, from the reference's own bfloat16 error alone: the
    CPU tests' rule."""
    return CPU_GRAD_TOL + own_cpu


def _bf16_vs_cpu(name, make, card16, card32, batch):
    """The card's bfloat16 step against the CPU's on one batch (rows cut to CPU_ROWS but in WHOLE_BATCH), from the
    same weights at dropout 0:
    - the bfloat16 knob took effect on the card: its loss is not the float32 one, a forward hook sees bfloat16
      activations, and every gradient stays float32;
    - the loss within CPU_LOSS_TOL of the CPU's;
    - each gradient within `_bf16_tolerance` of the CPU's bfloat16 one: CPU_GRAD_TOL beyond the CPU's own bfloat16
      error for it (its gap to its float32 gradient), relative to max(its norm, CPU_GRAD_FLOOR · the global norm),
      as the CPU tests hold the port to the JAX package.  Where the float32 gradient is under the floor (rounding
      alone), the card's bfloat16 one stays under it;
    - the card's float32 gradients within TRAIN_TOL of the CPU's (the weights and code agree).
    Also logs what two planted faults read under the rule: the card's float32 gradients in place of its
    bfloat16 ones (what the knob check above is for), and each gradient scaled by 1.25 alone."""
    import torch

    t0 = time.perf_counter()
    n_rows = len(batch["label"]) if name in WHOLE_BATCH else CPU_ROWS
    batch = _rows(batch, n_rows)
    runs = _bf16_runs(make, card16, card32)
    seen = set()
    hooks = [m.register_forward_hook(lambda m, i, o: seen.add(o.dtype) if isinstance(o, torch.Tensor) else None)
             for m in card16.model.modules()]
    try:
        res = {k: _grads(t, batch) for k, t in runs.items()}
    finally:
        for h in hooks:
            h.remove()
    losses = {k: v[0] for k, v in res.items()}
    g = {k: v[1] for k, v in res.items()}
    require(torch.bfloat16 in seen and losses["card16"] != losses["card32"],
            f"{name}: the card's bfloat16 step saw activations of {seen} and loss {losses['card16']!r} (float32 "
            f"{losses['card32']!r}): the knob did not take effect")
    require(all(p.grad.dtype == torch.float32 for p in card16.model.parameters()),
            f"{name}: a gradient of the bfloat16 step is not float32")
    rows, under, f32 = _bf16_gaps(g)
    for n, over in under:
        require(over <= 1.0, f"{name}: the card's bfloat16 gradient of {n} is {over:.3e} of the floor where the "
                f"float32 one is under it")
    tol = [_bf16_tolerance(r[2]) for r in rows]
    n, got, own_cpu, own_card, _, _ = max(rows, key=lambda r: r[1] / _bf16_tolerance(r[2]))
    as_f32 = sum(r[4] > t for r, t in zip(rows, tol))  # planted: the card's float32 gradients as its bfloat16 ones
    scaled = sum(r[5] > t for r, t in zip(rows, tol))  # planted: one gradient scaled by 1.25
    rel = abs(losses["card16"] - losses["cpu16"]) / abs(losses["cpu16"])
    log(f"{name} bfloat16, card vs CPU on {n_rows} rows at dropout 0: losses {losses['card16']:.6f} / "
        f"{losses['cpu16']:.6f} (float32 {losses['card32']:.6f} / {losses['cpu32']:.6f}), relative {rel:.3e} "
        f"(tolerance {CPU_LOSS_TOL}); {len(rows)} gradients over the floor, the largest gap / tolerance "
        f"{got / _bf16_tolerance(own_cpu):.3f} at {n} (gap {got:.3e}, the CPU's own bfloat16 error {own_cpu:.3e}, "
        f"the card's {own_card:.3e}); planted faults over the tolerance: "
        f"float32 gradients in place of bfloat16 {as_f32} of {len(rows)} (the knob check catches that), one gradient "
        f"scaled by 1.25 {scaled} of {len(rows)}; activations {sorted(map(str, seen))}; float32 gradients card vs "
        f"CPU {f32:.3e} (tolerance {TRAIN_TOL}); {time.perf_counter() - t0:.1f} s")
    for (n, got, own_cpu, *_), t in zip(rows, tol):
        require(got <= t, f"{name}: the card's bfloat16 gradient of {n} lies {got:.3e} from the CPU's, over {t:.3e} "
                f"(the CPU's own bfloat16 error {own_cpu:.3e})")
    require(rel <= CPU_LOSS_TOL, f"{name}: card vs CPU bfloat16 losses differ by {rel} > {CPU_LOSS_TOL}")
    require(f32 <= TRAIN_TOL, f"{name}: card vs CPU float32 gradients differ by {f32} > {TRAIN_TOL}")


def _precision_config(name, make, other, unit, card, rates):
    """One configuration in bfloat16 on the card (see drive_precision)."""
    import torch

    t0 = time.perf_counter()
    run16 = make("--compute_dtype=bfloat16")
    require(all(p.dtype == torch.float32 for p in run16.model.parameters()), f"{name}: a bfloat16 master weight")
    host = list(run16.make_loader("train"))
    extra = other(run16) if other is not None else []
    # the captured bfloat16 step at the family's dropout: replayed ≡ eager
    timed = _replayed_vs_eager(f"{name} bfloat16", run16, host, card, extra)[0]
    # float32 -> bfloat16: a replayed step's wall (median of 5) and busy times, the rate of a whole epoch's train
    # steps (median of 3 passes)
    run32 = make()
    run32.train_batch(timed)  # its bucket's capture
    row = {}
    for dt, r in (("float32", run32), ("bfloat16", run16)):
        wall, busy = _wall_and_busy(lambda r=r: r.train_batch(timed), f"one replayed {name} {dt} train step", reps=5)
        row[dt] = (wall * 1e3, busy, *_epoch_rates(f"{name} {dt}", r, card, unit, eager=False, passes=3))
    rates[name] = row
    del run32
    # at dropout 0, fresh weights: the card's bfloat16 gradients against the CPU's, then 3 eager steps in
    # bfloat16 against float32
    z16, z32 = make("--compute_dtype=bfloat16", d=True), make(d=True)
    _bf16_vs_cpu(name, make, z16, z32, host[0])
    steps = [b for bucket in _host_buckets([*host, *extra])[:2] for b in bucket[:2]][:3]
    losses = []
    for r in (z32, z16):
        r.train_graphs = False
        losses.append([r.train_batch(b)["Lall"].item() for b in steps])
    rel = max(abs(a - b) / abs(b) for b, a in zip(*losses))
    log(f"{name}: 3 eager steps at dropout 0 from the same weights, losses float32 {losses[0]} vs bfloat16 "
        f"{losses[1]}: worst relative {rel:.3e} (tolerance {BF16_VS_F32_TOL})")
    require(rel <= BF16_VS_F32_TOL, f"{name}: bfloat16 losses differ from float32 by {rel} > {BF16_VS_F32_TOL}")
    (w32, b32, e32, n), (w16, b16, e16, _) = row["float32"], row["bfloat16"]
    log(f"{name} float32 -> bfloat16: replayed step wall (median of 5) {w32:.3f} -> {w16:.3f} ms, busy {b32} -> {b16} "
        f"ms; a whole epoch's {n} train steps replayed (median of 3 passes) {e32:.1f} -> {e16:.1f} {unit}/s on {card}; "
        f"this configuration {time.perf_counter() - t0:.1f} s")
    return run16


def _precision_transfer(card):
    """--transfer_dtype=bfloat16: an epoch of COGMEN's captured step ≡ the float32-transfer epoch on the batches
    rounded to bfloat16 and back, bit for bit in every state tensor; its staged floating bytes half the other's."""
    import torch
    from erc_tpu_torch.core.cuda_graphs import host_tensor

    a, b = _cogmen_trainer("dense", "--transfer_dtype=bfloat16"), _cogmen_trainer("dense")
    b.model.load_state_dict(a.model.state_dict())
    host = list(a.make_loader("train"))
    rounded = [{k: None if v is None else host_tensor(v, torch.bfloat16).float().numpy() if v.dtype.kind == "f" else v
                for k, v in batch.items()} for batch in host]
    for x, y in zip(host, rounded):
        ma, mb = a.train_batch(x), b.train_batch(y)
        require(all(torch.equal(ma[k], mb[k]) for k in ma), f"bfloat16 transfer: the step's metrics differ {ma} {mb}")
    same = all(torch.equal(x, y) for x, y in zip(a._step_tensors(), b._step_tensors()))
    staged = [sum(t.nbytes for t in bk.staging.values() if t.is_floating_point()) for bk in
              (next(iter(r.captured_step._buckets.values())) for r in (a, b))]
    dtypes = {str(t.dtype) for bk in a.captured_step._buckets.values() for t in bk.staging.values()
              if t.is_floating_point()}
    log(f"COGMEN --transfer_dtype=bfloat16: {len(host)} steps replayed ({a.captured_step.replays} replays) ≡ the "
        f"float32 transfer of the rounded batches: {same}; staged floating bytes a batch {staged[0]} vs {staged[1]} "
        f"({dtypes}) on {card}")
    require(same, "the bfloat16-transferred epoch differs from the float32 one on the rounded batches")
    require(2 * staged[0] == staged[1] and dtypes == {"torch.bfloat16"},
            "the bfloat16 staging does not halve the bytes")


def _precision_tf32(card):
    """--matmul_precision=tensorfloat32: a replayed COGMEN step that differs from the strict one and lies within
    TF32_TOL of it, with torch's settings as they were after."""
    import torch

    backends = (torch.backends.cuda.matmul, torch.backends.cudnn.rnn, torch.backends.cudnn.conv)
    before = [x.fp32_precision for x in backends]
    strict, tf32 = _cogmen_trainer("dense", dropout=0.0), _cogmen_trainer("dense", "--matmul_precision=tensorfloat32",
                                                                          dropout=0.0)
    tf32.model.load_state_dict(strict.model.state_dict())
    batch = next(iter(strict.make_loader("train")))
    mets = []
    for t in (strict, tf32):
        t.train_batch(batch)  # eager, then captured
        snap = _snapshot(t)
        mets.append(t.train_batch(batch))  # a replay
        _restore(t, snap)
    ls, lt = mets[0]["Lall"].item(), mets[1]["Lall"].item()
    gs, gt = mets[0]["gnorm"].item(), mets[1]["gnorm"].item()
    rel = max(abs(lt - ls) / abs(ls), abs(gt - gs) / abs(gs))
    after = [x.fp32_precision for x in backends]
    log(f"COGMEN --matmul_precision=tensorfloat32, a replayed step: loss {lt!r} vs strict {ls!r}, gnorm {gt!r} vs "
        f"{gs!r}: relative {rel:.3e} (tolerance {TF32_TOL}); fp32_precision before {before}, after {after}")
    require(0 < rel <= TF32_TOL, f"the TF32 step lies {rel} from the strict one: want (0, {TF32_TOL}]")
    require(after == before, f"the trainer's matmul precision leaked: {before} -> {after}")


REFUSED = [("COGMEN banded", lambda: _cogmen_trainer("banded", "--compute_dtype=bfloat16")),
           ("COGMEN auto at L 300", lambda: _cogmen_trainer("auto", "--compute_dtype=bfloat16", "--max_seq_len=300")),
           ("DialogueGCN banded", lambda: _dgcn_trainer("banded", "--compute_dtype=bfloat16")),
           ("DAG-ERC kernel form", lambda: _trainer("--compute_dtype=bfloat16")),
           ("DialogueGCN v2 DialogueRNN", lambda: _dgcnv2_trainer(False, "--compute_dtype=bfloat16")),
           ("--matmul_precision=bfloat16", lambda: _cogmen_trainer("dense", "--matmul_precision=bfloat16"))]


def drive_precision(card: str):
    """The precision knobs on the card.  Every family that trains in bfloat16 at the width of its earlier phase
    (`_precision_configs`): its bfloat16 step against the CPU port's by the CPU tests' rule, 3 steps bfloat16 vs
    float32 within BF16_VS_F32_TOL at dropout 0, the captured bfloat16 step ≡ the eager one over two buckets, and
    float32 -> bfloat16 replayed step wall and busy times and epoch rate (information).  Then the bfloat16
    transfer, a TF32 step, the refusals on the card, and K3 in the float32 test stage of a bfloat16-trained
    DAG-ERC, its count held against a device trace."""
    from erc_tpu_torch.ops.kernels import dag_block as kd

    t0 = time.perf_counter()
    rates = {}
    for name, make, other, unit in _precision_configs():
        run = _precision_config(name, make, other, unit, card, rates)
        if name == "DAG-ERC eager form":
            run.test()  # the test stage's buckets captured
            before = kd.launches["dag_block"]
            res, traced = _traced("bfloat16-trained DAG-ERC test stage replayed", run.test)
            moved = kd.launches["dag_block"] - before
            log(f"DAG-ERC trained in bfloat16: test stage in float32 through K3, {moved} launches (traced "
                f"{traced.get('dag_block', 0)}), loss {res['Lall']:.5f}, F1 {res['f1']:.5f}")
            require(moved > 0 and traced.get("dag_block") == moved and math.isfinite(res["Lall"]),
                    f"K3 ran {moved} times ({traced}) in the bfloat16-trained DAG-ERC's test stage")
        del run
    _precision_transfer(card)
    _precision_tf32(card)
    for what, build in REFUSED:
        try:
            build()
        except ValueError as e:
            log(f"refused on the card: {what}: {str(e)[:160]}")
        else:
            require(False, f"{what} built a trainer in bfloat16")
    log("float32 -> bfloat16 on " + card + ": " + json.dumps(rates))
    log(f"precision phase: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ the pipeline phase
PIPELINE_K = 4
# a Cos schedule long enough that each of the phase's steps reads another LR
PIPELINE_SCHE = ["--optim.sche.name=Cos", "--optim.sche.start=0.0001", "--optim.sche.end=0.00001",
                 "--optim.sche.left=0", "--optim.sche.right=200"]
PIPELINE_LR_TOL = 1e-6  # the LR read back against the host curve, relative
PIPELINE_RATE_BATCHES = 16  # batches an epoch in the K = 1 / K = 4 and prefetch rates


def _one_bucket_group(host, k):
    """`k` host batches of one shape bucket: the largest bucket's, cycled where it holds fewer."""
    bucket = max(_host_buckets(host), key=len)
    return [bucket[i % len(bucket)] for i in range(k)]


def _moved(before: dict) -> dict:
    """The launch counts that moved since `before` (_all_launches())."""
    return {k: n - before[k] for k, n in _all_launches().items() if n != before[k]}


def _state_after(run, mets: list) -> dict:
    """Each step's metrics (a list of {name: 0-d tensor}), every tensor the captured step reads or writes, and the
    dropout generator's state: what a K-step replay is held to."""
    out = {f"step {i} {k}": v.detach().clone() for i, m in enumerate(mets) for k, v in m.items()}
    out.update(zip(_state_names(run), (t.detach().clone() for t in run._step_tensors())))
    out["dropout generator state"] = run._dropout_rng.get_state()
    return out


def _k_replay_vs_eager(name, run, host, card, k=PIPELINE_K, curve=None):
    """`k` train steps replayed as one graph (`CapturedStep.group` on a stacked group of `k` batches of one bucket)
    ≡ `k` eager steps from the same state, bit for bit in each step's losses and gnorm, the parameters, gradients,
    buffers, optimizer state, LR and schedule count, the generator state and MMIN's EMA (where they differ, a second
    eager run decides, `_compare_steps`); the replay's launch counts are `k` x one eager step's and equal a device
    trace's; one capture for the group's (k, bucket) and a leftover batch of the bucket through the single-step
    graph.  With `curve` (the host curve of a declared schedule) each eager step's LR and the LR after the replay
    are held against it.  Returns the stacked group."""
    import torch
    from erc_tpu_torch.core.cuda_graphs import CapturedStep, host_array
    from erc_tpu_torch.data.loader import StackedGroup, to_device

    t0 = time.perf_counter()
    group = _one_bucket_group(host, k)
    stacked = StackedGroup(group)  # as GroupedLoader yields it
    graphs = run.captured_step
    captures = graphs.captures
    run.train_group(stacked, k)  # the bucket's first group: k eager steps, then the capture
    require(graphs.captures == captures + 1, f"{name}: {graphs.captures - captures} captures for a new group")
    snap = _snapshot(run)
    count0 = int(run.optimizer.state["schedule"]["count"]) if "schedule" in run.optimizer.state else None

    def eager():
        mets, lrs, counts = [], [], []
        for b in group:
            before = _all_launches()
            mets.append(run.train_step(to_device(b, run.device, run.transfer_dtype)))
            counts.append(_moved(before))
            lrs.append(float(run.optimizer.param_groups[0]["lr"]))
        out = _state_after(run, mets)
        _restore(run, snap)
        return out, lrs, counts

    ea, lrs, counts = eager()
    before, replays = _all_launches(), graphs.replays
    per_step, traced = _traced(f"{name} {k}-step replay", lambda: graphs.group(stacked, k))
    moved = _moved(before)
    require(graphs.replays == replays + 1 and graphs.captures == captures + 1,
            f"{name}: the replay made {graphs.replays - replays} replays and {graphs.captures - captures} captures")
    replayed = _state_after(run, [{n: v[i] for n, v in per_step.items()} for i in range(k)])
    lr_after = float(run.optimizer.param_groups[0]["lr"])
    _restore(run, snap)
    same = ea.keys() == replayed.keys() and all(torch.equal(replayed[q], v) for q, v in ea.items())
    eb = ea if same else eager()[0]
    spread, ee, re_ = _compare_steps(f"{name} K = {k}", ea, eb, replayed)
    one = counts[0]
    require(all(c == one for c in counts), f"{name}: eager steps launched {counts}")
    require(moved == {q: k * n for q, n in one.items()},
            f"{name}: a {k}-step replay counted {moved}, one eager step {one}")
    if curve is not None:
        want = [curve(count0 + i) for i in range(k)]
        worst = max(abs(a - b) / abs(b) for a, b in zip([*lrs, lr_after], [*want, want[-1]]))
        log(f"{name}: LR of steps {count0}..{count0 + k - 1} read back {lrs}, after the replay {lr_after}; host "
            f"curve {want}; worst relative {worst:.3e} (tolerance {PIPELINE_LR_TOL})")
        require(worst <= PIPELINE_LR_TOL, f"{name}: the scheduled LR is {worst:.3e} off the host curve")
    # a leftover batch of the bucket: the single-step graph, captured once, then replayed
    def key(batch):
        return CapturedStep._bucket_key({q: host_array(v) for q, v in batch.items() if v is not None})

    for _ in range(2):
        run.train_batch(group[0])
    require((0, key(group[0])) in graphs._buckets and (k, key(dict(stacked))) in graphs._buckets
            and graphs.captures == captures + 2,
            f"{name}: graphs {sorted(kk for kk, _ in graphs._buckets)} after a group and two leftovers")
    verdict = "bit for bit" if not spread else f"within the eager spread ({ee:.3e}; replayed {re_:.3e})"
    log(f"{name} K = {k}: one replay ≡ {k} eager steps {verdict} in {len(ea)} quantities (losses, gnorm, parameters, "
        f"gradients, buffers, optimizer state, LR{', schedule count' if count0 is not None else ''}, generator"
        f"{', EMA shadow' if getattr(run, 'ema_model', None) is not None else ''}); launches a replay {moved} = "
        f"{k} x one step's {one}, traced {traced}; graphs (k, bucket) {sorted(kk for kk, _ in graphs._buckets)}; "
        f"on {card}; {time.perf_counter() - t0:.1f} s")
    return stacked


def _k_eval_vs_single(name, run, card, k=PIPELINE_K, batch_size=4):
    """The test stage at --eval_steps_per_call=k (one replay a group of k batches), in batches of `batch_size` of one
    shape (length_bucket 0) so that groups form, ≡ the stage at K = 1: the same predictions, NLL and record, bit for
    bit; its launch counts equal."""
    p = run.params
    saved = p.test.batch_size, p.get("length_bucket", 16)
    p.test.batch_size, p.length_bucket = batch_size, 0  # one shape: every run of k batches a group
    out = {}
    for label, kk in (("K = 1", 0), (f"K = {k}", k)):
        p.eval_steps_per_call, run._test_loader = kk, None
        run.test()  # every bucket captured
        before = _all_launches()
        res = run.test()
        out[label] = (res, list(run._true), list(run._pred), run._nll_sum, _moved(before))
    p.eval_steps_per_call, run._test_loader, (p.test.batch_size, p.length_bucket) = 0, None, saved
    (r1, t1, p1, n1, c1), (rk, tk, pk, nk, ck) = out.values()
    require(t1 == tk and p1 == pk and n1 == nk and _same_record(r1, rk) and c1 == ck,
            f"{name}: the test stage at eval_steps_per_call={k} differs from K = 1 (launches {c1} / {ck})")
    groups = sum(1 for key in run.captured._buckets if key[0] == k)
    require(groups > 0, f"{name}: no {k}-batch eval graph captured")
    log(f"{name} test stage at eval_steps_per_call={k} ≡ K = 1 bit for bit ({len(t1)} utterances, loss "
        f"{r1['Lall']:.6f}, launches {ck}); {groups} {k}-batch eval graphs on {card}")


def _pipeline_rates(name, run, card, unit="dialogues", settings=((1, True), (4, True), (1, False), (4, False)),
                    batches=PIPELINE_RATE_BATCHES, cycles=3):
    """An epoch's train steps (`batches` batches of one shape, no val or test stage) at each (K, prefetch) of
    `settings`, replayed: `cycles` rounds over the settings in turn (a pass that had to capture a graph is run again),
    the median `unit`/s of each setting; and the wall and busy of a replayed step at K = 1 against a 4-step replay's
    per step.  Returns {setting: rate} with the walls and busy times."""
    from erc_tpu_torch.data.loader import StackedGroup

    t0 = time.perf_counter()
    p = run.params
    saved = {"eval_per_epoch": p.get("eval_per_epoch", 1), "batch_count": p.get("batch_count"),
             "length_bucket": p.get("length_bucket", 16), "steps_per_call": p.get("steps_per_call", 1),
             "prefetch": p.get("prefetch", True)}
    p.eval_per_epoch, p.batch_count, p.length_bucket = 0, batches, 0
    passes: dict = {}
    try:
        for _ in range(cycles):
            for k, prefetch in settings:
                p.steps_per_call, p.prefetch = k, prefetch
                captures = -1
                while captures != run.captured_step.captures:  # again where the pass had to capture
                    captures = run.captured_step.captures
                    run.eidx, p.epoch = run.eidx + 1, run.eidx + 2
                    rec = run.train()[-1]
                passes.setdefault(f"K={k} prefetch {'on' if prefetch else 'off'}", []).append(
                    rec["dialogues"] / rec["seconds"])
        host = list(run.make_loader("train"))
        batch = host[0]
        stacked = StackedGroup([host[i % len(host)] for i in range(PIPELINE_K)])
        run.train_batch(batch)
        run.train_group(stacked, PIPELINE_K)  # both captured before the timings
        shape = tuple(batch["attention_mask" if "attention_mask" in batch else "sample_mask"].shape)
        w1, b1 = _wall_and_busy(lambda: run.train_batch(batch), f"{name} replayed step {shape}", reps=5)
        wk, bk = _wall_and_busy(lambda: run.train_group(stacked, PIPELINE_K),
                                f"{name} {PIPELINE_K}-step replay {shape}", reps=5)
    finally:
        for q, v in saved.items():
            p[q] = v
    rates = {q: round(statistics.median(v), 1) for q, v in passes.items()}
    per = lambda x: None if x is None else round(x / PIPELINE_K, 3)  # noqa: E731
    share = lambda b, w: "not measured" if b is None else f"{100 * b / (w * 1e3):.1f}%"  # noqa: E731
    log(f"{name} ({shape}): a replayed step K = 1 wall {w1 * 1e3:.3f} ms, busy {b1} ms ({share(b1, w1)}); K = "
        f"{PIPELINE_K} per step wall {wk * 1e3 / PIPELINE_K:.3f} ms, busy {per(bk)} ms ({share(bk, wk)}); an epoch of "
        f"{batches} batches, {unit}/s, medians of {cycles} passes: {rates} (each pass "
        f"{ {q: [round(x, 1) for x in v] for q, v in passes.items()} }) on {card}; {time.perf_counter() - t0:.1f} s")
    return {"wall_ms": [round(w1 * 1e3, 3), round(wk * 1e3 / PIPELINE_K, 3)], "busy_ms": [b1, per(bk)], **rates}


def _native_batching(card):
    """Host batching of a 64-dialogue COGMEN predict, native packer against numpy (`ERCBatcher(native=False)`):
    every batch bit for bit, the predict's results equal, and the host clock split of each."""
    import numpy as np
    from erc_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine.from_module("cogmen", graph_impl="banded", dataset="synthetic-cogmen-6",
                                         encoder_mode="chained", batch_size=32)
    dialogues, desc = _dialogues()
    results = engine.predict(dialogues)
    bs = engine.batch_size
    for s in range(0, len(dialogues), bs):
        engine.batcher.native = True
        a = engine.batcher(dialogues[s : s + bs])
        engine.batcher.native = False
        b = engine.batcher(dialogues[s : s + bs])
        require(a.keys() == b.keys() and all((a[q] is None and b[q] is None) or (
            a[q].dtype == b[q].dtype and np.array_equal(a[q], b[q])) for q in a),
            "the native packer's batch differs from the numpy one")
    plain = engine.predict(dialogues)
    require(all(np.array_equal(x["probs"], y["probs"]) for x, y in zip(results, plain)),
            "a predict of numpy-packed batches differs from the native-packed one")
    def median_ms(fn):
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            for s in range(0, len(dialogues), bs):
                fn(dialogues[s : s + bs])
            t.append(time.perf_counter() - t0)
        return round(statistics.median(t) * 1e3, 3)

    timings = {}
    for label, native in (("native", True), ("numpy", False)):
        engine.batcher.native = native
        timings[label] = median_ms(engine.batcher)
        _host_breakdown(f"COGMEN replayed, {label} packing", engine, dialogues)
    engine.batcher.native = True
    # the text features alone, packed on the batcher's one thread and on the JAX package's 4
    from erc_tpu_torch.data import native

    def text_rows(threads):
        def pack(chunk):
            rows = [np.asarray(d["text"], np.float32) for d in chunk]
            lens = np.array([len(r) for r in rows], np.int32)
            return native.pack_rows(rows, lens, int(lens.max()), rows[0].shape[-1], n_threads=threads)
        return pack

    for threads in (1, 4):
        timings[f"text features alone, native on {threads} thread{'s' if threads > 1 else ''}"] = median_ms(
            text_rows(threads))
    log(f"host batching of a predict of {desc}, medians of 5, ms: {timings}; batches bit for bit, predictions equal; "
        f"on {card}")
    return timings


def drive_pipeline(card: str):
    """The rest of the train loop on the card: K = 4 train steps a replay ≡ 4 eager steps (COGMEN banded: K1/K2/K1ᵀ;
    DAG-ERC's kernel form: K3/K4; mmin_miss; COGMEN dense in bfloat16; lars under a Cos schedule, its LR read back
    against the host curve; AdamW with split_wd=1), launches 4 x a step's against a device trace, one capture a (K,
    bucket) and a leftover batch through the single-step graph; eval_steps_per_call=4 ≡ K = 1 (COGMEN banded,
    DAG-ERC kernel form, mmin_miss's raw and EMA logits); the native packer ≡ numpy; and, for information, replayed
    step wall and busy and epoch rates at K = 1 against K = 4 with prefetch on and off, and host batching native
    against numpy."""
    from erc_tpu_torch.core.interp import Cos

    t0 = time.perf_counter()
    rates = {}
    run = _cogmen_trainer("banded", f"--steps_per_call={PIPELINE_K}")
    host = list(run.make_loader("train"))
    _k_replay_vs_eager("COGMEN banded", run, host, card)
    _k_eval_vs_single("COGMEN banded", run, card)
    rates["COGMEN banded"] = _pipeline_rates("COGMEN banded", run, card)
    del run
    run = _trainer(f"--steps_per_call={PIPELINE_K}")
    host = list(run.make_loader("train"))
    _k_replay_vs_eager("DAG-ERC kernel form", run, host, card)
    _k_eval_vs_single("DAG-ERC kernel form", run, card)
    rates["DAG-ERC kernel form"] = _pipeline_rates("DAG-ERC kernel form", run, card)
    del run
    run = _mmin_trainer("mmin_miss", f"--steps_per_call={PIPELINE_K}")
    host = list(run.make_loader("train"))
    _k_replay_vs_eager("mmin_miss", run, host, card)
    _k_eval_vs_single("mmin_miss", run, card, batch_size=8)
    rates["mmin_miss"] = _pipeline_rates("mmin_miss", run, card, unit="utterances")
    del run
    run = _cogmen_trainer("dense", "--compute_dtype=bfloat16")
    _k_replay_vs_eager("COGMEN dense bfloat16", run, list(run.make_loader("train")), card)
    del run
    run = _cogmen_trainer("dense", "--optim.name=lars", *PIPELINE_SCHE)
    curve = Cos(0.0001, 0.00001, 0, 200)
    _k_replay_vs_eager("COGMEN dense lars, Cos schedule", run, list(run.make_loader("train")), card, curve=curve)
    del run
    run = _cogmen_trainer("dense", "--optim.name=AdamW", "--optim.weight_decay=0.01", "--optim.split_wd=1")
    require(len(run.optimizer.param_groups) == 2, "split_wd=1 built one parameter group")
    _k_replay_vs_eager("COGMEN dense AdamW split_wd=1", run, list(run.make_loader("train")), card)
    del run
    run = _dgcnv2_trainer(False)  # its step is 97 % busy at K = 1: the replayed step's walls alone
    rates["DialogueGCN v2 DialogueRNN"] = _pipeline_rates("DialogueGCN v2 DialogueRNN", run, card, settings=())
    del run
    rates["host batching ms"] = _native_batching(card)
    log("pipeline rates on " + card + ": " + json.dumps(rates))
    log(f"pipeline phase: {time.perf_counter() - t0:.1f} s")


COGMEN_TRAIN_PARAMS = 10_117_874
RUNTIME_K = 4
RUNTIME_PER_STEP = 6  # --checkpoint_per_step: a threshold that K = 4 calls cross every other call
# one length bucket (L 96), so that each epoch's 8 batches form two K = 4 groups
RUNTIME_ARGS = ["--graph_impl=banded", "--epoch=2", "--batch_count=8", "--length_bucket=96",
                f"--steps_per_call={RUNTIME_K}"]
RUNTIME_KNOBS = [f"--checkpoint_per_step={RUNTIME_PER_STEP}", "--profile_steps=4", "--nan_guard=true",
                 "--eval_first=true", "--tensorboard=true"]
# the files of a run of the JAX layout (tests/test_torch_runtime.py holds them against the JAX package's), and
# those that this phase's knobs add; log.<stamp>.0.txt and blob/board's TensorBoard event file besides
RUNTIME_FILES = {"experiment/params.yaml", "experiment/initial.json", "experiment/final.json",
                 "experiment/report.json", "experiment/rerun.sh", "experiment/metrics.json",
                 "experiment/board.jsonl", "blob/predictions.jsonl", "blob/saver/model.best.ckpt",
                 "blob/saver/model.best.ckpt.json", "blob/saver/best.model.ckpt"}
RUNTIME_KNOB_FILES = {"experiment/heartbeat.json", "experiment/.hb", "blob/saver/model.last.ckpt",
                      "blob/saver/model.last.ckpt.json", "blob/profile/trace.pt.trace.json"}


@contextlib.contextmanager
def _stub_server():
    """A stub HTTP server on 127.0.0.1 that keeps the JSON bodies POSTed to it: (its URL, the list)."""
    import http.server

    posts: list = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            posts.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/", posts
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


class _Window:
    """The phase's own callback: each call's global step, the launch counts at train_begin (after EvalFirst) and
    when --profile_steps' window closes, and each epoch's device memory through MemoryMonitor's log."""

    def __init__(self, profile_steps: int):
        from erc_tpu_torch.train import callbacks as cbs

        self.priority = 120  # after EvalFirst (110): the window opens after train_begin
        self.profile_steps, self.calls, self.before, self.after, self.memory = profile_steps, [], None, None, []
        self.monitor = cbs.MemoryMonitor()

    def hook(self, trainer):
        trainer.callbacks.append(self)
        trainer.callbacks.sort(key=lambda c: getattr(c, "priority", 100))
        return self

    def train_begin(self, tr):
        self.before = _all_launches()

    def train_step_end(self, tr, bidx, mets):
        self.calls.append(tr.global_steps)
        if self.after is None and tr.global_steps >= self.profile_steps:
            self.after = _all_launches()

    def train_epoch_end(self, tr, eidx, record):
        log_fn = tr.log
        tr.log = lambda msg: (self.memory.append(msg), log_fn(msg))
        try:
            self.monitor.train_epoch_end(tr, eidx, record)
        finally:
            tr.log = log_fn


def _run_files(root: Path, trainer) -> set:
    """A run's files, relative to its experiment and blob directories (the log's stamp as <stamp>)."""
    out = set()
    for kind, base in (("experiment", Path(trainer.exp.test_dir)), ("blob", Path(trainer.exp.blob_dir))):
        for f in base.rglob("*"):
            if f.is_file():
                out.add(f"{kind}/" + re.sub(r"log\.\d{6}-\d{6}\.", "log.<stamp>.", str(f.relative_to(base))))
    return out


def _cogmen_main(argv, window=None):
    """COGMEN's entry point (`models.cogmen.main`) with `window` hooked beside the knobs' callbacks."""
    from erc_tpu_torch.models import cogmen

    icallbacks = cogmen.COGMENTrainer.icallbacks

    def with_window(self, params):
        icallbacks(self, params)
        if window is not None:
            window.hook(self)

    cogmen.COGMENTrainer.icallbacks = with_window
    try:
        return cogmen.main([*COGMEN_TRAIN_ARGS, *argv])
    finally:
        cogmen.COGMENTrainer.icallbacks = icallbacks


def _board(trainer, stage):
    return [r for r in map(json.loads, open(trainer.exp.test_file("board.jsonl"))) if r["stage"] == stage]


def _expected_step_checkpoints(calls, per_step):
    """The steps at which GlobalStepCheckpoint saves, given each call's global step (a threshold, not a multiple)."""
    last, out = 0, []
    for g in calls:
        if g - last >= per_step:
            last = g
            out.append(g)
    return out


def _runtime_cogmen(card, url, posts, root):
    """Phase 1: COGMEN banded at full width through its entry point with the runtime's knobs on, then off."""
    import torch

    from erc_tpu_torch.core import memstat

    window = _Window(4)
    _reset_launches()
    on = _cogmen_main([*RUNTIME_ARGS, *RUNTIME_KNOBS, f"--remote_url={url}"], window)
    n_params = sum(t.numel() for t in on.model.parameters())
    require(n_params == COGMEN_TRAIN_PARAMS, f"COGMEN has {n_params} parameters, not {COGMEN_TRAIN_PARAMS}")
    files = _run_files(root, on)
    log(f"runtime: run {on.exp.exp_name}/{on.exp.test_name}: {sorted(files)}")
    missing = (RUNTIME_FILES | RUNTIME_KNOB_FILES) - files
    require(not missing, f"runtime: the run lacks {sorted(missing)}")
    require(any(re.fullmatch(r"experiment/log\.<stamp>\.0\.txt", f) for f in files), "runtime: no log file")
    require(any(re.fullmatch(r"blob/board/events\.out\.tfevents\..+", f) for f in files),
            "runtime: no TensorBoard event file under blob/board")
    # step checkpoints at the thresholds of this run's calls
    steps = [int(re.search(r"checkpoint\.(\d+)\.ckpt$", f).group(1)) for f in files
             if re.fullmatch(r"blob/saver/checkpoint\.\d+\.ckpt", f)]
    want = _expected_step_checkpoints(window.calls, RUNTIME_PER_STEP)[-3:]  # the saver keeps 3
    require(sorted(steps) == want and want, f"runtime: step checkpoints at {sorted(steps)}, the calls {window.calls} "
            f"give {want}")
    for step in want:
        meta = json.loads(Path(on.saver.save_dir, f"checkpoint.{step:08d}.ckpt.json").read_text())
        require(meta["epoch_end"] is False and meta["params_hash"] == on.params.resume_hash(),
                f"runtime: checkpoint {step}'s meta {meta}")
    require(any(b - a == RUNTIME_K for a, b in zip([0, *window.calls], window.calls)),
            f"runtime: no call of {RUNTIME_K} steps in {window.calls}")
    # the exporter: a train POST an epoch, a test POST a test stage (EvalFirst's first)
    got = [(p["stage"], p["epoch"]) for p in posts]
    require(got == [("test", 0), ("train", 0), ("test", 0), ("train", 1), ("test", 1)], f"runtime: POSTs {got}")
    # the profile: K1/K2/K1ᵀ in the Chrome trace as the launch counts moved over the profiled steps
    trace = json.loads(Path(on.exp.blob_dir, "profile", "trace.pt.trace.json").read_text())
    names = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    require(window.after is not None, "runtime: the profiled window never closed")
    traced = _trace_check("runtime: --profile_steps=4 trace", window.before, names, window.after)
    require(all(traced.get(k, 0) > 0 for k in ("banded_gather_sum", "banded_dot", "banded_gather_sum_t")),
            f"runtime: the profile lacks a band kernel: {traced}")
    log(f"runtime: profile window {trace.get('erc_tpu_torch.window')}, {len(names)} kernels, band kernels {traced}")
    # MemoryMonitor's lines: in use and peak positive and below the card's memory
    total = torch.cuda.get_device_properties(0).total_memory
    require(len(window.memory) == 2, f"runtime: MemoryMonitor logged {window.memory}")
    for line in window.memory:
        in_use, peak = (float(x) * 2 ** 20 for x in re.findall(r"(?:in_use|peak)=(\d+)MiB", line))
        require(0 < in_use <= peak < total, f"runtime: MemoryMonitor {line!r} against {total} bytes")
    require(memstat.device_memory_stats() is not None, "runtime: device_memory_stats() gave None on the card")
    # the same run with every callback off: the same losses, test F1 and parameters, bit for bit
    off = _cogmen_main(RUNTIME_ARGS)
    on_train, off_train = _board(on, "train"), _board(off, "train")
    on_test, off_test = _board(on, "test")[1:], _board(off, "test")  # the first is EvalFirst's
    require(len(on_train) == len(off_train) == 2,
            f"runtime: {len(on_train)} train rows on, {len(off_train)} off, not 2 and 2")
    for a, b in zip(on_train, off_train):
        require(all(a[k] == b[k] for k in ("Lall", "Acc", "gnorm")), f"runtime: train rows on {a} off {b}")
    require(len(on_test) == len(off_test) == 2 and all(a["f1"] == b["f1"] for a, b in zip(on_test, off_test)),
            f"runtime: test F1 on {[r['f1'] for r in on_test]} off {[r['f1'] for r in off_test]}")
    for (n, a), b in zip(on.model.state_dict().items(), off.model.state_dict().values()):
        require(torch.equal(a, b), f"runtime: {n} differs with the callbacks on")
    rates = {"on": [r["dps"] for r in on_train], "off": [r["dps"] for r in off_train]}
    log(f"runtime: callbacks on ≡ off bit for bit (losses, test F1, {len(on.model.state_dict())} tensors); epoch "
        f"rates dia/s, epoch 0 (profiled, EvalFirst before it) and 1: on {rates['on']} off {rates['off']}; on {card}")
    return rates


def _runtime_dagerc(card):
    """Phase 2: DAG-ERC's kernel form at full width, --profile_steps=2: K3 and K4 in the trace at 8 and 4
    launches a 16-position block a step."""
    window = _Window(2)
    run = _trainer("--profile_steps=2", "--batch_count=3", "--eval_per_epoch=0")
    window.hook(run)
    loader = run.make_loader("train")
    loader.set_epoch(0)
    blocks = [_blocks(b, 16) for b in list(loader)[:2]]
    run.train()
    trace = json.loads(Path(run.exp.blob_dir, "profile", "trace.pt.trace.json").read_text())
    names = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    traced = _trace_check("runtime: DAG-ERC --profile_steps=2 trace", window.before, names, window.after)
    want = {"dag_block": 8 * sum(blocks), "dag_block_bwd": 4 * sum(blocks)}
    require(all(traced.get(k) == n for k, n in want.items()), f"runtime: DAG-ERC trace {traced}, want {want}")
    log(f"runtime: DAG-ERC profile of 2 steps ({blocks} blocks): {traced}; on {card}")


class _Poison:
    """Sets one parameter to NaN in place after the first call (before NaNGuard looks), so the graphs read it."""

    priority = 50

    def __init__(self):
        self.at = None

    def train_step_end(self, tr, bidx, mets):
        import torch

        if self.at is None:
            self.at = tr.global_steps
            with torch.no_grad():
                next(tr.model.parameters()).fill_(float("nan"))


def _runtime_nan(card):
    """Phase 3: NaNGuard over replayed K = 4 groups, and --debug_nans eagerly, on the card."""
    import torch

    from erc_tpu_torch.data.loader import to_device

    run = _cogmen_trainer("banded", f"--steps_per_call={RUNTIME_K}", "--batch_count=16", "--length_bucket=96",
                          "--nan_guard=true", "--eval_per_epoch=0")
    poison = _Poison()
    run.callbacks.append(poison)
    try:
        run.train()
        require(False, "runtime: NaNGuard did not raise")
    except FloatingPointError as e:
        log(f"runtime: NaNGuard raised {e!r} (NaN set after step {poison.at}, {run._captured_step.replays} replays)")
        step = run.global_steps
        require(step >= 10 and step - RUNTIME_K < 10 and run._captured_step.replays > 0,
                f"runtime: NaNGuard at step {step}, replays {run._captured_step.replays}")
    path = run.saver.latest_checkpoint()
    meta = json.loads(Path(path + ".json").read_text())
    require(meta["global_steps"] == step and meta["epoch_end"] is False, f"runtime: NaNGuard's checkpoint {meta}")
    del run
    run = _cogmen_trainer("banded", "--debug_nans=true")
    require(not run.train_graphs, "runtime: --debug_nans kept the captured step")
    batch = to_device(next(iter(run.make_loader("train"))), run.device)
    batch["input_tensor"][0, 1, 3] = float("nan")
    try:
        run.train_step(batch)
        require(False, "runtime: --debug_nans did not raise")
    except FloatingPointError as e:
        require("module '" in str(e), f"runtime: --debug_nans raised {e!r} without a module")
        log(f"runtime: --debug_nans raised {e!r}; on {card}")
    torch.cuda.synchronize()


def _runtime_info(card):
    """Phase 4, information: FLOPs of COGMEN's dense step (card ≡ CPU, a hard check) over its replayed busy time,
    cli mem and cli warm."""
    from erc_tpu_torch import cli
    from erc_tpu_torch.core import flops, memstat
    from erc_tpu_torch.data.loader import to_device

    dense = _cogmen_trainer("dense")
    cpu = _cogmen_trainer("dense", device="cpu")
    cpu.model.load_state_dict(dense.model.state_dict())
    host = next(iter(dense.make_loader("train")))
    on_card = flops.step_flops(dense.compute_grads, to_device(host, dense.device))
    on_cpu = flops.step_flops(cpu.compute_grads, to_device(host, cpu.device))
    require(on_card == on_cpu, f"runtime: step_flops on the card {on_card}, on the CPU {on_cpu}")
    for _ in range(3):  # the bucket's eager step and its capture, then replays
        dense.train_batch(host)
    wall, busy = _wall_and_busy(lambda: dense.train_batch(host), "runtime: replayed COGMEN dense step")
    shape = tuple(host["input_tensor"].shape)
    rate = on_card["flops"] / (busy / 1e3) if busy else None
    rate_text = (f"{rate:.6g} FLOP/s ({100 * rate / PEAK_F32_FLOP_PER_S:.2f} % of the float32 peak)" if rate
                 else "FLOP/s not measured (no busy time)")
    log(f"runtime: COGMEN dense step {shape}: {on_card['flops']:.6g} FLOPs (card ≡ CPU), replayed busy {busy} ms, "
        f"{rate_text}; on {card}")
    del dense, cpu
    log(f"runtime: cli mem on {card}:\n" + memstat.memory_report())
    t0 = time.perf_counter()
    warmed = cli.warm("cogmen", "synthetic-cogmen-6", 32, 96)
    log(f"runtime: cli warm cogmen 32 96: {warmed}, {time.perf_counter() - t0:.3f} s; on {card}")
    return {"flops": on_card["flops"], "busy_ms": busy, "flop_per_s": rate, "warm": warmed}


def drive_runtime(card: str):
    """The runtime around the train loop (callbacks, experiment directories, metric store, exporters,
    --profile_steps, NaNGuard and --debug_nans, memory and FLOP counters, the CLI) on the card, in a fresh
    experiment root."""
    import os
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="runtime_"))
    before = os.environ["ERC_TPU_EXPROOT"]  # the script's root (_experiment_root)
    os.environ["ERC_TPU_EXPROOT"] = str(root)
    try:
        with _stub_server() as (url, posts):
            rates = _runtime_cogmen(card, url, posts, root)
        _runtime_dagerc(card)
        _runtime_nan(card)
        info = _runtime_info(card)
    finally:
        os.environ["ERC_TPU_EXPROOT"] = before
        shutil.rmtree(root, ignore_errors=True)
    log("runtime on " + card + ": " + json.dumps({"epoch_rates": rates, **info}, default=str))
    log(f"runtime phase: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ phase 20
DDP_LOSS_RTOL, DDP_LOSS_ATOL = 2e-5, 2e-6  # tests/test_multiprocess.py's: ranks against one process
DDP_RANK_RTOL = 1e-6  # the ranks against each other
DDP_STEPS = 3
DDP_TIMEOUT = 300  # seconds for the two ranks' processes
DDP_RANK_DEVICE = "cuda:0"  # both ranks on the one card: gloo
DDP_TIMING_ROUNDS = 15


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _steps_and_state(run, host) -> dict:
    """`run.train_batch` of each host batch, then two groups of 2 of them through `run.train_group` (the first
    group trained as 2 eager steps and captured, the second one 2-step replay); every step's (and group's)
    metrics and every tensor the step reads or writes, copied."""
    import torch
    from erc_tpu_torch.data.loader import StackedGroup

    mets = [run.train_batch(b) for b in host]
    mets += [run.train_group(StackedGroup(host[i: i + 2]), 2) for i in (0, 2)]
    torch.cuda.synchronize()
    out = {f"step {i} {k}": v.detach().clone() for i, m in enumerate(mets) for k, v in m.items()}
    out.update(zip(_state_names(run), (t.detach().clone() for t in run._step_tensors())))
    return out


def _ddp_step_times(run, batch, name: str) -> tuple:
    """(information) A replayed step's wall (median of DDP_TIMING_ROUNDS) and busy ms."""
    walls = [_step_time(lambda: run.train_batch(batch)) for _ in range(DDP_TIMING_ROUNDS)]
    wall = statistics.median(walls)
    return wall * 1e3, _profile(lambda: run.train_batch(batch), f"ddp: COGMEN banded replayed step, {name}", wall)


def _ddp_check_graphs(run, name: str) -> None:
    """One capture of the step and one of the group, and DDP_STEPS + 1 replays, after `_steps_and_state`."""
    graphs = run._captured_step
    require(graphs.captures == 2 and graphs.replays == DDP_STEPS + 1,
            f"ddp, {name}: {graphs.captures} captures and {graphs.replays} replays, want 2 (a step, a group of 2) "
            f"and {DDP_STEPS + 1}")


def _ddp_one_rank_nccl(card: str) -> dict:
    """(a) COGMEN banded at full width, 4 batches of one shape bucket (the first trained eagerly and captured,
    3 replayed) and two groups of 2 of them at K = 2 (the all-reduce twice in one graph), first without a process
    group (and timed then, while none is up), then as the one rank of an NCCL group that the entry point's
    start_group begins from --coordinator, --num_processes and --process_id: every step's losses and gnorm, the
    parameters, gradients, buffers and optimizer state bit for bit, one capture of each kind and 4 replays, the
    grouped run's K1/K2/K1ᵀ launches (counted from 0 around its steps alone) 8 steps' worth, a device trace of a
    replay with the group against the launch counts, and (information) a replayed step's wall and busy time
    with and without the group.  Returns the grouped run's launches and the times."""
    import torch
    from erc_tpu_torch.parallel import mesh

    one_bucket = "--length_bucket=96"
    alone = _cogmen_trainer("banded", one_bucket)
    require(not mesh.grouped(), f"ddp: {mesh.describe()} before the NCCL rank started")
    host = list(alone.make_loader("train"))[: DDP_STEPS + 1]
    require(len(_host_buckets(host)) == 1, "ddp: the batches span several shape buckets")
    ref = _steps_and_state(alone, host)
    _ddp_check_graphs(alone, "no group")
    times = {"no group": _ddp_step_times(alone, host[1], "no group")}
    port = _free_port()
    grouped = _cogmen_trainer("banded", one_bucket, f"--coordinator=localhost:{port}", "--num_processes=1",
                              "--process_id=0")
    require(mesh.grouped() and mesh.backend() == "nccl" and mesh.process_count() == 1,
            f"ddp: the entry point's flags started {mesh.describe()}, want one NCCL rank")
    log(f"ddp: {mesh.describe()}")
    require(grouped.train_graphs, "ddp: the one NCCL rank does not capture its train step")
    _reset_launches()
    got = _steps_and_state(grouped, host)
    path = {k: n for k, n in _read_launches().items() if n}
    n_steps = len(host) + 4  # 4 single steps, then two groups of 2
    want = {k: n_steps * n for k, n in TRAIN_STEP_LAUNCHES.items()}
    require(path == want, f"ddp: the NCCL rank's {n_steps} steps launched {path}, want {want}")
    _ddp_check_graphs(grouped, "NCCL group")
    require(ref.keys() == got.keys(), "ddp: the runs give other quantities")
    for k, a in ref.items():
        require(torch.equal(a, got[k]), f"ddp: with the NCCL group, {k} differs from the run without a group "
                f"(max abs diff {float((got[k].double() - a.double()).abs().max())})")
    log(f"ddp: {DDP_STEPS} replayed steps and a replayed group of 2 with the all-reduce captured ≡ the same without "
        f"a group, bit for bit in {len(ref)} quantities (losses, gnorm, parameters, gradients, buffers, optimizer "
        f"state, LR); one capture of the step and one of the group, {DDP_STEPS + 1} replays, each; the NCCL rank's "
        f"{n_steps} steps launched {path}")
    from torch.profiler import ProfilerActivity, profile

    before = _all_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        grouped.train_batch(host[1])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    traced = _trace_check("ddp: a replayed step with the NCCL group", before, names)
    nccl = sorted({n for n in names if "nccl" in n.lower()})
    log(f"ddp: NCCL's device operations in the replayed step's trace: {nccl or 'none'} ({len(names)} in all)")
    times["NCCL group"] = _ddp_step_times(grouped, host[1], "NCCL group")
    log(f"ddp: a replayed step (32 x 96), wall (median of {DDP_TIMING_ROUNDS}; no group first, then the group) "
        "/ busy ms: " + "; ".join(f"{k} {w:.3f} / {b if b is None else round(b, 3)}" for k, (w, b) in times.items()))
    return {"launches": path, "traced": traced, "nccl_ops": nccl, "times": times}


def _ddp_reference(host_jobs) -> dict:
    """(b)'s one-process reference on the card: each job's trainer (dropout 0) takes 3 eager steps on the
    train loader's first batches, then test()."""
    import torch

    out = {}
    for name, make in host_jobs:
        run = make()
        run.train_graphs = False  # as the ranks under gloo step
        walls, losses = [], []
        for b in list(run.make_loader("train"))[:DDP_STEPS]:
            t0 = time.perf_counter()
            losses.append(float(run.train_batch(b)["Lall"]))
            walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        out[name] = {"losses": losses, "walls": walls, "test_f1": run.test()["f1"], "test_dir": run.exp.test_dir}
    return out


def _ddp_two_gloo_ranks(card: str, ref: dict, model: int = 1) -> dict:
    """(b) two ranks sharing the card (gloo, eager steps), in their own processes
    (scripts/torch_mp_worker.py), at MeshSpec(data=2) or, with `model` = 2, at MeshSpec(data=1, model=2) (the
    mesh's model axis: each rank stores its half of the split parameters and of their moments): COGMEN banded at
    full width and DAG-ERC's kernel form at the IEMOCAP reimplement settings, dropout 0, 3 steps and test() each,
    against one process (`ref`, `_ddp_reference`); the BN running statistics equal on both ranks, one run
    directory that rank 0 alone wrote, and each rank's K1, K2, K1ᵀ, K3 and K4 launches what its steps should
    launch.  Returns the ranks' launches summed, each rank's, each rank's allocator bytes (``memory``: what its
    job keeps after the steps and its peak), and on the model axis each rank's stored bytes."""
    import os
    import tempfile

    import numpy as np

    dag_args = [*TRAIN_ARGS, "--epoch=1"]
    cog_args = [*COGMEN_TRAIN_ARGS, "--graph_impl=banded", "--epoch=1", "--drop_rate=0.0"]
    tag = "ddp" if model == 1 else "ddp model axis"
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ddp_"))
    common = [f"--device={DDP_RANK_DEVICE}", "--prefetch=false", "--heartbeat=false"]
    axis = {"model": model} if model > 1 else {}
    jobs = [{"name": "cogmen", "module": "cogmen", "args": [*cog_args, *common], "steps": DDP_STEPS, "test": True,
             "dump": str(tmp / "cogmen.{rank}.npz"), **axis},
            {"name": "dagerc", "module": "dagerc", "args": [*dag_args, *common], "steps": DDP_STEPS, "test": True,
             "dropout0": True, **axis}]
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            cmd = [sys.executable, str(ROOT / "scripts" / "torch_mp_worker.py"), f"--coordinator=localhost:{port}",
                   "--num_processes=2", f"--process_id={rank}", f"--jobs={tmp / 'jobs.json'}",
                   f"--out={tmp / f'rank{rank}.json'}"]
            procs.append(subprocess.Popen(cmd, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = [p.communicate(timeout=DDP_TIMEOUT)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        require(p.returncode == 0, f"{tag}: gloo rank {rank} exited {p.returncode}:\n{text[-4000:]}")
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    log(f"{tag}: two gloo ranks ran in {time.perf_counter() - t0:.1f} s (processes started included)")
    launches, per_rank, stored, memory = {}, [{}, {}], {}, {}
    for name in ("cogmen", "dagerc"):
        r0, r1 = ranks[0][name], ranks[1][name]
        one = ref[name]
        for r in (r0, r1):
            require(r["backend"] == "gloo" and r["world"] == 2 and not r["train_graphs"]
                    and r["device"] == DDP_RANK_DEVICE,
                    f"{tag} {name}: rank {r['rank']} ran {r['backend']} at world {r['world']} on {r['device']}, "
                    f"captured {r['train_graphs']}: want gloo, 2, {DDP_RANK_DEVICE}, eager")
        require(np.allclose(r0["losses"], one["losses"], rtol=DDP_LOSS_RTOL, atol=DDP_LOSS_ATOL),
                f"{tag} {name}: rank 0's losses {r0['losses']} against one process's {one['losses']}")
        require(np.allclose(r1["losses"], r0["losses"], rtol=DDP_RANK_RTOL, atol=0),
                f"{tag} {name}: the ranks' losses {r0['losses']} and {r1['losses']}")
        require(r0["test_f1"] == r1["test_f1"], f"{tag} {name}: test F1 {r0['test_f1']} and {r1['test_f1']}")
        require(r0["test_name"] == r1["test_name"] and r0["test_dir"] == r1["test_dir"],
                f"{tag} {name}: the ranks ran in two run directories")
        files = sorted(f for f in os.listdir(r0["test_dir"]) if not f.startswith("log."))
        want = sorted(f for f in os.listdir(one["test_dir"]) if not f.startswith("log."))
        logs_ = {f.rsplit(".", 2)[-2]: f for f in os.listdir(r0["test_dir"]) if f.startswith("log.")}  # by rank
        require(files == want and sorted(logs_) == ["0", "1"]
                and os.path.getsize(os.path.join(r0["test_dir"], logs_["1"])) == 0,
                f"{tag} {name}: the run directory holds {files} and logs {logs_}, one process's {want}")
        rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(r0["losses"], one["losses"]))
        log(f"{tag} {name}: losses rank 0 {r0['losses']}, rank 1 {r1['losses']}, one process {one['losses']} "
            f"(worst relative {rel:.3e}); test F1 {r0['test_f1']} on both ranks, one process {one['test_f1']}; "
            f"step walls ms, rank 0 {[round(w * 1e3, 3) for w in r0['walls']]}, rank 1 "
            f"{[round(w * 1e3, 3) for w in r1['walls']]}, one process {[round(w * 1e3, 3) for w in one['walls']]}")
        for r in (r0, r1):
            if name == "cogmen":
                want_l = {k: DDP_STEPS * n for k, n in TRAIN_STEP_LAUNCHES.items()}
            else:
                blocks = sum(-(-L // 16) for L in r["lengths"])
                want_l = {"dag_block": 2 * 4 * blocks, "dag_block_bwd": 4 * blocks}
            got_l = {k: r["launches"].get(k, 0) for k in want_l}
            require(got_l == want_l, f"{tag} {name}: rank {r['rank']} launched {got_l}, want {want_l}")
            for k, n in got_l.items():
                launches[k] = launches.get(k, 0) + n
                per_rank[r["rank"]][k] = per_rank[r["rank"]].get(k, 0) + n
        if model > 1:
            for r in (r0, r1):
                require(r["sharded"] and r["model_index"] == r["rank"] and r["data_index"] == 0,
                        f"{tag} {name}: rank {r['rank']} split {r.get('sharded')} at model index "
                        f"{r.get('model_index')}, data index {r.get('data_index')}")
            stored[name] = [r["stored_bytes"] for r in (r0, r1)]
            b = r0["stored_bytes"]
            log(f"{tag} {name}: {len(r0['sharded'])} parameters split ({b['split']} bytes); each rank keeps "
                f"{b['parameters']} parameter, {b['gradients']} gradient and {b['moments']} moment bytes, one "
                f"process {b['moments_unsplit']} moment bytes (the parameters and gradients stay whole)")
        memory[name] = [r["memory"] for r in (r0, r1)]
        log(f"{tag} {name}: each rank's launches in its {DDP_STEPS} steps {r0['launches']} / {r1['launches']}")
    bn = [np.load(tmp / f"cogmen.{r}.npz") for r in range(2)]
    for stat in ("model.gcn.bn.running_mean", "model.gcn.bn.running_var"):
        require(np.array_equal(bn[0][stat], bn[1][stat]), f"{tag}: {stat} differs between the ranks")
    log(f"{tag}: the batch norm's running statistics are equal on both ranks")
    return {"launches": launches, "per_rank": per_rank, "stored": stored, "memory": memory}


def drive_ddp(card: str) -> dict:
    """Phase 20: data-parallel training (parallel/mesh.py).  (b) first, while this process has no process group,
    then (a), which leaves one; it is ended here.  The phase's launches are those of the ddp path alone: each
    gloo rank's steps (counted in the rank around them) and the NCCL rank's steps (counted from 0 around them);
    the one-process references and the runs without a group are left out."""
    from erc_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    ref = _ddp_reference([("cogmen", lambda: _cogmen_trainer("banded", dropout=0.0)),
                          ("dagerc", lambda: _trainer(dropout=0.0))])
    ranks = _ddp_two_gloo_ranks(card, ref)
    axis = _ddp_two_gloo_ranks(card, ref, model=2)
    try:
        one = _ddp_one_rank_nccl(card)
    finally:
        mesh.destroy()
    for name, dp in ranks["memory"].items():  # a data-parallel rank keeps one process's parameters and moments
        tp = axis["memory"][name]
        saved = [d["kept"] - t["kept"] for d, t in zip(dp, tp)]
        counted = [s["moments_unsplit"] - s["moments"] for s in axis["stored"][name]]
        log(f"ddp phase {name}: the allocator's bytes a rank keeps after its steps, data-parallel {[d['kept'] for d in dp]}, "
            f"model axis {[t['kept'] for t in tp]} (saved {saved}, the moments counted {counted}); peaks "
            f"{[d['peak'] for d in dp]} and {[t['peak'] for t in tp]} (a data-parallel rank holds half the rows)")
        require(all(x > 0 for x in saved), f"ddp phase {name}: a model-axis rank keeps no fewer bytes than a "
                                           f"data-parallel one ({saved})")
    launches = dict(ranks["launches"])
    for k, n in one["launches"].items():
        launches[k] = launches.get(k, 0) + n
    log(f"ddp phase: launches on the ddp path {launches} (both gloo ranks' {ranks['launches']}, the NCCL rank's "
        f"{one['launches']}); on the model axis each rank's {axis['per_rank']}; {time.perf_counter() - t0:.1f} s")
    return {**one, "launches": launches, "model_axis": axis}


# ------------------------------------------------------------------ phase 21
PRE_TOL = 1e-4  # card vs the CPU port: features, logits, embeddings relative to max |CPU's|; fbank, MFCC absolute
PRE_BATCH_TOL = 1e-5  # the 16-clip batch vs per-clip calls on the card, relative to max |feature|
PRE_WALK_TOL = 1e-6  # the walk's rows vs per-utterance extract calls on the card, relative to max |feature|
PRE_WAVS = 16  # 16 kHz wavs of 2.0-8.0 s
TSN_CLIPS, TSN_SEGMENTS, CROP = 16, 8, 224
CPU_CLIPS = 2  # TSN clips the CPU port extracts (TSM and X3D: 1)
TEXT_SENTENCES, TEXT_CPU, TEXT_TOKENS, TEXT_BATCH = 256, 64, 64, 64
# the stand-in for sentence-transformers/paraphrase-distilroberta-base-v1 (RoBERTa-base widths, 6 layers)
TEXT_WIDTHS = dict(vocab=50265, width=768, heads=12, layers=6, ffn=3072, positions=514)


@contextlib.contextmanager
def _tf32_allowed():
    """TF32 allowed for float32 in cuBLAS and in cuDNN's convolutions, as settings of the process, for the phase;
    the extractors' own full-float32 scope must override them.  Restored after."""
    import torch

    backends = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)
    before = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "tf32"
    try:
        yield
    finally:
        for b, v in zip(backends, before):
            b.fp32_precision = v


def _numerics() -> tuple:
    import torch

    return (torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision,
            torch.backends.cudnn.benchmark)


def _extract(what: str, fn):
    """`fn()` on the card, with the process's numerics settings as they were after it."""
    before = _numerics()
    out = fn()
    require(_numerics() == before, f"{what} left the numerics settings changed: {before} -> {_numerics()}")
    return out


def _rel_err(got, want) -> float:
    import numpy as np

    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / max(np.abs(np.asarray(want)).max(), 1e-30))


def _write_speech_like_wavs(wav_dir: Path, seconds) -> None:
    """16-bit mono 16 kHz wavs: harmonics of a gliding f0 (100-250 Hz) under a 1/k roll-off, a syllable-rate
    envelope, noise 30 dB below, peaks near -12 dBFS."""
    import wave

    import numpy as np

    rng = np.random.default_rng(21)
    wav_dir.mkdir(parents=True)
    for i, sec in enumerate(seconds):
        t = np.arange(int(16000 * sec)) / 16000
        f0 = rng.uniform(100, 250) * (1 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t))
        phase = 2 * np.pi * np.cumsum(f0) / 16000
        voiced = sum(np.sin(k * phase) / k for k in range(1, 30))
        env = 0.5 * (1 - np.cos(2 * np.pi * rng.uniform(2, 5) * t))
        sig = 0.1 * voiced * env + 0.003 * rng.normal(size=t.shape)
        pcm = np.clip(sig / np.abs(sig).max() * 0.25 * 32767, -32768, 32767).astype(np.int16)
        with wave.open(str(wav_dir / f"utt{i:02d}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())


def _float64_features(sig, feature: str):
    """The acoustic formula (log-mel or MFCC) of one [T] signal in float64 (numpy), from the port's constants."""
    import numpy as np

    from erc_tpu_torch.preprocess import acoustic as ac

    fb_dim = 80 if feature == "fbank" else 40
    window = (ac.win_hamming if feature == "fbank" else ac.win_povey)(400).astype(np.float64)
    idx = np.arange((len(sig) - 400) // 160 + 1)[:, None] * 160 + np.arange(400)[None, :]
    fr = np.asarray(sig, np.float64)[idx]
    fr = fr - fr.mean(-1, keepdims=True)
    energy = np.log((fr * fr).sum(-1, keepdims=True) + 1e-6)
    fr = np.concatenate([fr[:, :1] * 0.03, fr[:, 1:] - 0.97 * fr[:, :-1]], -1) * window
    st = np.fft.rfft(np.pad(fr, ((0, 0), (0, 112))))[:, 1:257]
    fb = np.log((st.real ** 2 + st.imag ** 2 + 1e-6) @ ac.mel_filterbank(fb_dim, 512).astype(np.float64))
    if feature == "fbank":
        return fb
    return np.concatenate([energy, (fb @ ac.mfcc_dct(23, fb_dim).astype(np.float64))[:, 1:]], -1)


def _preprocess_acoustic(card: str, tmp: Path) -> None:
    """The acoustic entry on the card against the same entry with --device=cpu, for each feature."""
    import pickle

    import numpy as np

    from erc_tpu_torch.preprocess import entry

    seconds = np.linspace(2.0, 8.0, PRE_WAVS)
    wav_dir = tmp / "wavs"
    _write_speech_like_wavs(wav_dir, seconds)
    for feature in ("fbank", "mfcc", "stft"):
        args = ["acoustic", f"--wav_dir={wav_dir}", f"--feature={feature}"]
        _extract(f"acoustic {feature}", lambda: entry.main(args + [f"--out={tmp / 'warm.pkl'}"]))  # cuFFT plans
        t0 = time.perf_counter()
        _extract(f"acoustic {feature}", lambda: entry.main(args + [f"--out={tmp / 'card.pkl'}"]))
        wall = time.perf_counter() - t0
        entry.main(args + [f"--out={tmp / 'cpu.pkl'}", "--device=cpu"])
        got, want = (pickle.loads((tmp / n).read_bytes()) for n in ("card.pkl", "cpu.pkl"))
        require(sorted(got) == sorted(want) and len(got) == PRE_WAVS, f"acoustic {feature}: keys {sorted(got)}")
        worst, slack = 0.0, 0.0
        for k in want:
            require(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype and np.isfinite(got[k]).all(),
                    f"acoustic {feature} {k}: {got[k].shape} {got[k].dtype} vs {want[k].shape} {want[k].dtype}")
            if feature == "stft":
                err = _rel_err(got[k], want[k])
                require(err <= PRE_TOL, f"acoustic stft {k}: card vs CPU {err:.3e} of max |X| > {PRE_TOL}")
            else:
                own = float(np.abs(want[k] - _float64_features(entry.read_wav(str(wav_dir / f"{k}.wav")),
                                                               feature)).max())
                err = float(np.abs(got[k] - want[k]).max())
                require(err <= PRE_TOL + 2 * own, f"acoustic {feature} {k}: card vs CPU {err:.3e} > {PRE_TOL} + "
                                                  f"2 x the CPU's own float32 deviation {own:.3e}")
                slack = max(slack, own)
            worst = max(worst, err)
        log(f"preprocess: acoustic {feature} of {PRE_WAVS} wavs ({seconds.sum():.1f} s of audio): card vs CPU "
            f"{worst:.3e} {'of max |X|' if feature == 'stft' else 'abs'}"
            + ("" if feature == "stft" else f" (the CPU's own float32 deviation from float64 up to {slack:.3e})")
            + f"; the entry {wall:.3f} s, {seconds.sum() / wall:.1f} audio s/s; on {card}")


def _preprocess_tsn(card: str):
    """TSN's batch path, its single-clip path through the speaker crop, card vs the CPU port; returns the card's
    extractor (the walk uses it)."""
    import importlib.util

    import numpy as np

    from erc_tpu_torch.preprocess import video

    rng = np.random.default_rng(22)
    clips = rng.integers(0, 256, (TSN_CLIPS, TSN_SEGMENTS, CROP, CROP, 3), dtype=np.uint8)
    ex = video.TSNExtractor(n_segments=TSN_SEGMENTS, crop_size=CROP, seed=1)
    cpu = video.TSNExtractor(n_segments=TSN_SEGMENTS, crop_size=CROP, seed=1, device="cpu")
    feats = _extract("TSN extract_batch", lambda: ex.extract_batch(clips))
    require(feats.shape == (TSN_CLIPS, 2048) and np.isfinite(feats).all(), f"TSN features {feats.shape}")
    err = _rel_err(feats[:CPU_CLIPS], cpu.extract_batch(clips[:CPU_CLIPS]))
    require(err <= PRE_TOL, f"TSN extract_batch: card vs CPU {err:.3e} > {PRE_TOL}")
    single = np.concatenate([ex.extract_batch(clips[i: i + 1]) for i in range(TSN_CLIPS)])
    err_b = _rel_err(feats, single)
    require(err_b <= PRE_BATCH_TOL, f"TSN: the 16-clip batch vs per-clip calls {err_b:.3e} > {PRE_BATCH_TOL}")
    wall, busy = _wall_and_busy(lambda: ex.extract_batch(clips),
                                f"TSN extract_batch of {TSN_CLIPS} clips x {TSN_SEGMENTS} segments", reps=3)
    log(f"preprocess: TSN ResNet-50 extract_batch {TSN_CLIPS} x {TSN_SEGMENTS} x {CROP}^2: card vs CPU ({CPU_CLIPS} "
        f"clips) {err:.3e}, batch vs per-clip {err_b:.3e}; {wall * 1e3:.3f} ms, {TSN_CLIPS / wall:.1f} clips/s, "
        f"{TSN_CLIPS * TSN_SEGMENTS / wall:.1f} frames/s, busy "
        f"{'not measured' if busy is None else f'{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f} %)'}; on {card}")
    branch = "cv2.resize" if importlib.util.find_spec("cv2") else "centre crop and stride (no cv2)"
    for i, (n, spk) in enumerate(((24, "M"), (36, "F"), (48, "M"))):
        frames = rng.integers(0, 256, (n, 480, 720, 3), dtype=np.uint8)
        crop = np.stack([video.crop_speaker_half(f, spk) for f in frames])
        got = _extract("TSN extract", lambda: ex.extract(crop))
        err = _rel_err(got, cpu.extract(crop))
        require(got.shape == (2048,) and np.isfinite(got).all() and err <= PRE_TOL,
                f"TSN extract of a {crop.shape} clip: {got.shape}, card vs CPU {err:.3e}")
        log(f"preprocess: TSN extract of {n} frames 480 x 720 -> {crop.shape[1:3]} speaker {spk} ({branch}): "
            f"card vs CPU {err:.3e}")
    return ex


def _preprocess_tsm_x3d(card: str) -> None:
    import copy

    import numpy as np
    import torch

    from erc_tpu_torch.preprocess import full_fp32, video
    from erc_tpu_torch.preprocess.tsm import TSMRecognizer
    from erc_tpu_torch.preprocess.x3d import X3D

    rng = np.random.default_rng(23)
    u8 = rng.integers(0, 256, (4, TSN_SEGMENTS, CROP, CROP, 3), dtype=np.uint8)
    x = torch.from_numpy((u8.astype(np.float32) - video.IMAGENET_MEAN) / video.IMAGENET_STD).permute(0, 1, 4, 2, 3)
    cpu_model = video.init_weights(TSMRecognizer(6, TSN_SEGMENTS), torch.Generator().manual_seed(3)).eval()
    model = copy.deepcopy(cpu_model).cuda()

    def tsm(m, inp):
        with torch.inference_mode(), full_fp32():
            return m(inp).cpu().numpy()

    logits = _extract("TSM", lambda: tsm(model, x.cuda()))
    err = _rel_err(logits[:1], tsm(cpu_model, x[:1]))
    require(logits.shape == (4, 6) and np.isfinite(logits).all() and err <= PRE_TOL,
            f"TSM: logits {logits.shape}, card vs CPU {err:.3e}")
    xc = x.cuda()
    wall = statistics.median(_step_time(lambda: tsm(model, xc)) for _ in range(3))
    log(f"preprocess: TSMRecognizer (6 classes, {TSN_SEGMENTS} segments) on 4 clips: card vs CPU (1 clip) {err:.3e}; "
        f"{wall * 1e3:.3f} ms, {4 / wall:.1f} clips/s, {4 * TSN_SEGMENTS / wall:.1f} frames/s; on {card}")

    clips = rng.integers(0, 256, (4, 16, CROP, CROP, 3), dtype=np.uint8)
    ex = video.X3DExtractor(n_frames=16, crop_size=CROP, seed=1)
    cpu = video.X3DExtractor(n_frames=16, crop_size=CROP, seed=1, device="cpu")
    require(ex.model.blocks == [3, 5, 11, 7] and ex.model.feat_dim == 432, "X3D-M's blocks and width")
    feats = _extract("X3D extract_batch", lambda: ex.extract_batch(clips))
    err = _rel_err(feats[:1], cpu.extract_batch(clips[:1]))
    require(feats.shape == (4, 432) and np.isfinite(feats).all() and err <= PRE_TOL,
            f"X3D-M: features {feats.shape}, card vs CPU {err:.3e}")
    wall, busy = _wall_and_busy(lambda: ex.extract_batch(clips), "X3D-M extract_batch of 4 clips x 16 frames", reps=3)
    log(f"preprocess: X3D-M extract_batch 4 x 16 x {CROP}^2: card vs CPU (1 clip) {err:.3e}; {wall * 1e3:.3f} ms, "
        f"{4 / wall:.1f} clips/s, {64 / wall:.1f} frames/s, busy "
        f"{'not measured' if busy is None else f'{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f} %)'}; on {card}")


def _release_tree(base: Path, rng):
    """An IEMOCAP release tree (transcripts, empty avis) and a 4-class COGMEN dump under base/iemocap: 2 dialogues
    x 8 utterances of 1-3 s; returns {dialogue: its frames} at 30 fps, 480 x 720."""
    import pickle

    import numpy as np

    root = base / "iemocap"
    frames, sent, spk = {}, {}, {}
    pool = rng.integers(0, 256, (40, 480, 720, 3), dtype=np.uint8)
    for s, dia in enumerate(("Ses01F_impro01", "Ses02M_script01_1"), start=1):
        tra = root / "IEMOCAP_full_release" / f"Session{s}" / "dialog" / "transcriptions"
        avi = root / "IEMOCAP_full_release" / f"Session{s}" / "dialog" / "avi" / "DivX"
        tra.mkdir(parents=True)
        avi.mkdir(parents=True)
        (avi / f"{dia}.avi").write_bytes(b"")
        t, lines = 0.3, []
        sent[dia], spk[dia] = [], []
        for j in range(8):
            t1 = t + rng.uniform(1.0, 3.0)
            g = "F" if j % 2 == 0 else "M"
            sent[dia].append(f"utterance {j} of {dia}")
            spk[dia].append(g)
            lines.append(f"{dia}_{g}{j:03d} [{t:.4f}-{t1:.4f}]: {sent[dia][-1]}\n")
            t = t1 + 0.2
        (tra / f"{dia}.txt").write_text("".join(lines))
        frames[dia] = pool[np.arange(int(np.ceil(t * 30)) + 1) % len(pool)]
    dump = root / "cogmen" / "iemocap_4" / "IEMOCAP_features_4.pkl"
    dump.parent.mkdir(parents=True)
    feats = {k: np.zeros((8, 4), np.float32) for k in sent}
    dump.write_bytes(pickle.dumps(({k: k for k in sent}, spk, {k: [0] * 8 for k in sent}, feats, feats, feats, sent,
                                   list(sent), [])))
    return frames


def _preprocess_walk(card: str, ex, tmp: Path) -> None:
    """The dialogue walk through the registry's video view and the card's TSN extractor."""
    import os

    import numpy as np

    from erc_tpu_torch.data import registry
    from erc_tpu_torch.preprocess import video_walk

    frames = _release_tree(tmp / "data", np.random.default_rng(24))
    saved = os.environ.get("ERC_TPU_DATA_ROOT")
    os.environ["ERC_TPU_DATA_ROOT"] = str(tmp / "data")
    try:
        clips = registry.pick_datas(registry.get_root("iemocap-cogmen-video-4"), "iemocap-cogmen-video-4")
    finally:
        if saved is None:
            os.environ.pop("ERC_TPU_DATA_ROOT")
        else:
            os.environ["ERC_TPU_DATA_ROOT"] = saved
    require(sorted(clips) == sorted(frames), f"the video view aligned {sorted(clips)}")

    def read_video(fn):
        return frames[os.path.basename(fn).split(".")[0]], 30.0

    failures = []
    t0 = time.perf_counter()
    out = _extract("the dialogue walk", lambda: video_walk.extract_dialogue_features(clips, ex.extract, read_video,
                                                                                       log=failures.append))
    wall = time.perf_counter() - t0
    require(not failures, f"the dialogue walk: {failures}")
    worst, bitwise = 0.0, True
    for dia, sample in clips.items():
        rows = out[dia]
        require(isinstance(rows, np.ndarray) and rows.shape == (8, 2048) and np.isfinite(rows).all(),
                f"dialogue {dia}: {type(rows).__name__} {getattr(rows, 'shape', None)}, want (8, 2048)")
        f_left = "F" in os.path.basename(sample["fn"])
        for r, ((_, left, right), g) in enumerate(zip(sample["timestamp"], sample["speaker"])):
            arr = video_walk.crop_speaker(frames[dia][round(left * 30): round(right * 30)],
                                          take_left=(f_left == video_walk._gender_flag(g)))
            ref = ex.extract(arr)
            worst = max(worst, _rel_err(rows[r], ref))
            bitwise = bitwise and bool((rows[r] == ref).all())
    require(worst <= PRE_WALK_TOL, f"the dialogue walk vs per-utterance extract calls: {worst:.3e} > {PRE_WALK_TOL}")
    log(f"preprocess: dialogue walk, 2 dialogues x 8 utterances (480 x 720, 30 fps): every dialogue (8, 2048), vs "
        f"per-utterance calls {worst:.3e} ({'bit for bit' if bitwise else 'not bit for bit'}); {wall:.3f} s, "
        f"{16 / wall:.1f} utterances/s; on {card}")


def _stand_in_encoder(seed: int):
    """A random RoBERTa-shaped encoder with the Hugging Face call convention (`input_ids`, `attention_mask` ->
    `.last_hidden_state`, `.pooler_output`) at TEXT_WIDTHS: no model directory is in the checkout, and none is
    downloaded."""
    import types

    import torch
    from torch import nn
    from torch.nn import functional as F

    from erc_tpu_torch.ops.init import normal_

    w = TEXT_WIDTHS

    class Layer(nn.Module):
        def __init__(self):
            super().__init__()
            d = w["width"]
            self.qkv, self.out = nn.Linear(d, 3 * d), nn.Linear(d, d)
            self.fc1, self.fc2 = nn.Linear(d, w["ffn"]), nn.Linear(w["ffn"], d)
            self.ln1, self.ln2 = nn.LayerNorm(d, eps=1e-5), nn.LayerNorm(d, eps=1e-5)

        def forward(self, x, bias):
            b, n, d = x.shape
            q, k, v = self.qkv(x).view(b, n, 3, w["heads"], d // w["heads"]).permute(2, 0, 3, 1, 4)
            a = F.scaled_dot_product_attention(q, k, v, attn_mask=bias).transpose(1, 2).reshape(b, n, d)
            x = self.ln1(x + self.out(a))
            return self.ln2(x + self.fc2(F.gelu(self.fc1(x))))

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            d = w["width"]
            self.word = nn.Embedding(w["vocab"], d, padding_idx=1)
            self.pos = nn.Embedding(w["positions"], d, padding_idx=1)
            self.ln = nn.LayerNorm(d, eps=1e-5)
            self.layers = nn.ModuleList(Layer() for _ in range(w["layers"]))
            self.pooler = nn.Linear(d, d)

        def forward(self, input_ids, attention_mask):
            real = (input_ids != 1).long()
            x = self.ln(self.word(input_ids) + self.pos(torch.cumsum(real, 1) * real + 1))
            bias = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * torch.finfo(x.dtype).min
            for layer in self.layers:
                x = layer(x, bias)
            return types.SimpleNamespace(last_hidden_state=x, pooler_output=torch.tanh(self.pooler(x[:, 0])))

    g = torch.Generator().manual_seed(seed)
    enc = Encoder()
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                normal_(m.weight, 0.02, g)
                if isinstance(m, nn.Linear):
                    m.bias.zero_()
    return enc.eval()


class _StandInTokenizer:
    """`transformers`' call convention: <s> word ids </s>, padded with 1 to max_length (truncated)."""

    def __call__(self, sentences, padding, truncation, max_length, return_tensors):
        import zlib

        import numpy as np

        ids = np.ones((len(sentences), max_length), np.int64)
        am = np.zeros((len(sentences), max_length), np.int64)
        for i, s in enumerate(sentences):
            toks = [0] + [3 + zlib.crc32(t.encode()) % (TEXT_WIDTHS["vocab"] - 3) for t in s.split()][
                : max_length - 2] + [2]
            ids[i, : len(toks)], am[i, : len(toks)] = toks, 1
        return {"input_ids": ids, "attention_mask": am}


def _preprocess_text(card: str) -> None:
    import copy

    import numpy as np

    from erc_tpu_torch.preprocess.lexical import TextEncoder

    rng = np.random.default_rng(25)
    words = [f"w{int(i)}" for i in rng.integers(0, 10 ** 6, 5000)]
    sentences = [" ".join(rng.choice(words, int(rng.integers(3, 90)))) for _ in range(TEXT_SENTENCES)]
    model = _stand_in_encoder(4)
    cpu_model = copy.deepcopy(model)
    n_params = sum(p.numel() for p in model.parameters())
    for mode in ("sbert", "robert"):
        kw = dict(mode=mode, max_tokens=TEXT_TOKENS, batch_size=TEXT_BATCH)
        enc = TextEncoder(model, _StandInTokenizer(), **kw)
        got = _extract(f"text {mode}", lambda: enc.encode(sentences))
        t0 = time.perf_counter()
        enc.encode(sentences)
        wall = time.perf_counter() - t0
        err = _rel_err(got[:TEXT_CPU], TextEncoder(cpu_model, _StandInTokenizer(), device="cpu", **kw)
                       .encode(sentences[:TEXT_CPU]))
        require(got.shape == (TEXT_SENTENCES, TEXT_WIDTHS["width"]) and np.isfinite(got).all() and err <= PRE_TOL,
                f"text {mode}: {got.shape}, card vs CPU {err:.3e}")
        log(f"preprocess: text {mode}, {TEXT_SENTENCES} sentences x {TEXT_TOKENS} tokens, batch {TEXT_BATCH}, a "
            f"random stand-in encoder of {n_params:,} parameters ({TEXT_WIDTHS}): card vs CPU "
            f"({TEXT_CPU} sentences) {err:.3e}; {wall:.3f} s, {TEXT_SENTENCES / wall:.1f} sentences/s; on {card}")


def drive_preprocess(card: str) -> dict:
    """Phase 21: feature extraction on the card, every count of K1-K4 set to 0 before and read after (the
    extraction path runs none of them)."""
    import importlib.util
    import tempfile

    t0 = time.perf_counter()
    log("preprocess: optional packages here: " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}" for m in ("cv2", "transformers", "h5py")))
    _reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pre_") as d, _tf32_allowed():
        tmp = Path(d)
        _preprocess_acoustic(card, tmp)
        ex = _preprocess_tsn(card)
        _preprocess_tsm_x3d(card)
        _preprocess_walk(card, ex, tmp)
        _preprocess_text(card)
    launches = _no_kernel_launches("preprocessing")
    log(f"preprocess phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------------ phase 22
EXTRAS_IMAGES = 256  # CIFAR-size 32 x 32 x 3 uint8 images of the RandAugment checks
EXTRAS_BLEND_SHARE, EXTRAS_BLEND_MAX = 0.999, 1  # float-blend ops, card vs CPU: pixels equal, and none off by more
EXTRAS_FEAT_TOL = 1e-4  # backbone features, card vs the CPU port, relative to max |CPU|
EXTRAS_STAT_TOL = 1e-5  # running statistics after a train-mode forward, relative to max(1, max |CPU|)
EXTRAS_GRAD_TOL = 1e-4  # each parameter's gradient in float64, relative to its norm on the CPU
EXTRAS_CONV_TOL = 1e-4  # 3x3 convolutions' float32 input and weight gradients, relative to max |CPU|
EXTRAS_FUSION_TOL = 1e-5  # fusion modules' outputs and attention weights
EXTRAS_LOSS_TOL = 1e-6  # the loss zoo, mixup and cutmix_apply given the same draws
EXTRAS_RATE_REPS = 10
EXTRAS_BACKBONES = (("wideresnet_28_2", 64), ("resnet18", 32), ("resnet50", 32))
EXTRAS_INTEGER_OPS = {"autocontrast", "equalize", "identity", "posterize", "rotate", "shear_x", "shear_y",
                      "solarize", "translate_x", "translate_y", "invert", "cutout"}


def _pixels_agree(name: str, got, want) -> float:
    """The share of equal pixels (channels) of two uint8 results; bit for bit for an integer-path op, else at least
    EXTRAS_BLEND_SHARE equal and none off by more than EXTRAS_BLEND_MAX."""
    d = (got.cpu().int() - want.int()).abs()
    share = float((d == 0).float().mean())
    if name in EXTRAS_INTEGER_OPS:
        require(share == 1.0, f"extras: {name} on the card differs from the CPU port in {1 - share:.3e} of pixels "
                f"(max {int(d.max())}); an integer-path op must agree bit for bit")
    else:
        require(share >= EXTRAS_BLEND_SHARE and int(d.max()) <= EXTRAS_BLEND_MAX,
                f"extras: {name} card vs CPU: {share:.6f} of pixels equal (want >= {EXTRAS_BLEND_SHARE}), "
                f"max off {int(d.max())} (want <= {EXTRAS_BLEND_MAX})")
    return share


def _extras_augment(card: str) -> dict:
    """Each RandAugment op and cutout on EXTRAS_IMAGES images at a magnitude per image, and one randaugment of the
    batch from given draws, card vs the CPU port; (information) augmented images/s of a batched randaugment."""
    import torch
    from erc_tpu_torch import augment_image as aug

    g = torch.Generator().manual_seed(20)
    imgs = torch.randint(0, 256, (EXTRAS_IMAGES, 32, 32, 3), generator=g, dtype=torch.uint8)
    imgs[:4, :, :, 1] = 77  # flat channels: autocontrast's and equalize's identity branches
    gpu = imgs.cuda()
    u = torch.rand(EXTRAS_IMAGES, generator=g)
    shares = {}
    for op, lo, hi in [*aug.AUGMENT_LIST, (aug.invert, 0.0, 1.0)]:
        v = lo + (hi - lo) * u
        shares[op.__name__] = _pixels_agree(op.__name__, op(gpu, v.cuda()), op(imgs, v))
    cut = [torch.rand(EXTRAS_IMAGES, generator=g) for _ in range(3)]
    cut[0] = cut[0] * 0.5
    shares["cutout"] = _pixels_agree("cutout", aug.cutout_apply(gpu, *(c.cuda() for c in cut)),
                                     aug.cutout_apply(imgs, *cut))
    draws = aug.randaugment_draw(EXTRAS_IMAGES, 2, generator=g)
    shares["randaugment"] = _pixels_agree("randaugment", aug.randaugment_apply(gpu, {k: v.cuda() for k, v in
                                                                                    draws.items()}),
                                          aug.randaugment_apply(imgs, draws))
    gen = torch.Generator(device="cuda").manual_seed(0)
    aug.randaugment(gpu, 2, generator=gen)  # warm
    wall = statistics.median(_step_time(lambda: aug.randaugment(gpu, 2, generator=gen))
                             for _ in range(EXTRAS_RATE_REPS))
    busy = _profile(lambda: aug.randaugment(gpu, 2, generator=gen), "extras: randaugment of 256 images", wall)
    rate = EXTRAS_IMAGES / wall
    log(f"extras: RandAugment card vs CPU, share of equal pixels {json.dumps(shares)}; a batched randaugment of "
        f"{EXTRAS_IMAGES} images {wall * 1e3:.3f} ms ({rate:.1f} images/s), busy {busy} ms, on {card}")
    return {"shares": shares, "images_per_s": rate, "busy_ms": busy}


def _train_pass(m, x) -> tuple:
    """A train-mode forward and backward of (feats ** 2).mean(): features, running statistics and each
    parameter's gradient, on the host in float64."""
    import torch

    m.train()
    m.zero_grad(set_to_none=True)
    with torch.enable_grad():
        f = m(x)
        (f ** 2).mean().backward()
    stats = {k: v.detach().double().cpu() for k, v in m.state_dict().items() if k.endswith(("running_mean",
                                                                                          "running_var"))}
    return f.detach().double().cpu(), stats, {k: p.grad.detach().double().cpu() for k, p in m.named_parameters()}


def _grad_gap(got: dict, want: dict) -> tuple:
    """Worst over parameters of max |got - want| over the norm of `want`, and that parameter."""
    return max((float((got[k] - v).abs().max()) / max(float(v.norm()), 1e-30), k) for k, v in want.items())


EXTRAS_CONV_SHAPES = ((3, 16, 1, 32), (16, 32, 1, 32), (32, 32, 1, 32), (32, 64, 2, 32), (64, 64, 1, 16),
                      (64, 128, 2, 16), (128, 128, 1, 8), (32, 64, 1, 32))  # WRN-28-2's (in, out, stride, H = W)


def _conv_backward_gap(ib, guard: bool = True) -> float:
    """The float32 input and weight gradients of a 3x3 backbone convolution at each of WRN-28-2's shapes (batch 8),
    card vs CPU, relative to max |CPU|, worst of them: the backward's full-float32 guard (`guard=False` drops it,
    for the log)."""
    import torch

    real = ib._backward_in_full_fp32
    if not guard:
        ib._backward_in_full_fp32 = lambda *a, **k: None
    worst = 0.0
    try:
        for c_in, c_out, stride, hw in EXTRAS_CONV_SHAPES:
            cpu = ib.Conv2d(c_in, c_out, 3, stride, generator=torch.Generator().manual_seed(3))
            card_m = ib.Conv2d(c_in, c_out, 3, stride).cuda()
            card_m.load_state_dict(cpu.state_dict())
            g = torch.Generator().manual_seed(4)
            x = torch.randn(8, c_in, hw, hw, generator=g)
            w = torch.randn(8, c_out, hw // stride, hw // stride, generator=g)
            grads = []
            for m, xx, ww in ((cpu, x, w), (card_m, x.cuda(), w.cuda())):
                xx = xx.clone().requires_grad_(True)
                with torch.enable_grad():
                    (m(xx) * ww).sum().backward()
                grads.append((xx.grad.cpu(), m.weight.grad.cpu()))
            worst = max(worst, *(float((b - a).abs().max()) / float(a.abs().max()) for a, b in zip(*grads)))
    finally:
        ib._backward_in_full_fp32 = real
    return worst


def _extras_backbones(card: str) -> dict:
    """The CIFAR backbones, random weights from a seed, card vs the CPU port, TF32 allowed in the process (the
    backbones' own full-float32 convolutions must override it): float32 eval features and a float32 train-mode
    forward (features, running statistics); the gradients of (feats ** 2).mean() in float64 on both sides (in
    float32 the batch norms' gradients are ill-conditioned: rounding alone moves them up to 7e-3 of their norms,
    the CPU's against float64 too, and more at some seeds: PERF.md §6), logged in float32 for information;
    one convolution's float32 backward with TF32 allowed (the backward's guard); (information) WRN-28-2's
    train-step images/s and busy share."""
    import torch
    from erc_tpu_torch.models import image_backbones as ib

    out = {}
    for name, batch in EXTRAS_BACKBONES:
        cpu = getattr(ib, name)(generator=torch.Generator().manual_seed(1))
        card_m = getattr(ib, name)().cuda()
        card_m.load_state_dict(cpu.state_dict())
        x = torch.randn(batch, 3, 32, 32, generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            want, got = cpu.eval()(x), card_m.eval()(x.cuda()).cpu()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        require(err <= EXTRAS_FEAT_TOL * scale,
                f"extras {name}: eval features card vs CPU {err:.3e} of max {scale:.3e}")
        f_cpu, st_cpu, g_cpu = _train_pass(cpu, x)
        f_card, st_card, g_card = _train_pass(card_m, x.cuda())
        ferr = float((f_card - f_cpu).abs().max()) / max(float(f_cpu.abs().max()), 1e-30)
        require(ferr <= EXTRAS_FEAT_TOL, f"extras {name}: train features card vs CPU {ferr:.3e} relative")
        serr = max(float((st_card[k] - v).abs().max()) / max(1.0, float(v.abs().max())) for k, v in st_cpu.items())
        require(serr <= EXTRAS_STAT_TOL, f"extras {name}: running statistics card vs CPU {serr:.3e}")
        g32, g32_at = _grad_gap(g_card, g_cpu)
        state = cpu.state_dict()
        for m in (cpu, card_m):
            m.double().load_state_dict(state)
        g64, g64_at = _grad_gap(_train_pass(card_m, x.double().cuda())[2], _train_pass(cpu, x.double())[2])
        require(g64 <= EXTRAS_GRAD_TOL, f"extras {name}: float64 gradients card vs CPU {g64:.3e} of the norm of "
                f"{g64_at}")
        n_params = sum(p.numel() for p in cpu.parameters())
        log(f"extras {name} ({n_params} parameters), batch {batch}: eval features {err / scale:.3e} of max |CPU|, "
            f"train features {ferr:.3e}, running statistics {serr:.3e}; gradients in float64 {g64:.3e} of their "
            f"norms ({g64_at}); float32 gradients (information) {g32:.3e} ({g32_at})")
        out[name] = {"params": n_params, "features": err / scale, "train_features": ferr, "stats": serr,
                     "grads_float64": g64, "grads_float32": g32}
        del cpu, card_m
    conv_err, unguarded = _conv_backward_gap(ib), _conv_backward_gap(ib, guard=False)
    require(conv_err <= EXTRAS_CONV_TOL, f"extras: a backbone convolution's float32 gradients card vs CPU "
            f"{conv_err:.3e} of max |CPU| with TF32 allowed (its backward must run in full float32)")
    log(f"extras: 3x3 backbone convolutions at WRN-28-2's {len(EXTRAS_CONV_SHAPES)} shapes, batch 8, float32 "
        f"gradients of input and weight card vs CPU with TF32 allowed: worst {conv_err:.3e} of max |CPU| "
        f"({unguarded:.3e} without the backward's guard)")
    out["conv_backward_float32"] = conv_err
    name, batch = EXTRAS_BACKBONES[0]
    model = getattr(ib, name)().cuda().train()
    opt = torch.optim.SGD(model.parameters(), lr=0.03, momentum=0.9)
    x = torch.randn(batch, 3, 32, 32).cuda()

    def step():
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            (model(x) ** 2).mean().backward()
        opt.step()

    step()
    wall = statistics.median(_step_time(step) for _ in range(EXTRAS_RATE_REPS))
    busy = _profile(step, f"extras: {name} train step, batch {batch}", wall)
    out["train_images_per_s"], out["train_busy_ms"], out["train_wall_ms"] = batch / wall, busy, wall * 1e3
    log(f"extras: {name} train step (batch {batch}, SGD) {wall * 1e3:.3f} ms ({batch / wall:.1f} images/s), busy "
        f"{busy} ms ({None if busy is None else round(100 * busy / (wall * 1e3), 1)} %), on {card}")
    return out


def _extras_fusion() -> float:
    """Every MatchingAttention att_type, SimpleAttention and each MMGatedAttention modality subset, card vs CPU."""
    import torch
    from erc_tpu_torch.ops import fusion

    g = torch.Generator().manual_seed(3)
    M, x = torch.randn(32, 40, 200, generator=g), torch.randn(32, 120, generator=g)
    x_dot = torch.randn(32, 200, generator=g)
    mask = (torch.arange(40)[None] < torch.randint(1, 41, (32, 1), generator=g)).float()
    worst = 0.0

    def check(what, mod, *args):
        nonlocal worst
        mod.eval()
        with torch.no_grad():
            want = mod(*args)
            got = mod.cuda()(*(a.cuda() if isinstance(a, torch.Tensor) else a for a in args))
        for w, c in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
            err = float((c.cpu() - w).abs().max()) / max(1.0, float(w.abs().max()))
            require(err <= EXTRAS_FUSION_TOL, f"extras: {what} card vs CPU {err:.3e}")
            worst = max(worst, err)

    check("SimpleAttention", fusion.SimpleAttention(200, generator=g), M, mask)
    for att in ("dot", "general", "general2", "concat"):
        q = x_dot if att == "dot" else x  # 'dot' scores the query against the memory directly
        check(f"MatchingAttention {att}", fusion.MatchingAttention(200, q.shape[1], 64, att, generator=g),
              M, q, mask)
    a, v, t = (torch.randn(32, 200, generator=g) for _ in range(3))
    for modals in ("atv", "av", "at", "vt"):
        check(f"MMGatedAttention {modals}", fusion.MMGatedAttention(200, 100, modals=modals, generator=g),
              a, v, t, modals)
    return worst


def _extras_losses() -> float:
    """The loss zoo, mixup and cutmix_apply given the same draws, card vs CPU."""
    import torch
    from erc_tpu_torch import contrib

    g = torch.Generator().manual_seed(4)
    logits, other = torch.randn(64, 30, 7, generator=g), torch.randn(64, 30, 7, generator=g)
    labels, mask = torch.randint(0, 7, (64, 30), generator=g), (torch.rand(64, 30, generator=g) > 0.3).float()
    soft = torch.softmax(torch.randn(64, 30, 7, generator=g), -1)
    za, zb = torch.randn(128, 64, generator=g), torch.randn(128, 64, generator=g)
    imgs, y = torch.randn(64, 32, 32, 3, generator=g), contrib.onehot(torch.randint(0, 10, (64,), generator=g), 10)
    perm, lam = contrib.mixup_draw(64, 0.75, g)
    cperm, clam, cy, cx = contrib.cutmix_draw(64, 32, 32, 1.0, g)
    cases = {"ce": lambda d: contrib.ce_loss(d(logits), d(labels), d(mask)),
             "ce_soft": lambda d: contrib.ce_loss(d(logits), d(soft)),
             "mse": lambda d: contrib.mse_loss(d(logits), d(other), d(mask)),
             "minent": lambda d: contrib.minent_loss(d(logits), d(mask)),
             "kl": lambda d: contrib.kl_loss(d(logits), d(other)),
             "contrastive": lambda d: contrib.contrastive_loss(d(za), d(zb)),
             "mixup": lambda d: contrib.mixup_apply(d(imgs), d(y), d(perm), d(lam)),
             "cutmix": lambda d: contrib.cutmix_apply(d(imgs), d(y), d(cperm), d(clam), d(cy), d(cx))}
    worst = 0.0
    for name, fn in cases.items():
        want, got = fn(lambda t: t), fn(lambda t: t.cuda())
        for w, c in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
            err = float((c.cpu() - w).abs().max()) / max(1.0, float(w.abs().max()))
            require(err <= EXTRAS_LOSS_TOL, f"extras: {name} card vs CPU {err:.3e}")
            worst = max(worst, err)
    return worst


def drive_extras(card: str) -> dict:
    """Phase 22: the image and training extras (augment_image, image_backbones, ops/fusion, contrib) on the card
    against the CPU port, every count of K1-K4 set to 0 before and read after (no hand-written kernel runs on
    their paths)."""
    t0 = time.perf_counter()
    _reset_launches()
    out = {"augment": _extras_augment(card)}
    with _tf32_allowed():
        out["backbones"] = _extras_backbones(card)
    out["fusion_err"] = _extras_fusion()
    out["loss_err"] = _extras_losses()
    out["launches"] = _no_kernel_launches("extras")
    log(f"extras: fusion modules card vs CPU worst {out['fusion_err']:.3e}, losses, mixup and cutmix "
        f"{out['loss_err']:.3e}; extras phase: {time.perf_counter() - t0:.1f} s")
    return out


def _stamp(phase: str) -> None:
    """Log the phase's end with the runs that its trainers left in the script's experiment root (their count and
    the bytes of their blobs: best models, checkpoints, traces), and drop them."""
    import os
    import shutil

    root = Path(os.environ["ERC_TPU_EXPROOT"])
    runs = sum(1 for d in root.glob("experiment/*/*") if d.is_dir())
    blob = sum(f.stat().st_size for f in root.glob("blob/**/*") if f.is_file())
    log(f"phase {phase} done at {time.perf_counter() - T_START:.1f} s ({runs} runs, {blob / 2 ** 20:.1f} MiB of blobs)")
    for kind in ("experiment", "blob"):
        shutil.rmtree(root / kind, ignore_errors=True)


@contextlib.contextmanager
def _experiment_root():
    """Every trainer's run (experiment directories, best models) under a temporary root, removed at the end; no
    git snapshots (a checkout may have no .git)."""
    import os
    import shutil
    import tempfile

    saved = {k: os.environ.get(k) for k in ("ERC_TPU_EXPROOT", "ERC_TPU_GIT_SNAPSHOT")}
    root = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    os.environ.update(ERC_TPU_EXPROOT=root, ERC_TPU_GIT_SNAPSHOT="0")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    with _experiment_root():
        return _main()


def _main() -> int:
    import torch

    card = probe()
    records = check_kernels()
    dgcn_records = check_dgcn_kernels()
    fn_err = check_band_functions()
    records["dag_block"] = check_dag_block()
    records["dag_block_bwd"] = check_dag_block_bwd()
    _stamp("kernels")
    launches, variants = drive_cogmen(card)
    _stamp("COGMEN serving")
    for name in ("banded_gather_sum", "banded_dot"):
        records[name]["variant_launches"] = {k: n for k, n in variants.items() if k.startswith(name + "/")}
    serve, serve_variants = drive_dagerc(card)
    _stamp("DAG-ERC serving")
    launches["dag_block"] = serve["dag_block"]
    records["dag_block"]["variant_launches"] = {k: n for k, n in serve_variants.items() if k.startswith("dag_block/")}
    train, train_variants = drive_training(card)
    _stamp("DAG-ERC training")
    launches["dag_block_bwd"] = train["dag_block_bwd"]
    records["dag_block"]["train_launches"] = train["dag_block"]
    records["dag_block_bwd"]["variant_launches"] = {k: n for k, n in train_variants.items()
                                                    if k.startswith("dag_block_bwd/")}
    cogmen_train, cogmen_train_variants = drive_cogmen_training(card)
    _stamp("COGMEN training")
    launches["banded_gather_sum_t"] = cogmen_train["banded_gather_sum_t"]
    for name in ("banded_gather_sum", "banded_dot", "banded_gather_sum_t"):
        records[name]["train_launches"] = cogmen_train[name]
        records[name]["train_variant_launches"] = {k: n for k, n in cogmen_train_variants.items()
                                                   if k.startswith(name + "/")}
    for name in ("banded_gather_sum", "banded_dot"):
        records[name]["function_grad_max_abs_err"] = fn_err
    for name, rec in records.items():
        rec["launches"] = launches[name]
    with _cudnn_tf32_on():
        _, _, dgcn_serve_taps = drive_dgcn(card)
        _stamp("DialogueGCN serving")
        _, _, dgcn_train_taps, dgcn_sgd = drive_dgcn_training(card)
        for name, n in dgcn_sgd.items():
            records[name]["sgd_launches"] = n
        _stamp("DialogueGCN training")
        drive_mmgcn(card)
        _stamp("MMGCN serving")
        drive_mmgcn_training(card)
        _stamp("MMGCN training")
        drive_dgcnv2(card)
        _stamp("DialogueGCN v2 serving")
        drive_dgcnv2_training(card)
        _stamp("DialogueGCN v2 training")
        drive_dgcnv2_daily_training(card)
        _stamp("DialogueGCN v2 daily training")
        t_cim = time.perf_counter()
        drive_cim(card)
        _stamp("CIM serving")
        drive_cim_training(card)
        _stamp("CIM training")
        log(f"CIM phases: {time.perf_counter() - t_cim:.1f} s")
        t_mmin = time.perf_counter()
        drive_mmin_training(card)
        _stamp("MMIN training")
        log(f"MMIN phases: {time.perf_counter() - t_mmin:.1f} s")
        drive_precision(card)
        _stamp("precision")
        drive_pipeline(card)
        _stamp("pipeline")
    drive_runtime(card)
    _stamp("runtime")
    ddp = drive_ddp(card)
    _stamp("ddp")
    preprocess = drive_preprocess(card)
    _stamp("preprocess")
    extras = drive_extras(card)
    _stamp("extras")
    # the DialogueGCN-shape records: their instantiation's launches on DialogueGCN's serving and training paths
    for rec in dgcn_records.values():
        rec["launches"] = dgcn_serve_taps[rec["tap_key"]] + dgcn_train_taps[rec["tap_key"]]
    records.update(dgcn_records)
    for name in ("banded_gather_sum", "banded_dot", "banded_gather_sum_t", "dag_block", "dag_block_bwd"):
        records[name]["ddp_launches"] = ddp["launches"].get(name, 0)
        require(records[name]["ddp_launches"] > 0, f"{name} was not launched on the ddp path")
        records[name]["model_axis_launches"] = [r.get(name, 0) for r in ddp["model_axis"]["per_rank"]]
        require(all(records[name]["model_axis_launches"]), f"{name} was not launched in each model-axis rank")
    for rec in records.values():
        rec["preprocess_launches"] = preprocess.get(rec["name"], 0)
        rec["extras_launches"] = extras["launches"].get(rec["name"], 0)
    for name, rec in records.items():
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
