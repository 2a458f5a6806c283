"""Two measurements of DialogueGCN v2's training on one NVIDIA GPU.

- ``conv``: the token track's train step (DGCNV2DailyParams at full width,
  batch 32, L 128, 50 words) with cuDNN choosing the TextCNN's convolution
  algorithms by its heuristics and with ``torch.backends.cudnn.benchmark``
  on, each in a process of its own (cuDNN caches a plan once chosen, so a
  later trainer in the same process would take the benchmarked one).
- ``memory``: the peak device memory of one forward and backward of the
  feature track's longest training batch (batch 32, max_seq_len 96) with
  the DialogueRNN base against the biLSTM base, above what the model and
  its gradients hold: the DialogueRNN loop saves each step's history of
  global states for the backward.

cuDNN's TF32 flag is on, as in ``chip_smoke.py``'s DialogueGCN v2 phases.

    python scripts/torch_dgcnv2_steps.py [conv|memory]   # both by default
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from erc_tpu_torch.data.loader import to_device  # noqa: E402
from erc_tpu_torch.models import dgcnv2  # noqa: E402


def _trainer(daily: bool, *extra):
    p = dgcnv2.DGCNV2DailyParams() if daily else dgcnv2.DGCNV2Params()
    dataset = "synthetic-daily-token-7" if daily else "synthetic-cogmen-6"
    p.finalize([f"--dataset={dataset}", "--device=cuda", "--epoch=1", *extra])
    t = (dgcnv2.DGCNV2DailyTrainer if daily else dgcnv2.DGCNV2Trainer)(p)
    t.log = lambda msg: None
    t.initialize()
    return t


def conv_step(benchmark: bool) -> None:
    torch.backends.cudnn.benchmark = benchmark
    t = _trainer(True, "--synthetic_n_train=32")
    batch = to_device(next(iter(t.make_loader("train"))), t.device)
    for _ in range(3):
        t.train_step(batch)
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"token-track train step, cudnn.benchmark={benchmark}: median {statistics.median(times):.3f} ms "
          f"(min {min(times):.3f}, max {max(times):.3f}, 7 steps)", flush=True)


def memory() -> None:
    for base in ("DialogRNN", "LSTM"):
        t = _trainer(False, f"--base_model={base}", "--max_seq_len=96")
        host = max(t.make_loader("train"), key=lambda b: b["input_tensor"].shape[1])
        batch = to_device(host, t.device)
        t.compute_grads(batch)  # gradients allocated, cuBLAS and cuDNN set up
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t.compute_grads(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_bytes
        print(f"feature track, base {base}, batch {batch['input_tensor'].shape[0]} x L "
              f"{batch['input_tensor'].shape[1]}: forward and backward peak {peak / 2**20:.1f} MiB above the "
              f"model and its gradients ({base_bytes / 2**20:.1f} MiB)", flush=True)
        del t, batch
        torch.cuda.empty_cache()


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU with CUDA")
    torch.backends.cudnn.allow_tf32 = True
    what = argv[:1] or ["conv", "memory"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    if what[0] == "conv-one":
        conv_step(argv[1] == "benchmark")
        return 0
    if "conv" in what:
        for mode in ("heuristics", "benchmark", "heuristics", "benchmark"):
            subprocess.run([sys.executable, __file__, "conv-one", mode], check=True)
    if "memory" in what:
        memory()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
