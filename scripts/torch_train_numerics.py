"""The numerics behind the captured train step's design, on one NVIDIA GPU.

    python scripts/torch_train_numerics.py [layout|relu|conv|bf16 ...]   # all by default

- ``layout``: a 2-layer biLSTM of 100 a direction (``ops.rnn.BiRNN``'s masked
  form) over B 32, L 96, D 712 with ragged lengths, cuDNN in full float32:
  outputs and input/weight gradients against the CPU, with cuDNN given the
  padded layout (what ``BiRNN`` runs without autograd), a ``PackedSequence``
  of full-length rows (what it runs under autograd) and rows packed by their
  real lengths; forward + backward milliseconds of each (CUDA events, median
  of 10 after 3 warm-ups).
- ``relu``: DialogueGCN at ``chip_smoke.py``'s training settings and dropout
  0, each batch of an epoch: card vs CPU gradients (worst over parameters of
  the difference over the parameter's gradient norm) and the number of ReLU
  inputs (``torch.relu``, ``F.leaky_relu``) whose sign differs between the
  two devices' forwards.
- ``conv``: the token track's TextCNN convolutions (50 filters of widths 3,
  4, 5 over 50 words of 300, 4 096 utterances) through cuDNN's heuristics
  and through ``ops.conv.conv1d_gemm``: forward + backward milliseconds and
  the largest difference of the weight gradients between two runs of each.
- ``bf16``: every configuration of ``chip_smoke.py``'s precision phase at
  dropout 0, one batch cut to 4 rows and to 32, from one set of weights: per parameter
  the card's bfloat16 gradient's gap to the CPU's (``chip_smoke._bf16_gaps``,
  the CPU run the reference), and the same with cuDNN off on the card and
  with the CPU's bfloat16 run without oneDNN in the card's place (a second
  sound implementation).  For each, the factor K that the largest gap needs
  in ``K · (5e-2 + the reference's own bfloat16 error)``, the ReLU inputs
  whose sign differs from the reference's forward, the median ratio of the
  two runs' own errors, and how many parameters
  ``chip_smoke._bf16_tolerance`` fails in the sound run and under two
  planted faults (the card's float32 gradients as its bfloat16 ones, one
  gradient scaled by 1.25).
"""

import contextlib
import copy
import statistics
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from erc_tpu_torch.data.loader import to_device  # noqa: E402
from erc_tpu_torch.ops import rnn as trnn  # noqa: E402
from erc_tpu_torch.ops.conv import conv1d_gemm  # noqa: E402


def _median_ms(fn, reps=10):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _padded(layer, inp):
    with trnn.cudnn_rnn_full_fp32():
        out, state = layer(inp)
    if out.requires_grad and out.is_cuda:
        trnn._backward_in_full_fp32(out)
    return out, state


def _full_packed(layer, inp):
    B, L = inp.shape[:2]
    packed = PackedSequence(inp.transpose(0, 1).reshape(L * B, -1), torch.full((L,), B, dtype=torch.int64))
    with trnn.cudnn_rnn_full_fp32():
        out, state = layer(packed)
    if out.data.requires_grad:
        trnn._backward_in_full_fp32(out.data)
    return out.data.reshape(L, B, -1).transpose(0, 1), state


def _packed_by_lengths(rnn, x, mask):
    p = pack_padded_sequence(x, mask.sum(-1).long().cpu().clamp(min=1), batch_first=True, enforce_sorted=False)
    for layer in rnn.layers:
        with trnn.cudnn_rnn_full_fp32():
            p, _ = layer(p)
        if p.data.requires_grad:
            trnn._backward_in_full_fp32(p.data)
    y, _ = pad_packed_sequence(p, batch_first=True, total_length=x.shape[1])
    return y * mask[..., None]


def _fwd_bwd(rnn, x, mask, g, form):
    """Outputs and gradients (input, then each weight) of one forward and backward of `rnn` in `form`."""
    rnn.zero_grad(set_to_none=True)
    xx = x.clone().requires_grad_()
    run = {"padded": _padded, "full-length packed": _full_packed}.get(form)
    with torch.enable_grad():
        if run is None:
            out = _packed_by_lengths(rnn, xx, mask)
        else:
            plain, trnn.BiRNN._run = trnn.BiRNN.__dict__["_run"], staticmethod(run)
            try:
                out = rnn(xx, mask)
            finally:
                trnn.BiRNN._run = plain
        (out * g).sum().backward()
    return [out.detach().double().cpu(), xx.grad.double().cpu(), *(p.grad.double().cpu() for p in rnn.parameters())]


def layout() -> None:
    gen = torch.Generator().manual_seed(0)
    B, L, D, H = 32, 96, 712, 100
    lengths = torch.randint(5, L + 1, (B,), generator=gen)
    lengths[-3:] = 0
    mask = (torch.arange(L)[None] < lengths[:, None]).float()
    x = torch.randn(B, L, D, generator=gen) * mask[..., None]
    g = torch.randn(B, L, 2 * H, generator=gen) * mask[..., None]
    rnn = trnn.BiRNN(D, H, num_layers=2, generator=gen).train()
    want = _fwd_bwd(copy.deepcopy(rnn), x, mask, g, "padded")  # the CPU takes no layout
    card = copy.deepcopy(rnn).cuda()
    xc, mc, gc = x.cuda(), mask.cuda(), g.cuda()
    for form in ("padded", "full-length packed", "packed by lengths"):
        got = _fwd_bwd(card, xc, mc, gc, form)
        out_diff = float((got[0] - want[0]).abs().max())
        grad_rel = max(float((a - b).norm() / b.norm()) for a, b in zip(got[1:], want[1:]))
        ms = _median_ms(lambda: _fwd_bwd(card, xc, mc, gc, form))
        print(f"layout {form}: outputs vs the CPU max abs {out_diff:.3e}; gradients worst relative {grad_rel:.3e}; "
              f"forward + backward {ms:.3f} ms", flush=True)


@contextlib.contextmanager
def _relu_inputs(signs):
    """Within the block torch.relu and F.leaky_relu append the sign pattern of their inputs to `signs`."""
    relu, leaky = torch.relu, F.leaky_relu

    def recorded_relu(x):
        signs.append((x > 0).cpu())
        return relu(x)

    def recorded_leaky(x, negative_slope=0.01, inplace=False):
        signs.append((x > 0).cpu())
        return leaky(x, negative_slope, inplace)

    torch.relu, F.leaky_relu = recorded_relu, recorded_leaky
    try:
        yield
    finally:
        torch.relu, F.leaky_relu = relu, leaky


def relu() -> None:
    with cs._cudnn_tf32_on():
        card0, cpu0 = cs._dgcn_trainer(dropout=0.0), cs._dgcn_trainer(device="cpu", dropout=0.0)
        for i, b in enumerate(card0.make_loader("train")):
            on_card, on_cpu = [], []
            with _relu_inputs(on_card):
                card0.compute_grads(to_device(b, card0.device))
            with _relu_inputs(on_cpu):
                cpu0.compute_grads(to_device(b, torch.device("cpu")))
            worst, name = cs._worst_grad_diff(card0.model, cpu0.model)
            flips = sum(int((a != c).sum()) for a, c in zip(on_card, on_cpu, strict=True))
            print(f"relu batch {i} (L {b['attention_mask'].shape[1]}): card vs CPU gradients worst {worst:.3e} "
                  f"({name}); ReLU inputs of another sign {flips}", flush=True)


def conv() -> None:
    gen = torch.Generator().manual_seed(0)
    convs = [torch.nn.Conv1d(300, 50, k).cuda() for k in (3, 4, 5)]
    x = torch.randn(4096, 50, 300, generator=gen).cuda()
    cots = [torch.randn(4096, 50 - k + 1, 50, generator=gen).cuda() for k in (3, 4, 5)]

    def step(gemm):
        for c in convs:
            c.zero_grad(set_to_none=True)
        xx = x.clone().requires_grad_()
        with torch.enable_grad(), trnn.cudnn_full_fp32(torch.backends.cudnn.conv):
            outs = conv1d_gemm(xx, convs) if gemm else [c(xx.transpose(1, 2)).transpose(1, 2) for c in convs]
            sum((o * t).sum() for o, t in zip(outs, cots)).backward()
        return [c.weight.grad.clone() for c in convs]

    for gemm in (False, True):
        a, b = step(gemm), step(gemm)
        spread = max(float((u - v).abs().max()) for u, v in zip(a, b))
        ms = _median_ms(lambda: step(gemm))
        print(f"conv {'conv1d_gemm' if gemm else 'cuDNN heuristics'}: forward + backward {ms:.3f} ms; two runs' "
              f"weight gradients max abs diff {spread:.3e}", flush=True)


def _bf16_summary(label, rows, flips):
    """One line: the factor the largest gap needs, and where; the own errors' median ratio; what the rule fails;
    the ReLU inputs of another sign than the reference's."""
    need = max(rows, key=lambda r: r[1] / (cs.CPU_GRAD_TOL + r[2]))
    ratio = statistics.median(r[3] / max(r[2], 1e-12) for r in rows)
    over = [sum(r[i] > cs._bf16_tolerance(r[2]) for r in rows) for i in (1, 4, 5)]
    worst = sorted(rows, key=lambda r: -r[1] / (cs.CPU_GRAD_TOL + r[2]))[:3]
    print(f"  {label}: factor needed {need[1] / (cs.CPU_GRAD_TOL + need[2]):.3f} at {need[0]}; ReLU inputs of "
          f"another sign than the reference's {flips}; own errors, this run / the reference's, median {ratio:.3f}; "
          f"over the tolerance: sound {over[0]}, float32 in place of "
          f"bfloat16 {over[1]}, scaled by 1.25 {over[2]}, of {len(rows)}; worst "
          + "; ".join(f"{n} gap {g:.3e} own reference {c:.3e} own {o:.3e}" for n, g, c, o, *_ in worst), flush=True)


def bf16() -> None:
    def grads(run, batch, signs):
        with _relu_inputs(signs):
            return cs._grads(run, batch)[1]

    def flips(a, b):
        return sum(int((x != y).sum()) for x, y in zip(a, b, strict=True))

    with cs._cudnn_tf32_on():
        for name, make, _, _ in cs._precision_configs():
            card16, card32 = make("--compute_dtype=bfloat16", d=True), make(d=True)
            runs = cs._bf16_runs(make, card16, card32)
            for n_rows in (4, 32):
                batch = cs._rows(next(iter(card16.make_loader("train"))), n_rows)
                signs = {k: [] for k in runs}
                g = {k: grads(t, batch, signs[k]) for k, t in runs.items()}
                rows, under, f32 = cs._bf16_gaps(g)
                print(f"bf16 {name} on {n_rows} rows: {len(rows)} gradients over the floor, {len(under)} under it "
                      f"(the card's largest {max((u for _, u in under), default=0.0):.3e} of the floor); float32 card "
                      f"vs CPU {f32:.3e}, ReLU inputs of another sign {flips(signs['card32'], signs['cpu32'])} of "
                      f"{sum(x.numel() for x in signs['cpu32'])}", flush=True)
                _bf16_summary("the card", rows, flips(signs["card16"], signs["cpu16"]))
                no_cudnn = []
                with torch.backends.cudnn.flags(enabled=False):
                    g_no = grads(card16, batch, no_cudnn)
                _bf16_summary("the card without cuDNN", cs._bf16_gaps({**g, "card16": g_no})[0],
                              flips(no_cudnn, signs["cpu16"]))
                native = []
                with torch.backends.mkldnn.flags(enabled=False):
                    g_native = grads(runs["cpu16"], batch, native)
                _bf16_summary("the CPU without oneDNN as the card",
                              cs._bf16_gaps({**g, "card16": g_native, "card32": g["cpu32"]})[0],
                              flips(native, signs["cpu16"]))


def main(argv) -> int:
    print(cs.probe(), flush=True)  # builds the kernels (DialogueGCN's banded graph needs them)
    for what in argv or ["layout", "relu", "conv", "bf16"]:
        {"layout": layout, "relu": relu, "conv": conv, "bf16": bf16}[what]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
