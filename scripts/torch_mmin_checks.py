"""Three readings of the MMIN family's training on one NVIDIA GPU, with
cuDNN's TF32 flag on, as in ``chip_smoke.py``'s MMIN phases.

- ``ema``: each trainer at dropout 0 and ``--ema_alpha=0.5`` on the card and
  on the CPU, 3 steps on the same host batches.  The card's EMA shadow
  against the formula replayed in float32 on the host over the card's own
  weights after each step (what a shadow the card never updates, or updates
  with the wrong alpha, would fail), how far the shadow moved, the card's
  shadow and weights against the CPU's, and the shadow that the published
  alpha 0.999 would give, replayed from each device's weights.
- ``tie``: ``mmin_miss2``'s first-batch gradients card vs CPU at dropout 0 for
  seeds 1-3, on the batch as it is and on the same batch with every all-zero
  frame (the padded audio tail, the dropped modalities of the features and of
  ``*_reverse``) filled with noise, beside the number of (row, unit) pairs
  whose max over time the card and the CPU take at different steps in the
  LSTM encoders' maxpool readouts.
- ``lstm``: ``BiRNN`` run over every padded step in its two forms, masked
  by a mask of ones and unpacked (no mask), at MMGCN's, DialogueGCN v2's and
  MMIN's shapes: forward and backward time (CUDA events, median of
  interleaved repeats) and the largest difference of outputs and gradients.

    python scripts/torch_mmin_checks.py [ema|tie|lstm ...]   # all by default
"""

import importlib
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from erc_tpu_torch.data.loader import to_device  # noqa: E402
from erc_tpu_torch.ops.dropout import Dropout  # noqa: E402
from erc_tpu_torch.ops.rnn import BiRNN  # noqa: E402

TRAINERS = {"mmin_base": "MMINBaseTrainer", "mmin_miss": "MMINMissTrainer", "mmin_miss2": "MMINMiss2Trainer"}


def _trainer(module, device, *extra):
    mod = importlib.import_module(f"erc_tpu_torch.models.{module}")
    p = mod.ParamsType()
    p.finalize(["--dataset=synthetic-mmin-4", "--confusion_matrix=false", f"--device={device}", "--epoch=1", *extra])
    t = getattr(mod, TRAINERS[module])(p)
    t.log = lambda msg: None
    t.initialize()
    for m in t.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return t


def _weights(t):
    return [w.detach().to("cpu", copy=True) for w in t.model.parameters()]


def _replay(start, steps, alpha):
    """The EMA of mmin_base.py's update_ema, in float32 on the host, in its order of operations."""
    e = [w.clone() for w in start]
    for ws in steps:
        e = [x * alpha + w * (1 - alpha) for x, w in zip(e, ws, strict=True)]
    return e


def _max_abs(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b, strict=True))


def ema() -> None:
    for module in TRAINERS:
        card, cpu = (_trainer(module, d, "--ema_alpha=0.5") for d in ("cuda", "cpu"))
        host = list(card.make_loader("train"))[:3]
        start_card, start_cpu = _weights(card), _weights(cpu)
        steps_card, steps_cpu = [], []
        for b in host:
            card.train_step(to_device(b, card.device))
            cpu.train_step(to_device(b, cpu.device))
            steps_card.append(_weights(card))
            steps_cpu.append(_weights(cpu))
        shadow_card = [e.detach().cpu() for e in card.ema_model.parameters()]
        shadow_cpu = [e.detach().clone() for e in cpu.ema_model.parameters()]
        want = _replay(start_card, steps_card, 0.5)
        lr = float(card.params.optim.lr)
        flips = sum(int(((a - b).abs() > lr).sum()) for a, b in zip(steps_card[-1], steps_cpu[-1], strict=True))
        pub = _max_abs(_replay(start_card, steps_card, 0.999), _replay(start_cpu, steps_cpu, 0.999))
        print(f"ema {module}: alpha 0.5, card shadow vs the replay over the card's weights max abs "
              f"{_max_abs(shadow_card, want):.3e}; the shadow moved max abs {_max_abs(want, start_card):.3e}; "
              f"card vs CPU shadow max abs {_max_abs(shadow_card, shadow_cpu):.3e}, weights max abs "
              f"{_max_abs(steps_card[-1], steps_cpu[-1]):.3e} ({flips} elements apart by more than lr {lr}); "
              f"at alpha 0.999 (replayed) card vs CPU shadow max abs {pub:.3e}", flush=True)


def _fill_zero_frames(batch, seed):
    """The batch with every all-zero frame of the audio, visual and text features (and their *_reverse) filled
    with N(0, 0.1) noise."""
    rng = np.random.default_rng(seed)
    out = dict(batch)
    for key, x in batch.items():
        if key.split("_")[0] in ("audio", "visual", "text") and "feature" in key:
            x = np.array(x, copy=True)
            zero = ~np.any(x != 0, axis=-1)
            x[zero] = rng.normal(0.0, 0.1, (int(zero.sum()), x.shape[-1])).astype(x.dtype)
            out[key] = x
    return out


def _grad_gaps(card, cpu):
    """Per parameter ||g_card - g_cpu|| / max(||g_cpu||, 1e-4 global norm), as chip_smoke's _worst_grad_diff."""
    pairs = [(n, a.grad.double().cpu(), b.grad.double()) for (n, a), b in
             zip(card.model.named_parameters(), cpu.model.parameters(), strict=True)]
    total = float(torch.sqrt(sum((b ** 2).sum() for _, _, b in pairs)))
    return {n: float((a - b).norm()) / max(float(b.norm()), 1e-4 * total) for n, a, b in pairs}


def _readout_hooks(trainer, store):
    from erc_tpu_torch.models.mmin_models import LSTMEncoder

    hooks = []
    for name, m in trainer.model.named_modules():
        if isinstance(m, LSTMEncoder) and m.embd_method == "maxpool":
            hooks.append(m.rnn.register_forward_hook(
                lambda _m, _i, out, name=name: store.__setitem__(name, out.detach().cpu())))
    return hooks


def tie() -> None:
    for seed in (1, 2, 3):
        card, cpu = (_trainer("mmin_miss2", d, f"--seed={seed}") for d in ("cuda", "cpu"))
        host = next(iter(card.make_loader("train")))
        for form, batch in (("as is", host), ("zero frames filled", _fill_zero_frames(host, seed))):
            outs = ({}, {})
            hooks = _readout_hooks(card, outs[0]) + _readout_hooks(cpu, outs[1])
            card.compute_grads(to_device(batch, card.device))
            cpu.compute_grads(to_device(batch, cpu.device))
            for h in hooks:
                h.remove()
            gaps = _grad_gaps(card, cpu)
            worst = max(gaps, key=gaps.get)
            moved = {name: int((outs[0][name].argmax(1) != outs[1][name].argmax(1)).sum()) for name in outs[1]}
            leaf = "netB.netA.rnn.layers.0.weight_hh_l0"
            print(f"tie mmin_miss2 seed {seed}, {form}: worst gradient gap {gaps[worst]:.3e} ({worst}); {leaf} "
                  f"{gaps.get(leaf, float('nan')):.3e}; maxpool argmax card != CPU in (row, unit) pairs {moved}",
                  flush=True)


def _time_pair(fns, reps=30):
    times = {k: [] for k in fns}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        for f in fns.values():
            f()
    for _ in range(reps):
        for k, f in fns.items():
            start.record()
            f()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in times.items()}


def lstm() -> None:
    shapes = [("MMGCN text biLSTM", 16, 110, 200, 100, 2, True),
              ("DialogueGCN v2 biLSTM", 32, 110, 712, 100, 2, True),
              ("MMIN audio LSTM", 32, 128, 130, 128, 1, False),
              ("MMIN visual LSTM", 32, 50, 342, 128, 1, False)]
    for name, B, L, D, H, layers, bi in shapes:
        gen = torch.Generator().manual_seed(0)
        rnn = BiRNN(D, H, num_layers=layers, bidirectional=bi, generator=gen, device="cuda")
        x = torch.randn(B, L, D, generator=gen).cuda().requires_grad_()
        g = torch.randn(B, L, (2 if bi else 1) * H, generator=gen).cuda()
        ones = torch.ones(B, L, device="cuda")
        forms = {"masked, mask of ones": lambda: rnn(x, ones), "unpacked": lambda: rnn(x)}
        res = {}
        for k, f in forms.items():
            x.grad = None
            rnn.zero_grad(set_to_none=True)
            out = f()
            out.backward(g)
            res[k] = [out.detach(), x.grad.clone(), *(p.grad.clone() for p in rnn.parameters())]
        diff = _max_abs(*res.values())

        def step(f):
            out = f()
            torch.autograd.grad(out, [x, *rnn.parameters()], g)

        ms = _time_pair({k: (lambda f=f: step(f)) for k, f in forms.items()})
        print(f"lstm {name} (B {B}, L {L}, D {D}, H {H}, {layers} layer(s), {'bi' if bi else 'one'}-directional): "
              f"forward + backward median ms {ms}; outputs and gradients max abs diff {diff:.3e}", flush=True)


def main(argv) -> int:
    torch.backends.cudnn.allow_tf32 = True
    print(torch.cuda.get_device_name(0), flush=True)
    for what in argv or ["ema", "tie", "lstm"]:
        {"ema": ema, "tie": tie, "lstm": lstm}[what]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
