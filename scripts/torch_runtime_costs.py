"""What the trainer's runtime costs, piece by piece, on one NVIDIA GPU: COGMEN
banded at ``chip_smoke.py``'s full-width training settings (10 117 874
parameters, batch 32 × 96).

- ``construct``: ``COGMENTrainer(params)`` (the experiment directories,
  ``record_start``, the logger's file, the metric stores), and
  ``record_start`` alone, median of ``--repeats``;
- ``save_best``: ``save_model("best", is_best=True)`` (``model.best.ckpt``
  with the optimizer's state, then its copy ``best.model.ckpt``), median,
  with the two files' bytes;
- ``test``: ``test()`` with the best model's save (``best_f1`` set to -inf
  first) and without it (+inf), in turn, median;
- ``per_step``: what ``train()`` adds to each step, ``Record.record`` of the
  step's device metrics and ``_fire("train_step_end")`` through the default
  callbacks, mean over ``--steps`` calls;
- ``heartbeat``: ``--steps`` replayed steps with the heartbeat thread
  running and without it, in turn, median of ``--repeats``;
- ``epochs``: ``train()`` of a fresh trainer over 3 epochs of
  ``chip_smoke.py``'s COGMEN epoch (120 dialogues, 4 steps), with the test
  stages' best-model saves, with ``save_model`` stubbed out, and bare (no
  saves, no heartbeat, no progress line), in turn, ``--repeats`` rounds: the train steps' dialogues/s of each epoch (the
  first captures its buckets), to show whether a save slows the host-bound
  epoch after it.

    python scripts/torch_runtime_costs.py [--repeats 5] [--steps 200]

Prints one JSON object, the card's name and power limit among its keys.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _median_s(fn, n):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--steps", type=int, default=200)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from erc_tpu_torch.core.experiment import card_line
    from erc_tpu_torch.core.meter import Meter, Record
    from erc_tpu_torch.models import cogmen

    res = {"card": card_line(), "repeats": a.repeats, "steps": a.steps}
    with chip_smoke._experiment_root():
        tr = chip_smoke._cogmen_trainer("banded", "--batch_count=4", "--length_bucket=96")
        tr.log = lambda msg: None
        p = tr.params
        res["construct_s"] = _median_s(lambda: cogmen.COGMENTrainer(p), a.repeats)
        res["record_start_s"] = _median_s(lambda: tr.exp.record_start(tr.device), a.repeats)

        host = next(iter(tr.make_loader("train")))
        for _ in range(3):  # the bucket's eager step and its capture, then replays
            mets = tr.train_batch(host)
        res["save_best_s"] = _median_s(lambda: tr.save_model("best", is_best=True), a.repeats)
        res["save_best_bytes"] = {f: Path(tr.saver.save_dir, f).stat().st_size
                                  for f in ("model.best.ckpt", "best.model.ckpt")}

        def test_with(best):
            tr.best_f1 = best
            tr.test()

        tr.test()  # the test stage's captures
        with_save, without = [], []
        for _ in range(a.repeats):
            with_save.append(_median_s(lambda: test_with(float("-inf")), 1))
            without.append(_median_s(lambda: test_with(float("inf")), 1))
        res["test_with_save_s"], res["test_without_save_s"] = statistics.median(with_save), statistics.median(without)

        tr.icallbacks(p)  # the default set: StopByCode, KeyErrorSave, FinalReport
        record = Record("train")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for bidx in range(a.steps):
            record.record(Meter().update(mets))
            tr._fire("train_step_end", bidx, mets)
        res["per_step_us"] = (time.perf_counter() - t0) / a.steps * 1e6
        res["callbacks"] = [type(cb).__name__ for cb in tr.callbacks]

        def steps():
            for _ in range(a.steps):
                tr.train_batch(host)

        on, off = [], []
        for _ in range(a.repeats):
            hb = tr.exp.start_heartbeat()
            on.append(_median_s(steps, 1))
            hb.stop()
            off.append(_median_s(steps, 1))
        res["steps_heartbeat_on_s"], res["steps_heartbeat_off_s"] = statistics.median(on), statistics.median(off)
        del tr

        epochs = {"saves": [], "no saves": [], "bare": []}
        for _ in range(a.repeats):
            for mode, rates in epochs.items():
                run = chip_smoke._cogmen_trainer("banded")
                run.log = lambda msg: None
                run.params.epoch = 3
                if mode != "saves":
                    run.save_model = lambda *args, **kw: None
                if mode == "bare":
                    run.params.heartbeat = False
                    run.logger.inline = lambda *args, **kw: None  # on the singleton: undone below
                rates.append([h["dialogues"] / h["seconds"] for h in run.train()])
                run.logger.__dict__.pop("inline", None)
                del run
        res["epoch_dps"] = epochs
        res["epoch_dps_median"] = {mode: [statistics.median(r[e] for r in rates) for e in range(3)]
                                   for mode, rates in epochs.items()}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
