"""A training cell: the port's trainer fed by its own loader pipeline,
steps back to back through ``Trainer.train_batch`` (on the card, the replay
of the step captured for each batch shape).

Set-up builds the trainer, loads the benchmark's weights, and trains two
epochs: each shape's first batch trains eagerly and is captured, and each
graph is replayed once.  It then puts every tensor the step updates back to
its initial value, in place (the graphs keep their addresses), and trains
the three steps that the comparison reads, through the same call and feed.
The window goes on from there: the same trainer, the same feed, many
epochs.  With ``--trace 1`` two more epochs are traced after the window.
"""

from __future__ import annotations

import functools
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.core import check, manifest, program, traffic, weights
from perfbench.core.context import Run
from perfbench.core.trace import traced

COMPARED_STEPS = 3


class Feed:
    """The loader pipeline, epoch after epoch, as ``Trainer.train`` runs it."""

    def __init__(self, loader):
        self.loader, self.epoch, self.it = loader, 0, None

    def __len__(self):
        return len(self.loader)

    def next(self) -> Dict[str, np.ndarray]:
        while True:
            if self.it is None:
                self.loader.set_epoch(self.epoch)
                self.it = iter(self.loader)
            try:
                item = next(self.it)
            except StopIteration:
                self.it = None
                self.epoch += 1
                continue
            return item[0] if isinstance(item, tuple) else item

    def close(self) -> None:
        if self.it is not None:
            self.it.close()  # stops and joins the prefetch thread
            self.it = None


def _restore(t, w: Dict[str, torch.Tensor]) -> None:
    """Every tensor the step updates back to its initial value, in place:
    parameters and buffers to the benchmark's weights, gradients and the
    optimizer's state (moments, step counts) to zero."""
    with torch.no_grad():
        for n, p in t.model.named_parameters():
            p.copy_(w[n])
            if p.grad is not None:
                p.grad.zero_()
        for n, b in t.model.named_buffers():
            b.copy_(w[n])
        for st in t.optimizer.state.values():
            for v in st.values():
                if isinstance(v, torch.Tensor):
                    v.zero_()


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(v.double())) for n, v in tensors.items()}


def run(r: Run) -> None:
    dev = torch.device(r.device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    ref = manifest.reference(r.cell["config"])
    with r.spans("setup.data"):
        r.data = traffic.dialogues(r.mix["corpus"], r.seed)
        index = {d["text"][0].tobytes(): i for i, d in enumerate(r.data)}

    def ids(host_batch) -> List[int]:
        return [index[host_batch["text_feature"][row, 0].tobytes()] for row in program.real_rows(host_batch)]

    with r.spans("setup.build"):
        t = program.trainer(r.cfg, r.seed % (1 << 63), r.device)
        w = weights.make({**ref.param_specs(r.model), **ref.buffer_specs(r.model)}, r.seed, dev)
        t.model.load_state_dict(w, strict=True)
        r.extra["weights"] = w
        feed = Feed(program.train_loader(t, r.data))
    try:
        with r.spans("setup.warmup"):
            for _ in range(2 * len(feed)):
                t.train_batch(feed.next())
            sync()
            _restore(t, w)
        beta1 = float(r.cfg["train"]["optim"]["betas"][0])
        compared, losses = [], []
        with r.spans("setup.compared"):
            for k in range(COMPARED_STEPS):
                hb = feed.next()
                compared.append(ids(hb))
                losses.append(float(t.train_batch(hb)["Lall"]))
                if k == 0:  # Adam's first moment after one step is (1 - beta1) times the gradient it took
                    grads = {n: t.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p)) / (1.0 - beta1)
                             for n, p in t.model.named_parameters()}
                    r.readings["grad_norms"] = _norms(grads)
            r.readings["change"] = {n: (p.detach() - w[n]).cpu() for n, p in t.model.named_parameters()}
            r.readings["losses"] = losses
            r.readings["batches"] = compared
            sync()
        r.setup_s = time.perf_counter() - r.extra["t_process"]

        steps = 0
        trained = np.zeros(len(r.data), np.int64)  # times each dialogue was trained in the window
        t0 = time.perf_counter()
        while True:
            with r.spans("loader.next"):
                hb = feed.next()
            with r.spans("train_batch"):
                t.train_batch(hb)
            trained[ids(hb)] += 1
            steps += 1
            if time.perf_counter() - t0 >= r.seconds:
                break
        sync()
        t1 = time.perf_counter()
        r.window = {"start": t0, "end": t1, "steps": steps, "dialogues": int(trained.sum()), "trained": trained}

        if r.traced:
            segment: List[List[int]] = []

            def steps_traced():
                for _ in range(int(r.mix.get("trace_epochs", 2)) * len(feed)):
                    with r.spans("loader.next"):
                        hb = feed.next()
                    with r.spans("train_batch"):
                        t.train_batch(hb)
                    segment.append(ids(hb))

            r.trace = traced(steps_traced, r.spans, dev)
            r.segment = segment
        r.extra["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
        r.extra["attempted"], r.extra["failed"] = steps + len(r.segment), 0
    finally:
        feed.close()
    del t, feed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def compare(r: Run, precision=None, mm=None) -> Dict[str, float]:
    """``check``'s numbers: the reference's first steps on the run's compared
    batches, from the benchmark's weights, against the program's readings."""
    ref = manifest.reference(r.cell["config"])
    plain = ref.plain
    w = r.extra["weights"]
    params = {n: w[n] for n in ref.param_specs(r.model)}
    buffers = {n: w[n] for n in ref.buffer_specs(r.model)}
    dev = torch.device(r.device)
    forward = functools.partial(ref.forward, m=r.model)
    with (precision or plain.strict_float32)():
        batches = [plain.batch([r.data[i] for i in ids], r.model["modality"], dev) for ids in r.readings["batches"]]
        got = plain.train_readings(forward, params, buffers, batches, r.cfg["train"]["optim"], mm or plain.mm,
                                   target=r.readings["grad_norms"])
    r.extra.setdefault("detail", {}).update(check.train_detail(r.readings, got))
    return check.train_numbers(r.readings, got)
