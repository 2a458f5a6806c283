"""The train loop.

Port of the core of ``erc_tpu.train.trainer.Trainer``: build the model and
optimizer (``imodels``), the train step (loss, gradients, their global norm
before the clip, optax's clip, the optimizer step), the epoch loop with
``batch_count`` and ``log_every``, the val stage (``evaluate``: on datasets
with a real val split, before each test stage) and the test stage (masked
NLL and the classification summary on the host), ``--select_on=test|val``,
the plateau controller on the test or val loss (``plateau_source``), with
logging to stdout, and checkpoints through the port's ``Saver``
(``train/checkpoint.py``) into ``--save_dir`` (default
``~/.erc_tpu_torch/saver/<module>/<dataset>``): ``save_model``, a rotating
checkpoint every ``--checkpoint_per_epoch`` epochs (the best epoch's by test
F1, or by val F1 with ``--select_on=val``, also as ``best.checkpoint.ckpt``),
``model.best_val.ckpt`` with ``--select_on=val``, a keypoint every
``--keypoint_per_epoch`` epochs, and ``--resume`` from the newest readable
rotating checkpoint, as the JAX package's callbacks of those names do.  A
subclass sets ``model``, ``optimizer`` and, where it wants them,
``grad_clip_norm`` and ``lr_sche``; it may override ``to_logits`` (the eval
forward; a tuple of outputs is fine, ``test_step_collect`` then gets a
tuple of arrays), the hooks ``on_eval_begin``, ``on_eval_end(res)``,
``on_test_begin`` and ``on_test_end(res)``, called where the JAX trainer
fires them, and ``state_tree``/``load_state_tree`` to carry state of its
own (MMIN's EMA shadow) in checkpoints.  Batches are of dialogues
(``text_length``) or of utterances (``sample_mask``, MMIN): a record's
``dialogues`` counts the rows that are not padding either way.

The train step is ``_step``: forward, backward, the gradients' global norm
before the clip, optax's clip, the optimizer step and ``after_step`` (MMIN's
EMA shadow), every state update in place, each parameter's ``.grad``
allocated once and zeroed in the step.  On the card ``train()`` replays it
as one CUDA graph per batch shape (``core.cuda_graphs.CapturedStep``: the
JAX trainer's train step, jitted once per shape bucket), the first batch of
each shape trained eagerly before its capture; the LR is then a 0-d tensor
on the card (``train.optim.build_optim``), which the plateau controller
writes in place.  The val and test stages replay the eval forward
(``to_logits``) the same way (``CapturedForward``).  ``train_graphs =
False`` and ``eval_graphs = False`` run them eagerly.  ``load_state_tree``
drops the graphs, and a replay raises where a tensor it reads was replaced
rather than written in place.

The trainer runs on ``params.device`` (the card unless it is ``"cpu"``),
with the JAX trainer's precision knobs (``core.precision``):

- ``--compute_dtype=bfloat16``: the train step's forward and backward run on
  bfloat16 copies of the parameters (``torch.func.functional_call`` of the
  model with the cast parameters, so the cast's backward carries each
  gradient back to its float32 master) and of the batch's floating arrays.
  Buffers (the batch norms' running statistics), the masters, their
  ``.grad``, the global norm, the clip and the optimizer state stay float32,
  and the losses reduce in float32.  The val and test stages always compute
  in float32.  A family refuses it (``check_compute_dtype``) where the JAX
  package's bfloat16 step fails to trace.
- ``--transfer_dtype=bfloat16``: floating batch arrays cross to the device
  in bfloat16 (``core.cuda_graphs.host_tensor``, bfloat16 pinned staging in the
  captured graphs); the steps cast them to their compute dtype at entry.
- ``--matmul_precision``: ``highest`` (the default) or ``tensorfloat32``,
  scoped to the trainer's own steps, captures and eval stages.

Dropout draws from a generator on the device seeded from ``params.seed``.
Left out, for later slices, and refused with ``NotImplementedError`` where a
knob asks for them (``NOT_PORTED``): ``steps_per_call`` > 1 and
``eval_steps_per_call`` (K steps in one compiled call, which the captured
step would hold as K steps in one graph), step-count checkpoints,
``profile_steps``, the NaN guard and ``debug_nans``, ``eval_first``, and the
metric exporters (TensorBoard, wandb, a remote URL).  Also left out:
experiment directories, the metric database and board, and several
processes or devices.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from erc_tpu_torch.core import precision
from erc_tpu_torch.core.cuda_graphs import CapturedForward, CapturedStep
from erc_tpu_torch.core.device import resolve_device
from erc_tpu_torch.core.seed import RngPool
from erc_tpu_torch.data.collate import ERCBatcher
from erc_tpu_torch.data.loader import DialogueLoader, to_device
from erc_tpu_torch.data.registry import dataset_has_val, get_root, pick_datas
from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.rnn import point_rnns_at_their_parameters
from erc_tpu_torch.train.checkpoint import Saver
from erc_tpu_torch.train.metrics import classification_summary
from erc_tpu_torch.train.optim import clip_by_global_norm_, global_norm, load_optimizer_state


# knobs of the JAX trainer that the port does not honour yet: the value each
# may keep, and the test that it asks for more
NOT_PORTED = {
    "steps_per_call": lambda v: int(v or 1) > 1,
    "eval_steps_per_call": lambda v: int(v or 0) > 0,
    "checkpoint_per_step": bool,
    "profile_steps": bool,
    "nan_guard": bool,
    "eval_first": bool,
    "debug_nans": bool,
    "tensorboard": bool,
    "wandb": bool,
    "remote_url": bool,
}


def refuse_compute_dtype(form: str, jax_site: str) -> None:
    """The ``ValueError`` of a family form that does not train in bfloat16:
    the JAX package's bfloat16 step fails at ``jax_site`` before a kernel
    runs, and the port trains nothing that the JAX package does not."""
    raise ValueError(f"--compute_dtype=bfloat16 with {form}: the JAX package's bfloat16 train step fails to trace "
                     f"there ({jax_site}); train this form in float32, or pick one that trains in bfloat16")


def refuse_banded_compute_dtype(trainer, params) -> None:
    """``check_compute_dtype`` of the families with a banded graph (COGMEN,
    DialogueGCN): bfloat16 trains the dense graph only; with
    ``graph_impl=banded``, or ``auto`` where L may pass 256, the JAX step
    fails in the band kernels' products."""
    if trainer.compute_dtype != torch.float32 and (
            params.graph_impl == "banded" or (params.graph_impl == "auto" and int(params.max_seq_len) > 256)):
        refuse_compute_dtype(f"--graph_impl={params.graph_impl} at --max_seq_len={params.max_seq_len}",
                             "erc_tpu/ops/gnn_banded.py:163, banded_gather_sum(alpha, v, ...): "
                             "lax.mul of bfloat16 and float32")


class _Bound(torch.nn.Module):
    """``fn`` as the forward of a module whose one child is ``model``: under
    ``torch.func.functional_call`` of it, ``fn`` sees ``model`` with the
    parameters the call was given."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def masked_cross_entropy(logits, labels, mask, class_weights=None) -> torch.Tensor:
    """Mean cross-entropy over the valid positions, reduced in float32.  With
    class weights, divided by the summed weight of the targets (as
    ``F.cross_entropy(weight=...)``)."""
    logits = logits.float()
    mask = mask.float()
    safe = labels.clamp_min(0).long()
    nll = -torch.log_softmax(logits, -1).gather(-1, safe[..., None])[..., 0]
    if class_weights is not None:
        w = class_weights[safe] * mask
        return (nll * w).sum() / w.sum().clamp_min(1e-8)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def masked_accuracy(logits, labels, mask) -> torch.Tensor:
    hit = (logits.argmax(-1) == labels).float() * mask.float()
    return hit.sum() / mask.float().sum().clamp_min(1.0)


class Trainer:
    """Generic ERC trainer; one subclass per model family."""

    plateau_source = "test"  # which stage's loss steps lr_sche ("val": MMIN)
    eval_graphs = True  # on the card, replay the captured eval forward (False: eager)
    train_graphs = True  # on the card, replay the captured train step (False: eager)

    def __init__(self, params):
        for name, asks in NOT_PORTED.items():
            if asks(params.get(name)):
                raise NotImplementedError(f"--{name}={params.get(name)!r} is not ported to the PyTorch trainer yet")
        self.compute_dtype = precision.dtype_of(params.get("compute_dtype"))
        self.transfer_dtype = precision.dtype_of(params.get("transfer_dtype"))
        self.fp32_precision = precision.fp32_precision(params.get("matmul_precision"))
        self.check_compute_dtype(params)
        self.params = params
        self.device = resolve_device(params.get("device", 0))
        self.rng = RngPool(params.seed)
        self.model: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.grad_clip_norm: Optional[float] = None
        self.lr_sche = None
        self.class_weights: Optional[torch.Tensor] = None
        self.eidx = 0
        self.global_steps = 0
        self.best_f1 = float("-inf")
        self.best_val_f1 = float("-inf")
        self._dropout_rng: Optional[torch.Generator] = None
        self._test_loader = None
        self._val_loader = None
        self._saver: Optional[Saver] = None
        self._captured: Optional[CapturedForward] = None
        self._captured_step: Optional[CapturedStep] = None

    # ------------------------------------------------------------------ setup
    def imodels(self, params) -> None:
        raise NotImplementedError

    def check_compute_dtype(self, params) -> None:
        """Raise ``ValueError`` where the family cannot train in
        ``self.compute_dtype`` with these settings (a subclass overrides it)."""

    def precision(self):
        """The block in which the trainer's products run at its
        ``--matmul_precision``."""
        return precision.scoped(self.fp32_precision)

    def log(self, msg: str) -> None:
        print(msg, flush=True)

    def batcher(self, batch_size: Optional[int] = None) -> ERCBatcher:
        p = self.params
        return ERCBatcher(
            modality=p.modality,
            n_classes=p.n_classes,
            n_speakers=p.n_speakers,
            speaker_onehot=bool(p.get("speaker_onehot", False)),
            bucket=p.get("length_bucket", 0),
            max_len=p.get("max_seq_len", 128),
            pad_batch_to=batch_size,
        )

    def initialize(self) -> None:
        if self.model is not None:
            return
        self.imodels(self.params)
        self._dropout_rng = self.rng.torch_generator("dropout", self.device)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self._dropout_rng
        n_params = sum(t.numel() for t in self.model.parameters())
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        self.log(f"model {type(self.model).__name__}: {n_params / 1e6:.3f}M params, on {self.device} ({name})")

    def make_loader(self, split: str) -> DialogueLoader:
        p = self.params
        root = p.get("data_root") or (None if p.dataset.startswith("synthetic-") else get_root(p.dataset))
        samples = pick_datas(root, p.dataset, split=split)
        bs = int(p.train.batch_size if split == "train" else p.test.batch_size)
        bc = p.get("batch_count")
        return DialogueLoader(
            samples,
            self.batcher(bs),
            batch_size=bs,
            shuffle=(split == "train"),
            seed=p.seed,
            sort_by_length=bool(p.get("sort_by_length", True)),
            sort_chunk=int(p.get("sort_chunk", 8)),
            batch_count=(int(bc) if bc and split == "train" else None),
        )

    # ------------------------------------------------------------------- step
    def loss_and_metrics(self, batch: Dict[str, torch.Tensor]):
        """Default: masked cross-entropy and accuracy."""
        logits = self.model(batch)
        mask = batch["attention_mask"]
        loss = masked_cross_entropy(logits, batch["label"], mask, self.class_weights)
        return loss, {"Lall": loss.detach(), "Acc": masked_accuracy(logits.detach(), batch["label"], mask)}

    def compute_grads(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Forward and backward of one batch in training mode, in
        ``compute_dtype`` (the batch's floating arrays cast at entry, and in
        bfloat16 the model run on bfloat16 copies of its parameters): leaves
        every parameter's float32 gradient in ``.grad`` (zeros where none
        reaches it, as optax updates every leaf) and returns the metrics, on
        the device.  The ``.grad`` tensors are made once and zeroed here, so
        that a captured step writes the same tensors whatever its bucket."""
        self.model.train()
        torch._foreach_zero_(self.grads())
        batch = precision.cast_floats(batch, self.compute_dtype)
        with self.precision(), torch.enable_grad():
            if self.compute_dtype == torch.float32:
                loss, mets = self.loss_and_metrics(batch)
            else:
                cast = {f"model.{n}": t.to(self.compute_dtype) for n, t in self.model.named_parameters()}
                try:
                    loss, mets = torch.func.functional_call(_Bound(self.model, self.loss_and_metrics), cast, (batch,))
                finally:
                    point_rnns_at_their_parameters(self.model)
            loss.backward()
        return mets

    def grads(self) -> List[torch.Tensor]:
        """Each parameter's ``.grad``, made (zeros) where it is None."""
        params = list(self.model.parameters())
        for t in params:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        return [t.grad for t in params]

    def after_step(self) -> None:
        """State updated after the optimizer step, inside the captured step
        (MMIN's EMA shadow); in place."""

    def _step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step that the card captures: the gradients, their global norm
        before the clip (``gnorm``), optax's clip, the optimizer step and
        ``after_step``.  Nothing waits for the device."""
        mets = self.compute_grads(batch)
        grads = self.grads()
        if self.grad_clip_norm:
            mets["gnorm"] = clip_by_global_norm_(grads, float(self.grad_clip_norm))
        else:
            mets["gnorm"] = global_norm(grads)
        self.optimizer.step()
        self.after_step()
        return mets

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One eager optimizer step on a batch of device tensors; the metrics
        include ``gnorm``, the global norm of the gradients before the clip."""
        mets = self._step(batch)
        self.global_steps += 1
        return mets

    def train_batch(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One optimizer step on a host batch, as ``train()`` takes it: on the
        card a replay of the step captured for the batch's shape (its first
        batch trains eagerly before the capture), else ``train_step``."""
        if self.device.type == "cuda" and self.train_graphs:
            mets = self.captured_step(host_batch)
            self.global_steps += 1
            return mets
        return self.train_step(to_device(host_batch, self.device, self.transfer_dtype))

    def _step_tensors(self) -> List[torch.Tensor]:
        """What the captured step reads or writes by address: parameters,
        their gradients and buffers of every module the trainer holds, the
        optimizer's state and tensor hyperparameters (the LR)."""
        params = list(self.model.parameters())
        opt = [v for s in self.optimizer.state.values() for v in s.values() if isinstance(v, torch.Tensor)]
        hyper = [v for g in self.optimizer.param_groups for v in g.values() if isinstance(v, torch.Tensor)]
        return [*self._eval_tensors(), *(t.grad for t in params if t.grad is not None), *opt, *hyper]

    @property
    def captured_step(self) -> CapturedStep:
        """The train step captured per batch shape (the card only); raises
        where the optimizer cannot be captured."""
        if self._captured_step is None:
            if not all(g.get("capturable") for g in self.optimizer.param_groups):
                raise NotImplementedError(
                    f"the captured train step needs a capturable optimizer (adam or adamw on the card), not "
                    f"{type(self.optimizer).__name__}: set train_graphs = False to step eagerly")
            self._captured_step = CapturedStep(self._step, self.device, watch=self._step_tensors,
                                               generators=(self._dropout_rng,), transfer_dtype=self.transfer_dtype)
        return self._captured_step

    # ------------------------------------------------------------------- loop
    def train(self) -> List[Dict[str, Any]]:
        """Every epoch: the train steps, then the val stage (where the
        dataset has a real val split and ``eval_val`` holds) and the test
        stage.  Returns one record per epoch: the metrics' means, steps,
        dialogues (padding rows not counted), the train steps' wall seconds
        and the val and test results."""
        p = self.params
        self.initialize()
        if p.get("resume"):
            self.resume()
        has_val = dataset_has_val(str(p.dataset))
        if p.get("select_on", "test") == "val" and not has_val:
            # selecting on val where val aliases test would save no best model at all
            self.log(f"--select_on=val but dataset {p.dataset!r} has no real val split (val aliases test); "
                     "falling back to select_on=test")
            p.select_on = "test"
        loader = self.make_loader("train")
        log_every = max(int(p.get("log_every", 10)), 1)
        eval_every = int(p.get("eval_per_epoch", 1) or 0)
        history = []
        for eidx in range(self.eidx, int(p.epoch)):
            self.eidx = eidx
            loader.set_epoch(eidx)
            sums: Dict[str, torch.Tensor] = {}
            n_steps = n_dialogues = 0
            t0 = time.perf_counter()
            for bidx, host_batch in enumerate(loader):
                mets = self.train_batch(host_batch)
                for k, v in mets.items():
                    sums[k] = sums[k] + v if k in sums else v
                n_steps += 1
                n_dialogues += _rows(host_batch)
                if bidx % log_every == 0:  # reads the metrics back: keep it sparse
                    self.log(f"e{eidx} b{bidx} " + _fmt({k: v.item() for k, v in mets.items()}))
            means = {k: v.item() / max(n_steps, 1) for k, v in sums.items()}  # waits for the device
            dt = time.perf_counter() - t0
            self.log(f"epoch {eidx}: {_fmt(means)} | {n_steps} steps, {n_dialogues / max(dt, 1e-9):.1f} dia/s")
            record = {"epoch": eidx, **means, "steps": n_steps, "dialogues": n_dialogues, "seconds": dt}
            if eval_every and (eidx + 1) % eval_every == 0:
                if p.get("eval_val", True) and has_val:
                    record["val"] = self.evaluate()
                record["test"] = self.test()
            self._epoch_checkpoints(record)
            history.append(record)
        return history

    def _epoch_checkpoints(self, record: Dict[str, Any]) -> None:
        """The epoch's rotating checkpoint and keypoint.  ``best_f1`` follows
        test F1; the rotating checkpoint is the best so far by test F1, or by
        val F1 (which ``evaluate`` tracks) with ``--select_on=val``."""
        p = self.params
        f1 = record.get("test", {}).get("f1")
        is_best = f1 is not None and f1 >= self.best_f1
        if is_best:
            self.best_f1 = f1
        if p.get("select_on", "test") == "val":
            val_f1 = record.get("val", {}).get("f1")
            is_best = val_f1 is not None and val_f1 >= self.best_val_f1
        every = int(p.get("checkpoint_per_epoch") or 0)
        if every and (self.eidx + 1) % every == 0:
            self.save_checkpoint(is_best=is_best)
        every = int(p.get("keypoint_per_epoch") or 0)
        if every and (self.eidx + 1) % every == 0:
            self.saver.save_keypoint(self.global_steps, self.state_tree(), meta=self._meta())

    # ------------------------------------------------------------------- eval
    def _collect_nll(self, logits: np.ndarray, labels: np.ndarray, sel: np.ndarray) -> None:
        """Accumulate the masked NLL on the host (stable log-softmax)."""
        lg = np.asarray(logits, np.float32)[sel]
        if lg.size == 0:
            return
        lab = np.asarray(labels)[sel]
        m = lg.max(-1, keepdims=True)
        lse = m[:, 0] + np.log(np.exp(lg - m).sum(-1))
        self._nll_sum += float((lse - lg[np.arange(len(lab)), lab]).sum())
        self._nll_n += int(len(lab))

    def test_step_collect(self, batch: Dict[str, np.ndarray], logits: np.ndarray) -> None:
        """Gather the masked predictions and NLL of one batch on the host."""
        mask = np.asarray(batch["attention_mask"]) > 0
        labels = np.asarray(batch["label"])
        sel = mask & (labels >= 0)
        self._true.extend(labels[sel].tolist())
        self._pred.extend(logits.argmax(-1)[sel].tolist())
        self._collect_nll(logits, labels, sel)

    def to_logits(self, batch: Dict[str, torch.Tensor]):
        """The eval forward: logits [B, L, C], or a tuple of outputs."""
        return self.model(batch)

    def _eval_forward(self, batch: Dict[str, torch.Tensor]):
        """``to_logits`` in float32 whatever the compute dtype, on the batch's
        floating arrays upcast from their transfer dtype."""
        return self.to_logits(precision.cast_floats(batch, torch.float32))

    def _eval_tensors(self) -> List[torch.Tensor]:
        """The parameters and buffers of every module the trainer holds."""
        mods = [m for m in vars(self).values() if isinstance(m, torch.nn.Module)]
        return [t for m in mods for t in (*m.parameters(), *m.buffers())]

    @property
    def captured(self) -> CapturedForward:
        """The eval forward captured per batch shape (the card only)."""
        if self._captured is None:
            self._captured = CapturedForward(self._eval_forward, self.device, watch=self._eval_tensors,
                                             transfer_dtype=self.transfer_dtype)
        return self._captured

    def _eval_loop(self, loader) -> None:
        self.model.eval()
        with torch.inference_mode(), self.precision():
            for host_batch in loader:
                if self.device.type == "cuda" and self.eval_graphs:
                    out = self.captured(host_batch)
                else:
                    out = _to_host(self._eval_forward(to_device(host_batch, self.device, self.transfer_dtype)))
                self.test_step_collect(host_batch, out)

    # hooks where the JAX trainer fires them; a subclass overrides what it needs
    def on_eval_begin(self) -> None:
        pass

    def on_eval_end(self, res: Dict[str, Any]) -> None:
        pass

    def on_test_begin(self) -> None:
        pass

    def on_test_end(self, res: Dict[str, Any]) -> None:
        pass

    def _reset_collectors(self) -> None:
        self._true: List[int] = []
        self._pred: List[int] = []
        self._nll_sum, self._nll_n = 0.0, 0

    def _plateau_step(self, loss: Optional[float]) -> None:
        """Step the plateau controller (where the subclass set one) on a loss."""
        if self.lr_sche is None or loss is None or not self.params.get("lr_plateau", True):
            return
        cur = float(self.optimizer.param_groups[0]["lr"])  # a tensor on the card, written in place
        self.lr_sche.step(float(loss))
        new = float(self.optimizer.param_groups[0]["lr"])
        if new != cur:
            self.log(f"ReduceLROnPlateau: lr {cur} -> {new}")

    def evaluate(self) -> Dict[str, Any]:
        """The val split: loss ``Lall`` and the summary's ``acc``, ``f1`` and
        ``wa``.  With ``--select_on=val`` it saves ``model.best_val.ckpt``
        whenever val F1 is at least the best so far; with
        ``plateau_source == "val"`` the val loss steps the plateau controller."""
        p = self.params
        self.initialize()
        if self._val_loader is None:
            self._val_loader = self.make_loader("val")
        self._reset_collectors()
        self.on_eval_begin()
        self._eval_loop(self._val_loader)
        val_loss = self._nll_sum / max(self._nll_n, 1)
        res: Dict[str, Any] = {"Lall": val_loss}
        if self._true:
            summ = classification_summary(self._true, self._pred, p.n_classes)
            res.update({k: summ[k] for k in ("acc", "f1", "wa")})
        self.log(f"val: Lall={val_loss:.5f}" + (f" f1={res['f1']:.5f}" if "f1" in res else ""))
        if p.get("select_on", "test") == "val" and "f1" in res and res["f1"] >= self.best_val_f1:
            self.best_val_f1 = res["f1"]
            self.save_model("best_val")
        if self.plateau_source == "val":
            self._plateau_step(val_loss if self._nll_n else None)
        self.on_eval_end(res)
        return res

    def test(self) -> Dict[str, Any]:
        """The test split: loss ``Lall`` and the classification summary."""
        p = self.params
        self.initialize()
        if self._test_loader is None:
            self._test_loader = self.make_loader("test")
        self._reset_collectors()
        self.on_test_begin()
        self._eval_loop(self._test_loader)
        test_loss = self._nll_sum / max(self._nll_n, 1)
        res: Dict[str, Any] = {}
        if self._true:
            res = classification_summary(self._true, self._pred, p.n_classes)
            cm = res.pop("cm")
            if p.get("confusion_matrix", True):
                self.log(str(cm))
            self.log("test: " + _fmt({k: res[k] for k in ("acc", "wa", "pre", "rec", "f1", "mif1", "maf1")}))
        res["Lall"] = test_loss
        self.log(f"test: Lall={test_loss:.5f} over {self._nll_n} utterances")
        if self.plateau_source == "test":
            self._plateau_step(test_loss if self._nll_n else None)
        self.on_test_end(res)
        return res

    # ------------------------------------------------------------ checkpoints
    @property
    def saver(self) -> Saver:
        if self._saver is None:
            p = self.params
            save_dir = p.get("save_dir") or os.path.join(
                os.path.expanduser("~"), ".erc_tpu_torch", "saver", str(p.get("module") or "model"), str(p.dataset))
            self._saver = Saver(save_dir)
        return self._saver

    def state_tree(self) -> Dict[str, Any]:
        """What a checkpoint holds: the state dicts of the model, the
        optimizer and the plateau controller (where there is one), the
        dropout generator's state, the step, the epoch and the best test and
        val F1.  A subclass with state of its own adds it here and restores it
        in ``load_state_tree``."""
        tree = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "rng": self._dropout_rng.get_state(), "step": self.global_steps, "eidx": self.eidx,
                "best_f1": self.best_f1, "best_val_f1": self.best_val_f1}
        if self.lr_sche is not None:
            tree["lr_sche"] = self.lr_sche.state_dict()
        return tree

    def _meta(self) -> Dict[str, Any]:
        return {"eidx": self.eidx, "global_steps": self.global_steps}

    def save_model(self, tag: str = "last") -> str:
        path = self.saver.save_model(tag, self.state_tree(), meta=self._meta())
        self.log(f"saved {path}")
        return path

    def save_checkpoint(self, is_best: bool = False) -> str:
        """The rotating checkpoint of the epoch just ended."""
        return self.saver.save_checkpoint(self.global_steps, self.state_tree(),
                                          meta={**self._meta(), "epoch_end": True}, is_best=is_best)

    def resume(self) -> Optional[str]:
        """Restore the newest readable rotating checkpoint (a torn file is
        passed over for the next-oldest) and continue at the epoch after its
        own; returns its path, or None where there is none."""
        self.initialize()
        for path in reversed(self.saver.list_checkpoints()):
            try:
                tree = self.saver.load(path)
            except (OSError, RuntimeError) as e:
                self.log(f"unreadable checkpoint {path}: {e!r}")
                continue
            self.load_state_tree(tree)
            self.eidx += 1
            self.log(f"resumed from {path} (eidx={self.eidx}, global_steps={self.global_steps})")
            return path
        return None

    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        """Restore what ``state_tree`` saved (the epoch is the saved one's);
        the captured graphs are dropped."""
        for graphs in (self._captured, self._captured_step):
            if graphs is not None:
                graphs.invalidate()
        self.model.load_state_dict(tree["model"])
        load_optimizer_state(self.optimizer, tree["optimizer"])
        if self.lr_sche is not None:
            self.lr_sche.load_state_dict(tree["lr_sche"])
        self._dropout_rng.set_state(tree["rng"])
        self.global_steps, self.eidx, self.best_f1 = tree["step"], tree["eidx"], tree["best_f1"]
        self.best_val_f1 = tree.get("best_val_f1", float("-inf"))  # older checkpoints lack it


def _rows(host_batch: Dict[str, np.ndarray]) -> int:
    """Rows of a host batch that are not padding: dialogues of length > 0, or
    utterances with ``sample_mask`` > 0 where the batch has no ``text_length``."""
    if host_batch.get("text_length") is not None:
        return int((host_batch["text_length"] > 0).sum())
    return int((host_batch["sample_mask"] > 0).sum())


def _to_host(out):
    """Float32 numpy of the eval forward's output, or a tuple of them."""
    if isinstance(out, tuple):
        return tuple(_to_host(t) for t in out)
    return out.float().cpu().numpy()


def _fmt(values: Dict[str, float]) -> str:
    return ", ".join(f"{k}={v:.5f}" for k, v in values.items())
