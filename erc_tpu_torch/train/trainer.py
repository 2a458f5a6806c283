"""The train loop.

Port of ``erc_tpu.train.trainer.Trainer``: build the model and optimizer
(``imodels``), the train step (loss, gradients, their global norm before
the clip, optax's clip, the optimizer step), the epoch loop with
``batch_count`` and ``log_every``, the val stage (``evaluate``: on datasets
with a real val split, before each test stage) and the test stage (masked
NLL and the classification summary on the host), ``--select_on=test|val``,
the plateau controller on the test or val loss (``plateau_source``).  A
subclass sets ``model``, ``optimizer`` and, where it wants them,
``grad_clip_norm`` and ``lr_sche``; it may override ``to_logits`` (the eval
forward; a tuple of outputs is fine, ``test_step_collect`` then gets a
tuple of arrays), the hooks ``on_eval_begin``, ``on_eval_end(res)``,
``on_test_begin``, ``on_test_end(res)`` and ``on_train_epoch_end(eidx,
record)``, fired where the JAX trainer fires them, and
``state_tree``/``load_state_tree`` to carry state of its own (MMIN's EMA
shadow) in checkpoints.  Batches are of dialogues (``text_length``) or of
utterances (``sample_mask``, MMIN): a record's ``dialogues`` counts the
rows that are not padding either way.

The runtime around the loop is the JAX trainer's:

- Every trainer is a run of an experiment (``core.experiment``):
  ``<exproot>/experiment/erc_tpu_torch.<TrainerClass>/<test_name>/`` holds
  ``params.yaml``, ``initial.json``/``final.json``, ``rerun.sh``, the log
  (``core.logger``), ``metrics.json`` (best metrics, ``core.metrics_db``),
  ``board.jsonl`` (one row per train, val and test stage) and the heartbeat
  (``--heartbeat``); ``<exproot>/blob/...`` holds ``predictions.jsonl``,
  the ``Saver``'s ``saver/`` (``--save_dir`` takes its place where given),
  ``profile/`` and TensorBoard's ``board/``.  ``exproot`` is
  ``ERC_TPU_EXPROOT``, the machine config's, or ``~/.erc_tpu``.
- Callbacks (``train.callbacks``) are installed by ``icallbacks`` from the
  knobs and fired by ``_fire``: ``--checkpoint_per_epoch``,
  ``--checkpoint_per_step`` (a threshold in steps), ``--keypoint_per_epoch``,
  ``--resume`` (the newest readable checkpoint of this run, else of a
  sibling run with the same ``params.resume_hash()``), ``--pretrain``,
  ``--eval_first``, ``--nan_guard``, a ``.stop`` file, ``--tensorboard``,
  ``--wandb`` and ``--remote_url``.  ``save_checkpoint(epoch_end=...)``
  records whether the epoch ended, so a mid-epoch checkpoint resumes by
  running its epoch again and an epoch-end one at the next.
- ``--profile_steps=N`` traces the first N steps (with K > 1, steps, not
  calls) of the first epoch trained into ``<blob>/profile/`` as a Chrome
  trace (``train.profiler``), the card's kernels included; the trace covers
  the steps only (``train_begin``'s callbacks, such as ``EvalFirst``, run
  before it), and may hold a bucket's eager first steps and its capture.
  It holds the port's spans (``core.tracing``) as ``erc.*`` ranges: each
  step, its wait, staging and launch, the loader's gets, each capture.
- ``--debug_nans`` (the port's ``jax_debug_nans``) raises
  ``FloatingPointError`` naming the first module whose forward output, or
  whose gradient (autograd's anomaly mode), is not finite.  Anomaly mode
  cannot run inside a CUDA graph, so under it the train step runs eagerly.

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
rather than written in place.  A checkpoint reads the state and replaces
nothing, so the graphs stay valid across one.

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

The loaders run through the JAX trainer's pipeline (``_pipeline``):
``--steps_per_call`` = K > 1 grouping of K same-shape batches into one
stacked group (``--eval_steps_per_call``, where it is not 0, for the val
and test stages), then, with ``--prefetch`` (on by default), a producer
thread that collates and groups ahead of the steps (numpy only: no CUDA
call leaves the main thread).  The ``--transfer_dtype`` cast is the staging
copy's, not a pipeline stage.  A group trains as
K optimizer steps in one replay on the card (``train_group``; eagerly
elsewhere), returning the means of its K steps' metrics, and an epoch's
means are over calls, as the JAX package's ``Record`` takes them; a group
evaluates as K batches in one replay, each batch collected as with K = 1.

Dropout draws from a generator on the device seeded from ``params.seed``.

Several processes (``parallel.mesh``; the JAX trainer's multi-process run):
``--coordinator=host:port --num_processes=N --process_id=i`` (or
``ERC_TPU_COORDINATOR``, ``ERC_TPU_NUM_PROCESSES``, ``ERC_TPU_PROCESS_ID``, or
``ERC_TPU_DIST=auto`` under torchrun) start a process group in the entry
point (``main``, ``start_group``), before the trainer is built, one process
a card (``core.device.rank_card``); a trainer whose ``--coordinator`` finds
no group refuses to start.
Each rank trains the whole model on its strided rows of every global batch
(``data.loader``); the gradients are summed over ranks in the step (one
collective, captured with it under NCCL) and every loss and metric of a
step divides by the global denominator (``masked_cross_entropy``,
``masked_accuracy``, the families' own), so the summed gradient is the
global batch's and ``Lall`` the global loss on every rank, as in the JAX
trainer's one program.  Batch norms take global statistics
(``ops.norm``).  Rank 0 derives the test name and every rank takes it;
only rank 0 writes the run's files (the experiment's, the metric stores',
the Saver's); rank 0's parameters and buffers are copied to every rank once
they are made or loaded (``sync_from_main``); the val and test stages gather
every rank's rows before a metric (``_sync_eval_state``), so every rank
takes the same decisions.  Where ranks share a card the group is gloo, and
the train step runs eagerly (a gloo collective cannot be captured), as the
log line on the group says.  Dropout draws from each rank's own stream:
rank 0's is the one-process run's, another rank's is tagged with its rank
(and, after a resume, with the restored step), so the ranks' rows draw
independent masks, as the rows of the JAX program's global batch do; the
masks are not the JAX program's, so trajectories are compared at dropout 0.

The mesh's model axis (the JAX trainer's ``shard_params`` under a mesh set
before ``initialize()``): ``trainer.mesh_spec = MeshSpec(data=D, model=M)``
before ``initialize()`` lays D × M ranks out (``mesh.set_axes``); the ranks
of one data index share its rows (and its dropout stream), every sum over
rows runs over the data group, and ``parallel.mesh.ModelAxis`` steps each
rank's block of the split parameters (a view of the full one: the rank keeps
that block's moments only), all-gathered into the modules after each
optimizer step.  Checkpoints hold the full parameters and moments (an
unsharded run's layout); a load re-shards the moments.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from erc_tpu_torch.core import precision, tracing
from erc_tpu_torch.core.cuda_graphs import CapturedForward, CapturedStep
from erc_tpu_torch.core.experiment import Experiment
from erc_tpu_torch.core.logger import Logger
from erc_tpu_torch.core.meter import Meter, Record
from erc_tpu_torch.core.metrics_db import BestMetrics, MetricBoard, PredictionStore
from erc_tpu_torch.core.seed import RngPool
from erc_tpu_torch.core.summary import tensors
from erc_tpu_torch.data.collate import ERCBatcher
from erc_tpu_torch.data.loader import DialogueLoader, GroupedLoader, PrefetchLoader, StackedGroup, to_device
from erc_tpu_torch.data.registry import dataset_has_val, get_root, pick_datas
from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.rnn import point_rnns_at_their_parameters
from erc_tpu_torch.parallel import mesh
from erc_tpu_torch.train import callbacks as cbs
from erc_tpu_torch.train import profiler
from erc_tpu_torch.train.checkpoint import Saver, read_train_state
from erc_tpu_torch.train.metrics import classification_summary
from erc_tpu_torch.train.optim import clip_by_global_norm_, global_norm, has_schedule, load_optimizer_state


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
    ``F.cross_entropy(weight=...)``).  Under a process group the denominator
    is the global batch's, so the value is this rank's share of the global
    mean."""
    logits = logits.float()
    mask = mask.float()
    safe = labels.clamp_min(0).long()
    nll = -torch.log_softmax(logits, -1).gather(-1, safe[..., None])[..., 0]
    if class_weights is not None:
        w = class_weights[safe] * mask
        return (nll * w).sum() / mesh.global_sum(w.sum()).clamp_min(1e-8)
    return (nll * mask).sum() / mesh.global_sum(mask.sum()).clamp_min(1.0)


def masked_accuracy(logits, labels, mask) -> torch.Tensor:
    """Hits over the valid positions (this rank's share, under a process group)."""
    hit = (logits.argmax(-1) == labels).float() * mask.float()
    return hit.sum() / mesh.global_sum(mask.float().sum()).clamp_min(1.0)


def start_group(params) -> bool:
    """The process group that ``--coordinator``, ``--num_processes`` and
    ``--process_id`` (or their variables) ask for, started before a trainer
    touches a card, with this rank's card made current
    (``mesh.initialize_distributed``); True where a group is up."""
    return mesh.initialize_distributed(params.get("coordinator"), params.get("num_processes"),
                                       params.get("process_id"), device=params.get("device", 0))


def main(trainer_cls, params_cls, argv: Optional[list] = None):
    """A family's ``main`` (the JAX ``trainer.main``): read the flags, start
    the process group they ask for, train, then save the model
    (``model.last.ckpt`` under ``--save_dir``).  The caller ends the group
    (``mesh.destroy``, as ``python -m erc_tpu_torch.train`` does)."""
    params = params_cls()
    params.finalize(argv)
    start_group(params)
    trainer = trainer_cls(params)
    trainer.train()
    trainer.save_model()
    return trainer


class Trainer:
    """Generic ERC trainer; one subclass per model family."""

    plateau_source = "test"  # which stage's loss steps lr_sche ("val": MMIN)
    flax_module = ""  # convert.STATES' key of the family: --pretrain reads a JAX package file through it
    eval_graphs = True  # on the card, replay the captured eval forward (False: eager)
    train_graphs = True  # on the card, replay the captured train step (False: eager)
    mesh_spec: Optional[mesh.MeshSpec] = None  # set before initialize(): the mesh's data and model axes

    def __init__(self, params, exp_name: Optional[str] = None):
        if params.get("coordinator") and not mesh.grouped():
            raise ValueError(f"--coordinator={params.get('coordinator')} asks for a process group and none is up: "
                             "start it before the trainer is built (start_group, as every family's main does)")
        self.compute_dtype = precision.dtype_of(params.get("compute_dtype"))
        self.transfer_dtype = precision.dtype_of(params.get("transfer_dtype"))
        self.fp32_precision = precision.fp32_precision(params.get("matmul_precision"))
        self.check_compute_dtype(params)
        self.params = params
        self.device = mesh.rank_device(params.get("device", 0))
        self.debug_nans = bool(params.get("debug_nans", False))
        if self.debug_nans:
            self.train_graphs = False  # anomaly mode cannot run inside a CUDA graph
        if not mesh.captures_allowed():
            self.train_graphs = False  # a gloo collective runs on the host: no CUDA graph holds it
        self.logger = Logger()
        self.rng = RngPool(params.seed)
        # one run directory for every rank: rank 0 names it
        test_name = mesh.broadcast_one_to_all(Experiment.make_test_name())
        writer = mesh.is_main_process()  # the ranks share the run's files: rank 0 alone writes them
        self.exp = Experiment(exp_name or f"erc_tpu_torch.{type(self).__name__}", test_name=test_name, write=writer)
        self.exp.record_start(self.device)
        log_file = self.logger.add_log_dir(self.exp.test_dir)
        weakref.finalize(self, self.logger.remove_log_file, log_file)  # the singleton logger outlives the run
        if mesh.grouped():
            self.log(mesh.describe())
        self.database = BestMetrics(self.exp.test_file("metrics.json"), write=writer)
        self.metric_board = MetricBoard(self.exp.test_file("board.jsonl"), write=writer)
        self.pred_info = PredictionStore(self.exp.blob_file("predictions.jsonl"), write=writer)
        self.saver = Saver(params.get("save_dir") or self.exp.blob_file("", "saver"), write=writer)
        self.callbacks: List[Any] = []
        self.stopped = False
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
        self._captured: Optional[CapturedForward] = None
        self._captured_step: Optional[CapturedStep] = None
        self.model_axis: Optional[mesh.ModelAxis] = None
        if writer:
            params.to_yaml(self.exp.test_file("params.yaml"))

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
        self.logger.info(msg)

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
        """Lay the ranks out on ``mesh_spec`` (every process on the data axis by
        default), build the model and optimizer (``imodels``), and split the
        model axis's parameters (``parallel.mesh.ModelAxis``) where it has one."""
        if self.model is not None:
            return
        data, model = (self.mesh_spec or mesh.MeshSpec()).resolve(mesh.process_count())
        mesh.set_axes(data, model)
        self.imodels(self.params)
        if model > 1:
            self.model_axis = mesh.ModelAxis(self.model, self.optimizer)
            self.log(f"mesh {data}x{model}: {len(self.model_axis.entries)} parameters split over the model axis "
                     f"({', '.join(self.model_axis.names) or 'none'})")
        self._dropout_rng = self.rng.torch_generator(self._dropout_tag(), self.device)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self._dropout_rng
        n_params = sum(t.numel() for t in self.model.parameters())
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        self.log(f"model {type(self.model).__name__}: {n_params / 1e6:.3f}M params, on {self.device} ({name})")
        if self.device.type == "cuda" and mesh.process_count() > 1:
            from erc_tpu_torch.ops.kernels import build

            build.build_on_main()  # one nvcc per source, on rank 0; the others load what it built

    @staticmethod
    def _dropout_tag() -> str:
        """The tag of this rank's dropout stream: data rank 0's (and one
        process's) is ``dropout``, another data rank's carries its index, so
        that the ranks' rows draw independent masks (the model ranks of one
        data index hold the same rows and draw the same masks)."""
        rank = mesh.data_index()
        return f"dropout/{rank}" if rank else "dropout"

    def sync_from_main(self) -> None:
        """Rank 0's parameters and buffers on every rank (of every module the
        trainer holds), after they are made or loaded (the model axis's blocks
        are views of them); nothing without a process group.  Every rank calls
        it at the same point."""
        mesh.broadcast_(self._eval_tensors())

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
            rank=mesh.data_index(),
            world=mesh.data_count(),
        )

    def _pipeline(self, loader, k):
        """The JAX trainer's loader pipeline: K-batch grouping (K > 1), then
        prefetch (``--prefetch``, on by default) in a producer thread that
        does numpy work only.  The JAX pipeline's first stage, the
        transfer-dtype cast (``transfer_cast_fn``), is left out: the copy
        into the bfloat16 staging (``host_tensor``) rounds the same way, so
        a cast before it would be a second pass over every batch for the
        same values."""
        k = max(int(k or 1), 1)
        if k > 1:
            loader = GroupedLoader(loader, k)
        if self.params.get("prefetch", True):
            loader = PrefetchLoader(loader)
        return loader

    def _pipeline_train(self, loader):
        return self._pipeline(loader, self.params.get("steps_per_call", 1))

    def _pipeline_eval(self, loader):
        """The val and test stages group by ``--eval_steps_per_call``, or by
        ``--steps_per_call`` where it is 0."""
        p = self.params
        return self._pipeline(loader, p.get("eval_steps_per_call", 0) or p.get("steps_per_call", 1))

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
        checks = nan_checks(self.model) if self.debug_nans else contextlib.nullcontext()
        with self.precision(), torch.enable_grad(), checks:
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
        ``after_step``.  Nothing waits for the device.  Under a process group
        the gradients and the metrics (each rank's share) are summed over the
        data group first, in one collective, so every rank clips, steps and
        reports the global batch's.  On a model axis each rank's optimizer
        steps its blocks of the split parameters (views of the full parameters
        and of their clipped gradients) and the blocks are all-gathered into
        the full parameters after the step."""
        mets = self.compute_grads(batch)
        grads = self.grads()
        if mesh.grouped():
            names = list(mets)
            values = torch.stack([mets[n].float() for n in names])
            mesh.allreduce_([*grads, values])
            mets = dict(zip(names, values.unbind()))
        if self.grad_clip_norm:
            mets["gnorm"] = clip_by_global_norm_(grads, float(self.grad_clip_norm))
        else:
            mets["gnorm"] = global_norm(grads)
        self.optimizer.step()
        if self.model_axis is not None:
            self.model_axis.gather()
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
        batch trains eagerly before the capture), else ``train_step``.  The
        span ``step`` (``core.tracing``) covers it, its ``step`` attribute
        the step's ``global_steps``."""
        with tracing.span("step", step=self.global_steps, k=1):
            if self.device.type == "cuda" and self.train_graphs:
                mets = self.captured_step(host_batch)
                self.global_steps += 1
                return mets
            return self.train_step(to_device(host_batch, self.device, self.transfer_dtype))

    def train_group(self, stacked: StackedGroup, k: int) -> Dict[str, torch.Tensor]:
        """``k`` optimizer steps on a stacked group of ``k`` host batches
        (``GroupedLoader``): on the card one replay of the ``k`` steps
        captured for the group's shape (its first group trains as ``k`` eager
        steps before the capture), else ``k`` eager steps.  Returns the mean
        of each metric over the ``k`` steps, as the JAX trainer's
        ``multi_step`` call does.  One span ``step`` covers the ``k``, its
        ``step`` attribute the first step's ``global_steps``."""
        with tracing.span("step", step=self.global_steps, k=k):
            if self.device.type == "cuda" and self.train_graphs:
                mets = self.captured_step.group(stacked, k)
            else:
                per = [self._step(to_device(stacked.batches[i], self.device, self.transfer_dtype))
                       for i in range(k)]
                mets = {n: torch.stack([m[n] for m in per]) for n in per[0]}
            self.global_steps += k
            return {n: v.mean() for n, v in mets.items()}

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
        where the optimizer cannot be captured (every one that
        ``train.optim.build_optim`` builds for the card can)."""
        if self._captured_step is None:
            if not all(g.get("capturable") for g in self.optimizer.param_groups):
                raise NotImplementedError(
                    f"the captured train step needs a capturable optimizer (as build_optim makes on the card), not "
                    f"{type(self.optimizer).__name__}: set train_graphs = False to step eagerly")
            self._captured_step = CapturedStep(self._step, self.device, watch=self._step_tensors,
                                               generators=(self._dropout_rng,), transfer_dtype=self.transfer_dtype)
        return self._captured_step

    # ------------------------------------------------------------------ hooks
    def icallbacks(self, params) -> None:
        """Install the callbacks that the knobs ask for (the JAX trainer's
        ``icallbacks``); under a process group the exporters (TensorBoard,
        wandb, the remote URL) on rank 0 only, where the JAX trainer runs them
        in every process."""
        cbs.StopByCode().hook(self)
        cbs.KeyErrorSave().hook(self)
        cbs.FinalReport().hook(self)
        if params.get("eval_first"):
            cbs.EvalFirst().hook(self)
        # both knobs: MMIN's pretrain_path alone has its own warm-start meaning
        if params.get("pretrain", False) and params.get("pretrain_path"):
            cbs.AutoLoadModel().hook(self)
        if params.get("checkpoint_per_epoch"):
            cbs.EpochCheckpoint(int(params.get("checkpoint_per_epoch"))).hook(self)
        if params.get("checkpoint_per_step"):
            cbs.GlobalStepCheckpoint(int(params.get("checkpoint_per_step"))).hook(self)
        if params.get("keypoint_per_epoch"):
            cbs.KeypointCheckpoint(int(params.get("keypoint_per_epoch"))).hook(self)
        if params.get("resume"):
            cbs.AutoResume().hook(self)
        if params.get("nan_guard"):
            cbs.NaNGuard().hook(self)
        if not mesh.is_main_process():
            return  # the exporters write and post the run's numbers: rank 0's, which every rank shares
        if params.get("tensorboard"):
            cbs.TensorBoardCallback().hook(self)
        if params.get("wandb"):
            cbs.WandbCallback().hook(self)
        if params.get("remote_url"):
            cbs.RemoteCallback(params.get("remote_url")).hook(self)

    def _fire(self, hook: str, *a, **kw) -> None:
        """``hook`` of every callback in priority order, then the trainer's
        own ``on_<hook>``."""
        for cb in self.callbacks:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(self, *a, **kw)
        own = getattr(self, "on_" + hook, None)
        if own is not None:
            own(*a, **kw)

    # ------------------------------------------------------------------- loop
    def train(self) -> List[Dict[str, Any]]:
        """Every epoch: the train steps, then the val stage (where the
        dataset has a real val split and ``eval_val`` holds) and the test
        stage, with the callbacks fired around them.  Returns one record per
        epoch: the metrics' means, steps, dialogues (padding rows not
        counted), the train steps' wall seconds and the val and test
        results."""
        p = self.params
        self.initialize()
        self.icallbacks(p)
        if p.get("select_on", "test") == "val" and not dataset_has_val(str(p.dataset)):
            # selecting on val where val aliases test would save no best model at all
            self.log(f"--select_on=val but dataset {p.dataset!r} has no real val split (val aliases test); "
                     "falling back to select_on=test")
            p.select_on = "test"
        loader = self._pipeline_train(self.make_loader("train"))
        history: List[Dict[str, Any]] = []
        heartbeat = self.exp.start_heartbeat() if p.get("heartbeat", True) and mesh.is_main_process() else None
        profile_steps = int(p.get("profile_steps", 0) or 0)
        profiling = contextlib.ExitStack()  # open while the first steps are traced
        try:
            self._fire("train_begin")
            self.sync_from_main()  # after any --resume or --pretrain load
            profile_until = self.global_steps + profile_steps
            if profile_steps > 0:
                profile_dir = self.exp.blob_file("", "profile")
                window = {"first_step": self.global_steps, "steps": profile_steps, "epoch": self.eidx,
                          "steps_per_call": int(p.get("steps_per_call", 1) or 1)}
                profiling.callback(self.log, "profile trace written")
                profiling.enter_context(profiler.trace(profile_dir, {"erc_tpu_torch.window": window},
                                                       cuda=self.device.type == "cuda",
                                                       file=profiler.trace_file(mesh.process_index())))
                self.log(f"profiling the first {profile_steps} steps → {profile_dir}")
            for eidx in range(self.eidx, int(p.epoch)):
                self.eidx = eidx
                history.append(self._train_epoch(loader, eidx, profiling, profile_until))
                if self.stopped:
                    break
        except BaseException as e:
            self.exp.record_end(ok=False, error=repr(e))
            self._fire("exception", e)
            raise
        finally:
            if heartbeat is not None:
                heartbeat.stop()
            profiling.close()  # an epoch shorter than profile_steps
        self._fire("train_end")
        self.metric_board.flush()
        self.database.flush()
        self.exp.record_end(ok=True)
        return history

    def _train_epoch(self, loader, eidx: int, profiling: contextlib.ExitStack, profile_until: int) -> Dict[str, Any]:
        """One epoch's steps, its record on the board, then its val and test
        stages; ``profiling`` is closed once ``global_steps`` reaches
        ``profile_until``."""
        p = self.params
        log_every = max(int(p.get("log_every", 10)), 1)
        eval_every = int(p.get("eval_per_epoch", 1) or 0)
        loader.set_epoch(eidx)
        record = Record("train")
        self._fire("train_epoch_begin", eidx)
        n_steps = n_dialogues = 0
        t0 = time.perf_counter()
        for bidx, item in enumerate(loader):
            host_batch, k = item if isinstance(item, tuple) else (item, 1)
            mets = self.train_batch(host_batch) if k == 1 else self.train_group(host_batch, k)
            n_steps += k
            n_dialogues += _rows(host_batch)
            if self.global_steps >= profile_until:
                profiling.close()
            record.record(Meter().update(mets))  # device tensors: read back at agg()
            self._fire("train_step_end", bidx, mets)
            if self.stopped:
                break
            if bidx % log_every == 0:  # reads the metrics back: keep it sparse
                self.logger.inline(f"e{eidx} b{bidx} {record}")
        self.logger.newline()
        means = record.agg()  # waits for the device
        dt = time.perf_counter() - t0  # the steps' device work included
        dps = n_dialogues / max(dt, 1e-9)
        self.log(f"epoch {eidx}: {_fmt(means)} | {n_steps} steps, {dps:.1f} dia/s")
        self.metric_board.append({**means, "dps": dps}, step=eidx, stage="train")
        self._fire("train_epoch_end", eidx, record)
        result = {"epoch": eidx, **means, "steps": n_steps, "dialogues": n_dialogues, "seconds": dt}
        if self.stopped:
            return result
        if eval_every and (eidx + 1) % eval_every == 0:
            if p.get("eval_val", True) and dataset_has_val(str(p.dataset)):
                result["val"] = self.evaluate()
            result["test"] = self.test()
        self._fire("epoch_end", eidx, result)
        return result

    def is_best_epoch(self, result: Dict[str, Any]) -> bool:
        """Whether an epoch's record (``train()``'s) holds the best F1 so far:
        test F1, or val F1 with ``--select_on=val``."""
        if self.params.get("select_on", "test") == "val":
            f1 = result.get("val", {}).get("f1")
            return f1 is not None and f1 >= self.best_val_f1
        f1 = result.get("test", {}).get("f1")
        return f1 is not None and f1 >= self.best_f1

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
        """Every batch's eval forward, collected by ``test_step_collect``; a
        stacked group of K (``GroupedLoader``) is one replay on the card, and
        each of its batches is collected with its own outputs, as with K = 1
        (in line: the JAX trainer collects a group one group late, which
        gives the same results)."""
        self.model.eval()
        graphs = self.device.type == "cuda" and self.eval_graphs
        with torch.inference_mode(), self.precision():
            for item in loader:
                host_batch, k = item if isinstance(item, tuple) else (item, 1)
                if k == 1:
                    out = self.captured(host_batch) if graphs else self._eager_eval(host_batch)
                    self.test_step_collect(host_batch, out)
                    continue
                outs = self.captured.group(host_batch, k) if graphs else None
                for i in range(k):
                    batch = host_batch.batches[i]
                    out = self._eager_eval(batch) if outs is None else _out_slice(outs, i)
                    self.test_step_collect(batch, out)

    def _eager_eval(self, host_batch):
        return _to_host(self._eval_forward(to_device(host_batch, self.device, self.transfer_dtype)))

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

    def _sync_eval_state(self) -> None:
        """Every rank's collected rows and NLL sums, the same on every rank,
        before any metric (the JAX trainer's ``_sync_eval_state``), so that
        metrics, the plateau controller and best-model decisions agree
        across ranks (as they were, without a process group)."""
        self._true = mesh.allgather_rows(np.asarray(self._true, np.int64)).tolist()
        self._pred = mesh.allgather_rows(np.asarray(self._pred, np.int64)).tolist()
        self._nll_sum, n = mesh.allsum(self._nll_sum, self._nll_n)
        self._nll_n = int(n)

    def _plateau_step(self, loss: Optional[float]) -> None:
        """Step the plateau controller (where the subclass set one) on a loss."""
        if self.lr_sche is None or loss is None or not self.params.get("lr_plateau", True):
            return
        if has_schedule(self.optimizer):
            # a declared schedule writes the LR before every step: it owns it
            if not getattr(self, "_warned_sche_plateau", False):
                self._warned_sche_plateau = True
                self.log("lr schedule declared (--optim.sche): plateau controller disabled")
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
            self._val_loader = self._pipeline_eval(self.make_loader("val"))
        self._reset_collectors()
        self._fire("eval_begin")
        self._eval_loop(self._val_loader)
        self._sync_eval_state()
        val_loss = self._nll_sum / max(self._nll_n, 1)
        res: Dict[str, Any] = {"Lall": val_loss}
        if self._true:
            summ = classification_summary(self._true, self._pred, p.n_classes)
            res.update({k: summ[k] for k in ("acc", "f1", "wa")})
        self.metric_board.append(res, step=self.eidx, stage="val")
        self.metric_board.flush()
        self.log(f"val: Lall={val_loss:.5f}" + (f" f1={res['f1']:.5f}" if "f1" in res else ""))
        if p.get("select_on", "test") == "val" and "f1" in res:
            with self.database as db:
                db.update_metrics({"val_f1": res["f1"]}, compare="max")
            if res["f1"] >= self.best_val_f1:
                self.best_val_f1 = res["f1"]
                self.save_model("best_val", is_best=True)
        if self.plateau_source == "val":
            self._plateau_step(val_loss if self._nll_n else None)
        self._fire("eval_end", res)
        return res

    def test(self) -> Dict[str, Any]:
        """The test split: loss ``Lall`` and the classification summary."""
        p = self.params
        self.initialize()
        if self._test_loader is None:
            self._test_loader = self._pipeline_eval(self.make_loader("test"))
        self._reset_collectors()
        self._fire("test_begin")
        self._eval_loop(self._test_loader)
        self._sync_eval_state()
        test_loss = self._nll_sum / max(self._nll_n, 1)
        res: Dict[str, Any] = {}
        if self._true:
            res = classification_summary(self._true, self._pred, p.n_classes)
            cm = res.pop("cm")
            if p.get("confusion_matrix", True):
                self.log(str(cm))
            self.log("test: " + _fmt({k: res[k] for k in ("acc", "wa", "pre", "rec", "f1", "mif1", "maf1")}))
            best = Meter()
            with self.database as db:
                for key in ("pre", "rec", "f1"):
                    best.update(db.update_metric_pair(key, res[key], f"cls_{key}", res[f"cls_{key}"]))
                best.update(db.update_metrics({k: res[k] for k in ("acc", "wa", "mif1", "maf1")}, compare="max"))
            self.metric_board.append({**res, "Lall": test_loss, "cm": cm}, step=self.eidx, stage="test")
            self.metric_board.flush()  # per test: a crash must not drop board rows
            self.log(f"Best Results {best}")
            self.pred_info.append([self._true, self._pred])
            self.pred_info.flush()
            is_best = res["f1"] >= self.best_f1
            if is_best:
                self.best_f1 = res["f1"]
            # with --select_on=val the val stage keeps best.model.ckpt
            if is_best and p.get("select_on", "test") == "test":
                self.save_model("best", is_best=True)
        res["Lall"] = test_loss
        self.log(f"test: Lall={test_loss:.5f} over {self._nll_n} utterances")
        if self.plateau_source == "test":
            self._plateau_step(test_loss if self._nll_n else None)
        self._fire("test_end", res)
        return res

    # ------------------------------------------------------------ checkpoints
    def state_tree(self) -> Dict[str, Any]:
        """What a checkpoint holds: the state dicts of the model, the
        optimizer and the plateau controller (where there is one), the
        dropout generator's state, the step, the epoch and the best test and
        val F1.  A subclass with state of its own adds it here and restores it
        in ``load_state_tree``.  On a model axis the optimizer's moments are
        gathered into the full parameters' layout (every rank calls it), so the
        tree is an unsharded run's."""
        opt = self.optimizer.state_dict()
        if self.model_axis is not None:
            opt = self.model_axis.full_state(opt)
        tree = {"model": self.model.state_dict(), "optimizer": opt,
                "rng": self._dropout_rng.get_state(), "step": self.global_steps, "eidx": self.eidx,
                "best_f1": self.best_f1, "best_val_f1": self.best_val_f1}
        if self.lr_sche is not None:
            tree["lr_sche"] = self.lr_sche.state_dict()
        return tree

    def save_model(self, tag: str = "last", is_best: bool = False) -> str:
        """``model.<tag>.ckpt`` (and, ``is_best``, ``best.model.ckpt``), its
        meta carrying ``params.hash()``."""
        path = self.saver.save_model(tag, self.state_tree(), is_best=is_best,
                                     meta={"eidx": self.eidx, "global_steps": self.global_steps,
                                           "params_hash": self.params.hash()})
        self.log(f"saved {path}")
        return path

    def save_checkpoint(self, is_best: bool = False, epoch_end: bool = False) -> str:
        """The rotating checkpoint; its meta records both counters, whether
        the epoch ended (``AutoResume`` continues at ``eidx + 1`` if so, else
        runs the epoch again) and ``params.resume_hash()`` (a relaunched
        ``--resume`` run finds sibling runs' checkpoints by it)."""
        return self.saver.save_checkpoint(
            self.global_steps, self.state_tree(), is_best=is_best,
            meta={"eidx": self.eidx, "global_steps": self.global_steps, "epoch_end": bool(epoch_end),
                  "params_hash": self.params.resume_hash()})

    def load_checkpoint(self, path: Optional[str] = None) -> str:
        """Restore a file of the Saver (the newest rotating checkpoint where
        ``path`` is None); returns its path."""
        self.initialize()
        path = path or self.saver.latest_checkpoint()
        if not path:
            raise FileNotFoundError(f"no checkpoint in {self.saver.save_dir}")
        self.load_state_tree(self.saver.load(path))
        return path

    def resume(self) -> Optional[str]:
        """``--resume``: restore the newest readable checkpoint of this run,
        else of a sibling run with the same ``params.resume_hash()``, and its
        counters (``callbacks.AutoResume``); returns its path, or None where
        there is none."""
        self.initialize()
        path = cbs.AutoResume().resume(self)
        self.sync_from_main()
        return path

    def load_pretrained(self, path: str) -> None:
        """``--pretrain``: the model and the optimizer state (its LR and a
        declared schedule's count with it) of ``path``, a file of the port's
        Saver or of the JAX package's (``checkpoint.read_train_state``), as
        the JAX package's ``AutoLoadModel`` loads a whole TrainState; the
        epoch, the step count, the generator and the best F1 stay."""
        self.initialize()
        self.load_state_tree(read_train_state(path, self), whole=False)
        self.sync_from_main()
        self.log(f"loaded pretrained state from {path}")

    def load_state_tree(self, tree: Dict[str, Any], whole: bool = True) -> None:
        """Restore what ``state_tree`` saved (the epoch is the saved one's);
        the captured graphs are dropped.  ``whole=False`` restores the
        model and the optimizer only (and a subclass's own training state)."""
        for graphs in (self._captured, self._captured_step):
            if graphs is not None:
                graphs.invalidate()
        self.model.load_state_dict(tree["model"])
        if "optimizer" in tree:
            load_optimizer_state(self.optimizer, tree["optimizer"])
        if self.model_axis is not None:  # the tree's moments are in the unsharded layout: take this rank's blocks
            self.model_axis.shard_state()
        if not whole:
            return
        if self.lr_sche is not None:
            self.lr_sche.load_state_dict(tree["lr_sche"])
        self._dropout_rng.set_state(tree["rng"])  # rank 0's stream: rank 0 wrote the file
        self.global_steps, self.eidx, self.best_f1 = tree["step"], tree["eidx"], tree["best_f1"]
        if mesh.data_index():  # another data rank goes on with a stream of its own, from the restored step
            self._dropout_rng.manual_seed(self.rng.seed_of(self._dropout_tag(), self.global_steps))
        self.best_val_f1 = tree.get("best_val_f1", float("-inf"))  # older checkpoints lack it


def _finite(t: torch.Tensor) -> bool:
    return not t.is_floating_point() or bool(torch.isfinite(t).all())  # waits for the device


@contextlib.contextmanager
def nan_checks(model: torch.nn.Module):
    """``--debug_nans`` around a forward and backward: ``FloatingPointError``
    at the first module whose forward output is not finite (forward hooks,
    innermost module first), or whose output's gradient is not finite
    (tensor hooks), and, under autograd's anomaly mode, where a backward
    function returns a non-finite gradient, naming the module whose output
    gradient autograd took last.  Every check reads back from the device, so
    it runs eagerly only."""
    names = {m: n or type(model).__name__ for n, m in model.named_modules()}
    last = {"module": None}

    def grad_hook(name, g):
        last["module"] = name
        if not _finite(g):
            raise FloatingPointError(f"--debug_nans: non-finite gradient of the output of module {name!r}")

    def forward_hook(m, args, out):
        name = names[m]
        for t in tensors(out):
            if not _finite(t):
                raise FloatingPointError(f"--debug_nans: non-finite forward output of module {name!r} "
                                         f"({type(m).__name__}, shape {tuple(t.shape)})")
            if t.requires_grad:
                t.register_hook(lambda g, name=name: grad_hook(name, g))

    handles = [m.register_forward_hook(forward_hook) for m in model.modules()]
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as e:
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(f"--debug_nans: non-finite gradient in the backward of module "
                                 f"{last['module']!r}: {e}") from e
    finally:
        for h in handles:
            h.remove()


def _rows(host_batch: Dict[str, np.ndarray]) -> int:
    """Rows of a host batch that are not padding: dialogues of length > 0, or
    utterances with ``sample_mask`` > 0 where the batch has no ``text_length``."""
    if host_batch.get("text_length") is not None:
        return int((host_batch["text_length"] > 0).sum())
    return int((host_batch["sample_mask"] > 0).sum())


def _out_slice(out, i: int):
    """Batch i's outputs of a stacked eval group (an array or a tuple of them)."""
    return tuple(o[i] for o in out) if isinstance(out, tuple) else out[i]


def _to_host(out):
    """Float32 numpy of the eval forward's output, or a tuple of them."""
    if isinstance(out, tuple):
        return tuple(_to_host(t) for t in out)
    return out.float().cpu().numpy()


def _fmt(values: Dict[str, float]) -> str:
    return ", ".join(f"{k}={v:.5f}" for k, v in values.items())
