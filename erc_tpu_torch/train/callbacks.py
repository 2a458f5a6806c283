"""Hook-based callbacks of the train loop.

Port of ``erc_tpu.train.callbacks``, with the same classes, hooks and
priorities.  Hook protocol — any subset of:
    train_begin(tr) / train_end(tr)
    train_epoch_begin(tr, eidx) / train_epoch_end(tr, eidx, record)
    train_step_end(tr, bidx, mets)
    epoch_end(tr, eidx, result)
    eval_begin(tr) / eval_end(tr, res)
    test_begin(tr) / test_end(tr, res)
    exception(tr, e)

``train_step_end`` gets the call's metrics as tensors on the device; a
callback reads one back only where it must (``NaNGuard``, every
``check_every`` steps), since a read waits for the device.  ``global_steps``
grows by K a call at ``--steps_per_call=K``, so step cadences are
thresholds, not moduli.  ``epoch_end`` is the port's own hook: it fires
after the epoch's val and test stages with the epoch's record (``train()``'s
history entry), so that ``EpochCheckpoint`` and ``KeypointCheckpoint`` save
the state that the epoch's test stage left (its best F1) and mark the best
epoch's checkpoint as ``best.checkpoint.ckpt``, as the port's trainer did
before it had callbacks.  The JAX package saves them at
``train_epoch_end``, before the test stage.

No callback draws from the dropout generator or touches batch-norm
statistics: a run gives the same losses with or without them.

Under a process group (``parallel.mesh``) a decision that steers the loop is
taken once and shared, as in the JAX package: ``StopByCode`` polls the
``.stop`` file on rank 0 and broadcasts what it found, and ``AutoResume``
picks the checkpoint on rank 0 and every rank restores that one file (a rank
that resumed elsewhere, or not at all, would desynchronise the collectives).
The metrics a callback reads (``NaNGuard``'s loss) are the global batch's on
every rank, and the writes go through the Saver and the experiment, which
write on rank 0 only.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional

from erc_tpu_torch.parallel import mesh


class Callback:
    priority = 100

    def hook(self, trainer):
        trainer.callbacks.append(self)
        trainer.callbacks.sort(key=lambda c: getattr(c, "priority", 100))
        return self


class EpochCheckpoint(Callback):
    """A rotating checkpoint every ``per_epoch`` epochs, after the epoch's
    val and test stages; the best epoch's so far by test F1 (by val F1 with
    ``--select_on=val``) is also ``best.checkpoint.ckpt``."""

    def __init__(self, per_epoch: int = 1):
        self.per_epoch = per_epoch

    def epoch_end(self, tr, eidx, result):
        if (eidx + 1) % self.per_epoch == 0:
            tr.save_checkpoint(is_best=tr.is_best_epoch(result), epoch_end=True)


class GlobalStepCheckpoint(Callback):
    def __init__(self, per_step: int = 1000):
        self.per_step = per_step
        self._last = 0

    def train_step_end(self, tr, bidx, mets):
        # threshold, not modulo: global_steps advances by steps_per_call
        # per iteration and may never hit an exact multiple
        if tr.global_steps - self._last >= self.per_step:
            self._last = tr.global_steps
            tr.save_checkpoint()


class KeypointCheckpoint(Callback):
    """Permanent (never-pruned) `key.N.ckpt` saves every N epochs — the
    reference's keypoint tier (saver.py:133-146) for runs that need
    archaeology beyond the rotating checkpoints."""

    def __init__(self, per_epoch: int = 10):
        self.per_epoch = per_epoch

    def epoch_end(self, tr, eidx, result):
        if (eidx + 1) % self.per_epoch == 0:
            tr.saver.save_keypoint(tr.global_steps, tr.state_tree(),
                                   meta={"eidx": eidx, "global_steps": tr.global_steps})


class KeyErrorSave(Callback):
    """Checkpoint on KeyboardInterrupt (callbacks.py:548-569).  Not on a model
    axis: its save gathers the moments over the model group, a collective
    that ranks stopped at other points, or not stopped, would never join; the
    rotating checkpoints stand there."""

    def exception(self, tr, e):
        if isinstance(e, KeyboardInterrupt):
            if tr.model_axis is not None:
                tr.log("interrupted — no checkpoint saved: on a model axis the save is a collective")
                return
            path = tr.save_checkpoint()
            tr.log(f"interrupted — checkpoint saved to {path}")


class StopByCode(Callback):
    """Graceful stop when `<test_dir>/.stop` appears (callbacks.py:745-755),
    polled every ``check_every`` steps (``python -m erc_tpu_torch.cli stop``
    makes the file), on rank 0, whose answer every rank takes: ranks that
    polled for themselves could see the file a step apart and stop on
    different steps, leaving a collective waiting."""

    def __init__(self, check_every: int = 100):
        self.check_every = check_every
        self._last = 0

    def train_step_end(self, tr, bidx, mets):
        if tr.global_steps - self._last >= self.check_every or tr.global_steps == 0:
            self._last = tr.global_steps
            found = mesh.is_main_process() and os.path.exists(os.path.join(tr.exp.test_dir, ".stop"))
            if mesh.broadcast_one_to_all(found):
                tr.log(".stop file found — stopping")
                tr.stopped = True


class AutoLoadModel(Callback):
    """Load pretrain_path at train start (callbacks.py:588-602): the model
    and optimizer state of a file of either package's Saver
    (``Trainer.load_pretrained``)."""

    def train_begin(self, tr):
        path = tr.params.get("pretrain_path")
        # `pretrain` defaults False, exactly like the reference gate
        # (callbacks.py:599) — trainers that give pretrain_path their own
        # semantics (mmin_miss/miss2 warm-starts) never trip this
        if path and tr.params.get("pretrain", False):
            tr.load_pretrained(path)


class AutoResume(Callback):
    """Resume from the latest checkpoint if one exists (preemption-safe).

    Restores the state (``Trainer.load_checkpoint``: model, optimizer, the
    dropout generator, the best F1) and BOTH counters from the meta sidecar:
    global_steps (so new checkpoint step numbers continue instead of
    restarting at 0) and eidx (the train loop starts its epoch range there;
    epoch-end checkpoints resume at eidx+1, mid-epoch ones re-run the
    interrupted epoch)."""

    def train_begin(self, tr):
        self.resume(tr)

    def resume(self, tr) -> Optional[str]:
        """Restore the newest readable checkpoint; returns its path, or None
        where there is none.  Under a process group rank 0 picks it (reading
        it is the test that it is whole) and every other rank restores the
        same file."""
        path = mesh.broadcast_one_to_all(self._newest(tr) if mesh.is_main_process() else None)
        if path is not None and not mesh.is_main_process():
            self._restore(tr, path)
        return path

    def _newest(self, tr) -> Optional[str]:
        """Restore the newest readable checkpoint of this run, else of a sibling;
        its path, or None."""
        # Saver writes are atomic (tmp+rename), but a file can still arrive
        # corrupt (partial disk, torn copy) — walk own checkpoints newest
        # first, then hash-matching siblings (a relaunched job gets a FRESH
        # test dir, so its own saver is usually empty — and a run whose OWN
        # files are all corrupt must still reach an intact sibling)
        candidates = list(reversed(tr.saver.list_checkpoints()))
        candidates += self._sibling_checkpoints(tr)
        for latest in candidates:
            try:
                self._restore(tr, latest)
            except Exception as e:  # corrupt/truncated (torch.load raises many kinds) → try the next-oldest
                tr.logger.warn(f"unreadable checkpoint {latest}: {e!r}")
                continue
            return latest
        return None

    @staticmethod
    def _restore(tr, latest: str) -> None:
        """The state of checkpoint ``latest`` and both counters of its meta."""
        tr.load_checkpoint(latest)
        meta_path = latest + ".json"
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            # pre-atomic writers could tear the sidecar; a .ckpt without
            # meta resumes with default counters (re-runs the epoch)
            meta = {}
        if meta:
            tr.eidx = int(meta.get("eidx", tr.eidx)) + (
                1 if meta.get("epoch_end") else 0
            )
            tr.global_steps = int(meta.get("global_steps", tr.global_steps))
        tr.log(f"resumed from {latest} (eidx={tr.eidx}, global_steps={tr.global_steps})")

    @staticmethod
    def _sibling_checkpoints(tr):
        """All hash-matching sibling checkpoints, newest first — a list so
        the resume loop can fall back past a corrupt newest sibling too."""
        import glob

        exp_blob = os.path.dirname(tr.exp.blob_dir)  # <blobroot>/<exp_name>
        want_hash = tr.params.resume_hash()
        candidates = []
        for path in glob.glob(os.path.join(exp_blob, "*", "saver", "checkpoint.*.ckpt")):
            if os.path.dirname(os.path.dirname(path)) == tr.exp.blob_dir:
                continue  # own run (already checked)
            # a sibling is acceptable ONLY with a readable meta sidecar whose
            # params_hash matches — a hash-less/meta-less checkpoint may come
            # from an incompatible config and must not be silently resumed
            meta_path = path + ".json"
            try:
                with open(meta_path) as f:
                    h = json.load(f).get("params_hash")
            except (OSError, json.JSONDecodeError):
                continue
            if h != want_hash:
                continue  # different (or unknown) config — do not resume
            candidates.append(path)
        return sorted(candidates, key=os.path.getmtime, reverse=True)


class EvalFirst(Callback):
    """Evaluate before the first train step (callbacks.py:605-619) — the
    sanity check that a loaded checkpoint scores what it should."""

    # callbacks fire in ascending priority: must be AFTER AutoLoadModel /
    # AutoResume (100) so the restored weights are what gets evaluated
    priority = 110

    def train_begin(self, tr):
        tr.log("EvalFirst: running test() before training")
        tr.test()


class FinalReport(Callback):
    """End-of-run property dump (reference exphook.py:188-202): best
    metrics + run location, printed and saved."""

    def train_end(self, tr):
        best = tr.database.todict()
        tr.log(f"final report: {tr.exp.exp_name}/{tr.exp.test_name}")
        if best:
            tr.log(
                "best: " + ", ".join(
                    f"{k}={v:.5f}" for k, v in best.items()
                    if isinstance(v, (int, float))
                )
            )
        tr.exp.dump_info("report", {"best": best, "global_steps": tr.global_steps,
                                    "epochs": tr.eidx + 1})


class MemoryMonitor(Callback):
    """Log per-epoch device-memory peaks (reference capability:
    lumo/sketch/memory_grab.py's GPU-memory watchdog → the caching
    allocator's counters via core/memstat.py).  Warns when the memory in
    use crosses `warn_frac` of the card's; logs the live-tensor census at
    that point so the holder is identified before an OOM, not after.  Not
    installed by ``icallbacks`` (as in the JAX package): hook it."""

    def __init__(self, warn_frac: float = 0.9):
        self.warn_frac = warn_frac
        self._warned = False

    def train_epoch_end(self, tr, eidx, record):
        from erc_tpu_torch.core import memstat

        stats = memstat.device_memory_stats(tr.device)
        if stats is None:
            return
        peak = stats.get("peak_bytes_in_use", stats["bytes_in_use"])
        msg = f"HBM in_use={stats['bytes_in_use'] / 2**20:.0f}MiB peak={peak / 2**20:.0f}MiB"
        limit = stats.get("bytes_limit")
        if limit:
            msg += f" limit={limit / 2**20:.0f}MiB"
        tr.log(msg)
        if limit and not self._warned and stats["bytes_in_use"] > self.warn_frac * limit:
            self._warned = True
            tr.logger.warn(
                "HBM above %.0f%% of limit — live arrays:\n%s"
                % (100 * self.warn_frac, memstat.memory_report())
            )


class NaNGuard(Callback):
    """Abort (with a checkpoint) on a non-finite loss, read back from the
    device every ``check_every`` steps."""

    def __init__(self, check_every: int = 10):
        self.check_every = check_every
        self._last = 0

    def train_step_end(self, tr, bidx, mets):
        if tr.global_steps - self._last < self.check_every:
            return
        self._last = tr.global_steps
        v = mets.get("Lall")
        if v is not None and not math.isfinite(float(v)):
            tr.save_checkpoint()
            raise FloatingPointError(
                f"non-finite loss at step {tr.global_steps}: {v}"
            )


class TensorBoardCallback(Callback):
    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self.writer = None

    def train_begin(self, tr):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(self.log_dir or tr.exp.blob_file("", "board"))
        except ImportError:
            tr.logger.warn("tensorboard unavailable — TensorBoardCallback disabled")

    def _scalar(self, tag, v, step):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            self.writer.add_scalar(tag, v, step)

    def train_epoch_end(self, tr, eidx, record):
        if self.writer:
            for k, v in record.agg().items():
                self._scalar(f"train/{k}", v, eidx)

    def test_end(self, tr, res):
        if self.writer:
            for k, v in res.items():
                self._scalar(f"test/{k}", v, tr.eidx)

    def train_end(self, tr):
        if self.writer:
            self.writer.close()


class WandbCallback(Callback):
    def __init__(self, project: str = "erc_tpu_torch"):
        self.project = project
        self.run = None

    def train_begin(self, tr):
        try:
            import wandb

            self.run = wandb.init(
                project=self.project, name=tr.exp.test_name, config=tr.params.to_dict()
            )
        except Exception:
            tr.logger.warn("wandb unavailable — WandbCallback disabled")

    def train_epoch_end(self, tr, eidx, record):
        if self.run:
            self.run.log({f"train/{k}": v for k, v in record.agg().items()}, step=eidx)

    def test_end(self, tr, res):
        if self.run:
            self.run.log(
                {f"test/{k}": v for k, v in res.items() if isinstance(v, (int, float))}
            )


class RemoteCallback(Callback):
    """POST per-epoch metrics to an HTTP endpoint (callbacks.py:772-864)."""

    def __init__(self, url: str, timeout: float = 2.0):
        self.url = url
        self.timeout = timeout

    def _post(self, payload):
        import urllib.request

        req = urllib.request.Request(
            self.url,
            data=json.dumps(payload, default=str).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(req, timeout=self.timeout)
        except Exception:
            pass  # observability must never kill training

    def train_epoch_end(self, tr, eidx, record):
        self._post({"stage": "train", "epoch": eidx, **record.agg()})

    def test_end(self, tr, res):
        self._post(
            {"stage": "test", "epoch": tr.eidx,
             **{k: v for k, v in res.items() if isinstance(v, (int, float))}}
        )


class NotionCallback(Callback):
    """Experiment rows in a Notion database (reference: contrib/notion_cb.py:149).

    Posts one page per test with dataset / params-hash / best-metric
    properties via the public Notion API; disabled unless both token and
    database id are provided.  Failures never interrupt training."""

    def __init__(self, token: str, database_id: str, timeout: float = 3.0):
        self.token = token
        self.database_id = database_id
        self.timeout = timeout
        self.page_id = None

    def _req(self, method, url, payload):
        import urllib.request

        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode(),
            headers={
                "Authorization": f"Bearer {self.token}",
                "Content-Type": "application/json",
                "Notion-Version": "2022-06-28",
            },
            method=method,
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def train_begin(self, tr):
        props = {
            "Name": {"title": [{"text": {"content": tr.exp.test_name}}]},
            "dataset": {"rich_text": [{"text": {"content": str(tr.params.get("dataset"))}}]},
            "params_hash": {"rich_text": [{"text": {"content": tr.params.hash()}}]},
        }
        out = self._req(
            "POST", "https://api.notion.com/v1/pages",
            {"parent": {"database_id": self.database_id}, "properties": props},
        )
        if out:
            self.page_id = out.get("id")

    def test_end(self, tr, res):
        if not self.page_id:
            return
        props = {
            k: {"number": float(v)}
            for k, v in res.items()
            if isinstance(v, (int, float)) and k in ("f1", "acc", "wa", "maf1")
        }
        self._req(
            "PATCH", f"https://api.notion.com/v1/pages/{self.page_id}",
            {"properties": props},
        )
