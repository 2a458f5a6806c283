"""Deterministic host-side input pipeline.

Port of ``erc_tpu.data.loader.DialogueLoader``: per-epoch shuffle from an
explicit generator, an optional length-sorted mode that groups
similar-length dialogues to cut padding, ``batch_count`` to cut or cycle an
epoch, and ``drop_last``.  The same seed gives the same batches as the JAX
package's loader.  Over several processes (``rank`` of ``world``) every rank
computes the same global order and takes rows ``rank::world`` of each global
batch, as the JAX loader does; the batcher's ``shard`` pads them to ⌈B /
world⌉ rows and to the whole batch's length bucket (the JAX package pads each
process's rows to its own longest), so every rank's batch has one shape on
every step, and the ranks capture on the same steps and group the same K
batches.  ``to_device`` copies a batch to the card from
pinned memory without blocking the host, floating arrays in float32, or in
bfloat16 under ``--transfer_dtype=bfloat16`` (``core.cuda_graphs.host_tensor``).

The wrappers of ``erc_tpu.data.loader`` (each forwards ``len`` and
``set_epoch``); the trainer's pipeline stacks the last two on a loader:

- ``MappedLoader(loader, fn)``: ``fn`` of every batch; ``transfer_cast_fn``
  gives the JAX package's ``--transfer_dtype`` cast.  numpy has no bfloat16,
  so the port's cast rounds float32 arrays to bfloat16 (nearest even,
  through torch on the CPU) and keeps them float32: the values the JAX
  package's ``ml_dtypes`` arrays hold.  The trainer does not use it: its
  copy into the bfloat16 staging (``host_tensor``) rounds the same way;
- ``GroupedLoader(loader, k)``: ``(stacked [K, B, ...], K)`` for each K
  consecutive batches of one shape, ``(batch, 1)`` for the batches of a
  shape change or an epoch's tail; ``len`` stays the number of steps.  The
  group is a ``StackedGroup``: a key is stacked at its first read, and the
  captured graphs copy each batch straight into its slice of the pinned
  staging (``batches``), so that no key is stacked on the hot path (a
  stacked copy of a COGMEN group of 4 is 70 MB);
- ``PrefetchLoader(loader, depth)``: a producer thread runs the loader (and
  the wrappers under it) ``depth`` items ahead through a bounded queue; an
  exception in it reaches the consumer, and a consumer that stops early
  stops and joins it.  The trainer gives it numpy work only (collation and
  grouping): a CUDA call from another thread while the main
  thread captures a CUDA graph (``capture_error_mode="global"``) would
  break the capture, so staging and copies stay on the main thread.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Mapping
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from erc_tpu_torch.core.cuda_graphs import host_tensor
from erc_tpu_torch.core.seed import RngPool
from erc_tpu_torch.data.collate import ERCBatcher


class DialogueLoader:
    """Epoch iterator over dialogue samples.

    sort_by_length is a *bucketed* shuffle, not a global sort: the shuffled
    order is cut into chunks of ``sort_chunk`` batches, each chunk is sorted
    by dialogue length, and then the batch order is reshuffled, so the
    gradient sequence stays shuffled with no short → long curriculum.
    """

    def __init__(
        self,
        samples: List[dict],
        batcher: ERCBatcher,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        sort_by_length: bool = False,
        sort_chunk: int = 8,
        batch_count: Optional[int] = None,
        rank: int = 0,
        world: int = 1,
    ):
        self.samples = samples
        self.rank, self.world = int(rank), int(world)
        self.batcher = batcher
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = RngPool(seed)
        self.sort_by_length = sort_by_length
        self.sort_chunk = max(int(sort_chunk), 1)
        # epoch length: truncate when shorter, cycle when longer
        self.batch_count = batch_count
        self.epoch = 0

    def __len__(self):
        if self.batch_count is not None:
            return int(self.batch_count)
        n = len(self.samples)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _batch_indices(self) -> List[np.ndarray]:
        """This epoch's batches as index arrays."""
        n = len(self.samples)
        if self.shuffle:
            order = self.rng.numpy_rng("shuffle", self.epoch).permutation(n)
        else:
            order = np.arange(n)
        bs = self.batch_size
        if self.sort_by_length and n:
            chunk = bs * self.sort_chunk
            lens = np.array([len(self.samples[i]["label"]) for i in order])
            pieces = [
                order[s : s + chunk][np.argsort(lens[s : s + chunk], kind="stable")]
                for s in range(0, n, chunk)
            ]
            order = np.concatenate(pieces)
        n_full = n // bs
        end = n_full * bs if self.drop_last else n
        batches = [order[s : s + bs] for s in range(0, end, bs)]
        if self.shuffle and self.sort_by_length and len(batches) > 1:
            perm = self.rng.numpy_rng("batch_order", self.epoch).permutation(len(batches))
            batches = [batches[i] for i in perm]
        return batches

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()
        if self.batch_count is not None and batches:
            want = int(self.batch_count)
            # cycle deterministically when the epoch is shorter than asked
            batches = [batches[i % len(batches)] for i in range(want)]
        for idx in batches:
            samples = [self.samples[i] for i in idx]
            yield self.batcher(samples) if self.world == 1 else self.batcher.shard(samples, self.rank, self.world)
        self.epoch += 1


def stack_batches(batches: List[dict]) -> dict:
    """Stack K same-shape host batches → {key: [K, B, ...]} (None passes)."""
    out = {}
    for k in batches[0]:
        if batches[0][k] is None:
            out[k] = None
        else:
            out[k] = np.stack([np.asarray(b[k]) for b in batches])
    return out


class StackedGroup(Mapping):
    """K same-shape host batches read as ``{key: [K, B, ...]}``
    (``stack_batches``' result), each key stacked at its first read; the K
    batches themselves in ``batches``."""

    def __init__(self, batches: List[dict]):
        self.batches = batches
        self._stacked: Dict[str, Optional[np.ndarray]] = {}

    def __getitem__(self, key):
        if key not in self._stacked:
            first = self.batches[0][key]
            self._stacked[key] = None if first is None else np.stack([np.asarray(b[key]) for b in self.batches])
        return self._stacked[key]

    def __iter__(self):
        return iter(self.batches[0])

    def __len__(self):
        return len(self.batches[0])


class MappedLoader:
    """Apply ``fn`` to every yielded batch (the transfer-dtype cast)."""

    def __init__(self, loader, fn):
        self.loader = loader
        self.fn = fn

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        return (self.fn(b) for b in self.loader)


def bfloat16_round(v: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest even), kept as float32."""
    return torch.from_numpy(v).to(torch.bfloat16).to(torch.float32).numpy()


def transfer_cast_fn(dtype):
    """Batch-cast fn for ``--transfer_dtype``: float32 arrays rounded to
    bfloat16 values (kept float32, see the module's note); other arrays pass
    through.  None when dtype is float32 (no cast needed)."""
    if not dtype or str(dtype) == "float32":
        return None
    if str(dtype) != "bfloat16":
        raise ValueError(f"--transfer_dtype={dtype}: float32 or bfloat16")

    def cast(batch):
        return {k: (bfloat16_round(v) if isinstance(v, np.ndarray) and v.dtype == np.float32 else v)
                for k, v in batch.items()}

    return cast


class GroupedLoader:
    """Group K consecutive same-shape batches into stacked [K, B, ...] arrays
    for the K-step replay (``steps_per_call`` > 1).

    Yields ``(stacked_or_batch, k)``: k > 1 a stacked group, k == 1 a plain
    leftover batch (the tail of the epoch, or a shape change under length
    bucketing: ``np.stack`` needs one shape)."""

    def __init__(self, loader, k: int):
        self.loader = loader
        self.k = max(int(k), 1)

    def __len__(self):
        # the underlying batch count: optimizer steps, not yielded items
        return len(self.loader)

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    @staticmethod
    def _shape_key(batch: dict) -> tuple:
        return tuple((kk, tuple(np.asarray(v).shape)) for kk, v in sorted(batch.items()) if v is not None)

    _stack = StackedGroup

    def __iter__(self):
        group = []
        for batch in self.loader:
            if group and self._shape_key(batch) != self._shape_key(group[0]):
                yield from self._flush(group)
                group = []
            group.append(batch)
            if len(group) == self.k:
                yield self._stack(group), self.k
                group = []
        yield from self._flush(group)

    def _flush(self, group):
        # a partial group runs single steps: a stacked group of k' != k
        # batches would capture another graph
        for b in group:
            yield b, 1


class PrefetchLoader:
    """Run ``loader`` in a producer thread, ``depth`` items ahead: the
    collation of batch N+1 overlaps step N.  Unlike the JAX package's, it
    takes no ``place_fn``: placing a batch on the card is a CUDA call, which
    stays on the trainer's thread."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer is gone, so that
            # an epoch stopped early never leaves the producer blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self.loader:
                    if not put(b):
                        return
                put(end)
            except BaseException as e:  # reaches the consumer, never truncates the epoch silently
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:  # also on GeneratorExit: unblock and join the producer
            stop.set()
            t.join()


def to_device(batch: Dict[str, np.ndarray], device: torch.device,
              transfer_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """A packed batch as tensors on `device`, floating arrays in
    ``transfer_dtype`` (``host_tensor``); to a card from pinned memory,
    without blocking the host.  Arrays that are None are left out."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        t = host_tensor(v, transfer_dtype)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
