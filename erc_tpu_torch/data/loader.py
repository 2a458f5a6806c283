"""Deterministic host-side input pipeline.

Port of ``erc_tpu.data.loader.DialogueLoader`` for one process: per-epoch
shuffle from an explicit generator, an optional length-sorted mode that
groups similar-length dialogues to cut padding, ``batch_count`` to cut or
cycle an epoch, and ``drop_last``.  The same seed gives the same batches as
the JAX package's loader.  ``to_device`` copies a batch to the card from
pinned memory without blocking the host, floating arrays in float32, or in
bfloat16 under ``--transfer_dtype=bfloat16`` (``core.cuda_graphs.host_tensor``).
"""

from __future__ import annotations

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
    ):
        self.samples = samples
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
            yield self.batcher([self.samples[i] for i in idx])
        self.epoch += 1


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
