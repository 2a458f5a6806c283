"""Seeds derived from one ``--seed``.

Port of ``erc_tpu.core.seed``'s host side: ``RngPool.numpy_rng(tag, *counters)``
is the same numpy generator as the JAX package's (the data shuffles match
batch for batch), and ``torch_generator`` gives a ``torch.Generator`` on a
device for dropout.  The JAX package's ``jax.random`` keys have no
counterpart: torch's streams differ from JAX's in any case.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def _tag_to_int(tag: str) -> int:
    return zlib.crc32(tag.encode()) & 0x7FFFFFFF


class RngPool:
    """Deterministic generators from one seed: a pure function of (seed, tag, counters)."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def numpy_rng(self, tag: str, *counters: int) -> np.random.Generator:
        """Host-side generator for data shuffling (per-epoch reshuffle etc.)."""
        s = [self.seed, _tag_to_int(tag), *map(int, counters)]
        return np.random.default_rng(np.array(s, dtype=np.uint64))

    def seed_of(self, tag: str, *counters: int) -> int:
        """A torch seed from (seed, tag, counters)."""
        return int(self.numpy_rng(tag, *counters).integers(0, 2**63 - 1))

    def torch_generator(self, tag: str, device) -> torch.Generator:
        """A generator on `device` seeded from (seed, tag)."""
        return torch.Generator(device=device).manual_seed(self.seed_of(tag))
