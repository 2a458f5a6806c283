"""The trainer's precision knobs: ``--compute_dtype``, ``--transfer_dtype``
and ``--matmul_precision``.

Port of the JAX trainer's ``cast_floats`` and of its ``matmul_precision``
setting (``erc_tpu/train/trainer.py``):

- ``cast_floats(batch, dtype)`` casts the floating tensors of a batch to a
  compute dtype, down (the bfloat16 train step) or up (a batch that crossed
  to the card in bfloat16, which the float32 steps restore at entry);
  integer and boolean tensors pass through.  It is a view that casts a key
  when it is read (once), so that a captured graph still stages only the
  keys its function reads.
- ``fp32_precision(name)`` maps ``--matmul_precision`` onto torch's
  ``fp32_precision``: ``highest``/``float32`` are strict float32 ("ieee"),
  ``high``/``tensorfloat32`` TF32 ("tf32") in cuBLAS and in cuDNN's RNNs and
  convolutions.  ``bfloat16``/``default``/``fastest`` (the TPU's single
  bfloat16 pass of float32 products) raise: cuBLAS has no such product of
  float32 inputs that torch exposes.
- ``scoped(precision)`` sets it for a block and restores the previous
  settings after.  The trainer wraps its own steps, captures and eval stages
  in it, so one trainer's choice never reaches another in the same process
  (the JAX package sets ``jax_default_matmul_precision`` for the process).
  ``cudnn_fp32()`` is the cuDNN setting of the innermost scope, which
  ``ops.rnn.cudnn_full_fp32`` applies ("ieee" outside every scope).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Mapping

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

MATMUL_PRECISIONS = {"highest": "ieee", "float32": "ieee", "high": "tf32", "tensorfloat32": "tf32"}

_cudnn = ["ieee"]  # a stack: the innermost scope's cuDNN float32 precision last


def dtype_of(name) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (or None: float32) as a torch dtype."""
    try:
        return DTYPES[str(name or "float32")]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}: use one of {sorted(DTYPES)}") from None


def fp32_precision(name) -> str:
    """``--matmul_precision`` as torch's ``fp32_precision`` ("ieee" or "tf32")."""
    name = str(name or "highest")
    if name in MATMUL_PRECISIONS:
        return MATMUL_PRECISIONS[name]
    if name in ("bfloat16", "default", "fastest"):
        raise ValueError(f"--matmul_precision={name}: cuBLAS has no bfloat16-pass product of float32 inputs that "
                         "torch exposes; use --compute_dtype=bfloat16 for bfloat16 products, or "
                         "--matmul_precision=highest|tensorfloat32")
    raise ValueError(f"unknown --matmul_precision {name!r}: use one of {sorted(MATMUL_PRECISIONS)}")


class _Cast(Mapping):
    """A batch read through a cast: each floating tensor in ``dtype``, cast
    when its key is first read."""

    def __init__(self, batch: Mapping[str, torch.Tensor], dtype: torch.dtype):
        self._batch, self._dtype, self._done = batch, dtype, {}

    def __getitem__(self, k: str) -> torch.Tensor:
        if k not in self._done:
            v = self._batch[k]
            self._done[k] = v.to(self._dtype) if v.is_floating_point() and v.dtype != self._dtype else v
        return self._done[k]

    def __contains__(self, k) -> bool:
        return k in self._batch

    def __iter__(self):
        return iter(self._batch)

    def __len__(self) -> int:
        return len(self._batch)


def cast_floats(batch: Mapping[str, torch.Tensor], dtype: torch.dtype) -> Mapping[str, torch.Tensor]:
    """The batch with every floating tensor in ``dtype`` (cast as read);
    integer and boolean tensors as they are."""
    return _Cast(batch, dtype)


def cudnn_fp32() -> str:
    """cuDNN's float32 precision for RNNs and convolutions in the innermost
    ``scoped`` block: "tf32" under ``--matmul_precision=high``, else "ieee"."""
    return _cudnn[-1]


@contextlib.contextmanager
def scoped(precision: str) -> Iterator[None]:
    """cuBLAS's float32 products at ``precision`` ("ieee" or "tf32") within
    the block, and cuDNN's where ``ops.rnn.cudnn_full_fp32`` guards them;
    the previous settings after."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    matmul.fp32_precision = precision
    _cudnn.append(precision)
    try:
        yield
    finally:
        _cudnn.pop()
        matmul.fp32_precision = prev
