"""The eval forward captured on the card: one CUDA graph per shape bucket.

Port of the JAX package's compiled eval step: the JAX engine and the JAX
trainer's val and test stages run ``jax.jit`` of the eval forward, compiled
once per shape bucket (``erc_tpu/serve.py``, ``erc_tpu/train/trainer.py::
_install_eval_step``).  ``CapturedForward(fn, device)`` runs ``fn(batch)``
(a tensor, or a tuple of tensors) as one ``torch.cuda.CUDAGraph`` per
bucket:

- The bucket is the (key, shape, dtype) of each array of the batch (the
  engine's and the eval loaders' batches pad every array to the batch's
  (B, L), so that is their shape bucket).  The first batch of a bucket runs
  ``fn`` eagerly once on a side stream, as PyTorch's notes on CUDA graphs
  ask (cuBLAS and cuDNN allocate workspaces and pick algorithms on a first
  call; K3 sets its attributes and queries its occupancy), with a dict that
  records which keys ``fn`` reads.  Then ``fn`` is captured from static
  inputs of the keys that this bucket's warm-up read, and only those are
  staged and copied.
- A call fills pinned staging buffers of the bucket from the host batch,
  copies them into the static inputs without blocking, replays the graph,
  copies the static outputs into pinned buffers and waits for them: one
  stream sync a call.  Every call ends on that sync, so no staging copy is
  in flight when the next call refills the buffers.
- All the graphs of one ``CapturedForward`` share one memory pool.  That is
  safe because each call copies its outputs out before the next replay.
- The kernel wrappers count launches in Python, where a replay does not
  pass: the counts that a capture made are taken back and added again on
  every replay, so a replayed forward counts what an eager one does
  (``chip_smoke.py`` holds them against a device trace of the replays).
- Graphs read the parameters by address: ``watch`` gives the tensors to
  check, and a call raises once one was replaced rather than written in
  place (``invalidate`` drops the graphs after a deliberate replacement).

A capture that fails raises: nothing falls back to the eager forward.
Everything runs under ``torch.inference_mode``, where the static buffers
are made.  Only the card: the CPU route calls ``fn`` eagerly and never
builds one of these.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch


def _counters() -> List[dict]:
    """The launch counters of the kernel wrappers."""
    from erc_tpu_torch.ops.kernels import banded as kb, dag_block as kd

    return [kb.launches, kb.variant_launches, kb.tap_launches, kd.launches, kd.variant_launches]


class _ReadLog(dict):
    """A dict that records the keys read from it (iterating reads them all)."""

    def __init__(self, data: Dict[str, torch.Tensor]):
        super().__init__(data)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if k in self:
            self.read.add(k)
        return super().get(k, default)

    def __contains__(self, k):
        found = super().__contains__(k)
        if found:
            self.read.add(k)
        return found

    def _all(self):
        self.read.update(super().keys())

    def __iter__(self):
        self._all()
        return super().__iter__()

    def keys(self):
        self._all()
        return super().keys()

    def values(self):
        self._all()
        return super().values()

    def items(self):
        self._all()
        return super().items()


def host_array(v: np.ndarray) -> np.ndarray:
    """A batch array as the card takes it: float32 for floating data."""
    v = np.asarray(v)
    return v.astype(np.float32) if v.dtype.kind == "f" and v.dtype != np.float32 else v


class _Bucket:
    """One captured graph, its static and pinned buffers (of the keys its
    warm-up read) and the launch counts its capture recorded."""

    def __init__(self, graph, inputs, outputs, is_tuple, counts):
        self.graph = graph
        self.inputs = inputs
        self.staging = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for k, t in inputs.items()}
        self.outputs = outputs
        self.host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outputs)
        self.is_tuple = is_tuple
        self.counts = counts


class CapturedForward:
    def __init__(self, fn: Callable, device: torch.device,
                 watch: Optional[Callable[[], Iterable[torch.Tensor]]] = None):
        """fn(batch: Dict[str, Tensor]) -> Tensor or tuple of Tensors on
        ``device`` (a CUDA device); ``watch()`` the tensors ``fn`` reads by
        address (parameters, buffers)."""
        if device.type != "cuda":
            raise ValueError(f"CapturedForward runs on a CUDA device, not {device}")
        self.fn, self.device, self.watch = fn, device, watch
        self.keys: set = set()  # the keys fn read, over every bucket's warm-up
        self.replays = 0
        self.captures = 0
        self._buckets: Dict[Tuple, _Bucket] = {}
        self._pool = None
        self._stream = None
        self._addresses: Optional[List[int]] = None

    def invalidate(self) -> None:
        """Drop every graph (after parameters were replaced, not written in place)."""
        self._buckets.clear()
        self._pool = None
        self._addresses = None

    @staticmethod
    def _bucket_key(arrays: Dict[str, np.ndarray]) -> Tuple:
        return tuple((k, v.shape, v.dtype.str) for k, v in sorted(arrays.items()))

    def addresses_unchanged(self) -> bool:
        """Whether every watched tensor is where it was when the first graph was captured."""
        return self.watch is None or self._addresses in (None, [t.data_ptr() for t in self.watch()])

    def _check_addresses(self) -> None:
        if self.watch is None:
            return
        if self._addresses is None:
            self._addresses = [t.data_ptr() for t in self.watch()]
        elif not self.addresses_unchanged():
            raise RuntimeError("a tensor that the captured graphs read was replaced, not written in place: "
                               "call invalidate() after replacing parameters")

    def __call__(self, host_batch: Dict[str, np.ndarray]):
        """The outputs of ``fn`` on one host batch (numpy arrays), as float32
        numpy arrays on the host: one array, or a tuple where ``fn`` returns one."""
        arrays = {k: host_array(v) for k, v in host_batch.items() if v is not None}
        with torch.inference_mode():
            self._check_addresses()
            bucket = self._buckets.get(self._bucket_key(arrays))
            if bucket is None:
                bucket = self._capture(arrays)
            return self._replay(bucket, arrays)

    def _capture(self, arrays: Dict[str, np.ndarray]) -> _Bucket:
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        full = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        side.wait_stream(torch.cuda.current_stream(dev))
        log = _ReadLog(full)
        with torch.cuda.stream(side):
            self.fn(log)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.keys |= log.read
        inputs = {k: full[k] for k in sorted(log.read)}
        counters = _counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=side):
            out = self.fn(dict(inputs))
        counts = []
        for c, b in zip(counters, before):
            counts.append({k: c[k] - b[k] for k in c if c[k] != b[k]})
            c.update(b)  # the capture launched nothing; each replay adds these
        is_tuple = isinstance(out, tuple)
        outputs = tuple(out) if is_tuple else (out,)
        bucket = _Bucket(graph, inputs, outputs, is_tuple, counts)
        self._buckets[self._bucket_key(arrays)] = bucket
        self.captures += 1
        return bucket

    def _replay(self, bucket: _Bucket, arrays: Dict[str, np.ndarray]):
        for k, staged in bucket.staging.items():
            staged.copy_(torch.from_numpy(arrays[k]))  # torch's copy runs on the intra-op threads
            bucket.inputs[k].copy_(staged, non_blocking=True)
        bucket.graph.replay()
        for host, out in zip(bucket.host, bucket.outputs):
            host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        for c, delta in zip(_counters(), bucket.counts):
            for k, n in delta.items():
                c[k] += n
        self.replays += 1
        outs = tuple(h.numpy().astype(np.float32, copy=True) for h in bucket.host)
        return outs if bucket.is_tuple else outs[0]
