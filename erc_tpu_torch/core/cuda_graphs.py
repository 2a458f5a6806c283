"""The eval forward and the train step captured on the card: one CUDA graph
per shape bucket.

Port of the JAX package's compiled steps: the JAX engine and the JAX
trainer's val and test stages run ``jax.jit`` of the eval forward, and the
JAX trainer ``jax.jit`` of its train step (forward, backward, optax's clip
and update, the LR an injected hyperparameter), each compiled once per
shape bucket (``erc_tpu/serve.py``, ``erc_tpu/train/trainer.py::
_install_eval_step, _make_raw_train_step``).  ``CapturedForward(fn,
device)`` runs ``fn(batch)`` (a tensor, or a tuple of tensors) and
``CapturedStep(fn, device)`` runs ``fn(batch)`` (a dict of 0-d metrics,
after updating state in place) as one ``torch.cuda.CUDAGraph`` per bucket.
What they share:

- The bucket is the (key, shape, dtype) of each array of the batch (the
  loaders' and the engine's batches pad every array to the batch's (B, L),
  so that is their shape bucket).  The first batch of a bucket runs ``fn``
  eagerly on a side stream, as PyTorch's notes on CUDA graphs ask (cuBLAS
  and cuDNN allocate workspaces and pick algorithms on a first call, K3/K4
  set their attributes and query their occupancy, the optimizer makes its
  state), with a dict that records which keys ``fn`` reads.  Then ``fn`` is
  captured from static inputs of the keys that this bucket's warm-up read;
  only those are staged and copied.  Capture runs nothing.
- A replay fills pinned staging buffers of the bucket from the host batch,
  copies them into the static inputs without blocking and replays the
  graph.  Floating arrays are staged in ``transfer_dtype``: float32, or
  bfloat16 (``--transfer_dtype``), rounded by the copy into the staging
  buffer, so half the bytes cross; ``fn`` upcasts them at its entry.
  Before it refills a bucket's staging buffers the host waits for the copy
  out of them that the bucket's previous replay queued, and for nothing
  else.
- All the graphs of one object share one memory pool.  That is safe because
  nothing allocated in a capture outlives its graph's replay but the static
  outputs, and each replay's outputs are copied out (to the host, or to new
  device tensors on the same stream) before any later replay can run.
- The kernel wrappers count launches in Python, where a replay does not
  pass: the counts that a capture made are taken back and added again on
  every replay, so a replay counts what an eager call does
  (``chip_smoke.py`` holds them against a device trace of the replays).
- Graphs read and write tensors by address: ``watch`` gives the tensors to
  check, and a call raises once one was replaced rather than written in
  place (``invalidate`` drops the graphs after a deliberate replacement).
- Spans (``core.tracing``, recorded while a profiler records):
  ``graphs.capture`` around a bucket's warm-up and capture, and in each of
  ``CapturedStep``'s replays ``step.wait``, ``step.stage`` and
  ``step.launch`` (``CapturedStep._replay``).

``CapturedForward`` runs under ``torch.inference_mode`` and returns numpy
arrays, waiting for them: one stream sync a call.  ``CapturedStep``'s
warm-up is the real step of its batch (no step is lost or repeated), and a
replay returns the metrics as new device tensors without waiting; the
generators in ``generators`` (the trainer's dropout generator) are
registered with every graph, so that replays advance them as eager steps
do.  A capture that fails raises: nothing falls back to the eager call.
Only the card: the CPU route calls ``fn`` eagerly and never builds one of
these.

K batches a replay (``steps_per_call`` and ``eval_steps_per_call``, the
JAX trainer's ``multi_step`` and ``multi_eval`` scans): ``group(stacked, k)``
takes a group of k batches stacked [k, B, ...] (``data.loader.
GroupedLoader``'s ``StackedGroup``, whose batches are copied each into its
slice), staged in one pinned buffer per key
and copied to the card once, and replays one graph per (k, bucket) whose
body runs ``fn`` on slice 0, 1, ..., k - 1 in turn.  ``CapturedStep.group``
returns each metric as a [k] device tensor, one value a step; its first
group of a bucket trains as k eager steps before the capture, and a
replay's launch counts are k steps'.  ``CapturedForward.group`` returns
each output stacked [k, ...] on the host (a tuple of them where ``fn``
returns a tuple), warmed up on slice 0.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import TYPE_CHECKING, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from erc_tpu_torch.core import tracing

if TYPE_CHECKING:
    from erc_tpu_torch.data.loader import StackedGroup


# every object that holds captured graphs, so that release_all can drop them
_live: "weakref.WeakSet[_Graphs]" = weakref.WeakSet()


def release_all() -> None:
    """Drop every captured graph of the process (each object captures again
    at its next call).  NCCL destroys a communicator only once the graphs that
    captured its collectives are gone: ``parallel.mesh.destroy`` calls this
    first."""
    for graphs in list(_live):
        graphs.invalidate()


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


def host_tensor(v: np.ndarray, transfer_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``host_array(v)`` as it crosses to the device: floating data in
    ``transfer_dtype`` (float32, or bfloat16 rounded to the nearest even, as
    the JAX package's ``transfer_cast_fn`` does through ``ml_dtypes``),
    integers and booleans as they are."""
    t = torch.from_numpy(host_array(v))
    return t.to(transfer_dtype) if t.is_floating_point() else t


class _Watch:
    """The addresses of the tensors that captured graphs read or write,
    taken when the first graph is captured."""

    def __init__(self, tensors: Optional[Callable[[], Iterable[torch.Tensor]]]):
        self.tensors = tensors
        self.addresses: Optional[List[int]] = None

    def now(self) -> Optional[List[int]]:
        return None if self.tensors is None else [t.data_ptr() for t in self.tensors()]

    def unchanged(self) -> bool:
        return self.addresses is None or self.addresses == self.now()

    def record(self) -> None:
        if self.addresses is None:
            self.addresses = self.now()

    def check(self) -> None:
        if not self.unchanged():
            raise RuntimeError("a tensor that the captured graphs read was replaced, not written in place: "
                               "call invalidate() after replacing parameters")


class _Bucket:
    """One captured graph, its static and pinned buffers (of the keys its
    warm-up read), its static outputs, the launch counts its capture
    recorded, and the batches a replay takes (k; 0 for one batch)."""

    def __init__(self, graph, inputs, outputs, counts, k):
        self.graph, self.k = graph, k
        self.inputs = inputs
        self.staging = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for k, t in inputs.items()}
        self.copied = torch.cuda.Event()  # after the last copy out of `staging`
        self.outputs = outputs
        self.counts = counts


class _Graphs:
    """What ``CapturedForward`` and ``CapturedStep`` share: the buckets, the
    warm-up, the capture, the staging copies and the launch counts."""

    def __init__(self, fn: Callable, device: torch.device,
                 watch: Optional[Callable[[], Iterable[torch.Tensor]]] = None,
                 generators: Sequence[torch.Generator] = (), transfer_dtype: torch.dtype = torch.float32):
        if device.type != "cuda":
            raise ValueError(f"{type(self).__name__} runs on a CUDA device, not {device}")
        self.fn, self.device, self.generators = fn, device, tuple(generators)
        self.transfer_dtype = transfer_dtype
        self.keys: set = set()  # the keys fn read, over every bucket's warm-up
        self.replays = 0
        self.captures = 0
        self.capture_seconds: List[float] = []  # one per capture, warm-up excluded
        self._buckets: Dict[Tuple, _Bucket] = {}
        self._pool = None
        self._stream = None
        self._watch = _Watch(watch)
        _live.add(self)

    def invalidate(self) -> None:
        """Drop every graph (after tensors they read were replaced, not written in place)."""
        self._buckets.clear()
        self._pool = None
        self._watch.addresses = None

    @property
    def pool(self):
        """The memory pool the graphs share (None before the first capture)."""
        return self._pool

    @staticmethod
    def _bucket_key(arrays: Dict[str, np.ndarray]) -> Tuple:
        return tuple((k, v.shape, v.dtype.str) for k, v in sorted(arrays.items()))

    def addresses_unchanged(self) -> bool:
        """Whether every watched tensor is where it was when the first graph was captured."""
        return self._watch.unchanged()

    def _warm_up(self, arrays: Dict[str, np.ndarray], slices: int = 0):
        """``fn`` eagerly on the side stream that captures: (the batch on the
        device, the keys fn read, fn's result).  With ``slices`` the batch is
        stacked and ``fn`` runs on each of its first ``slices`` slices in
        turn, giving the list of their results."""
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        full = {k: host_tensor(v, self.transfer_dtype).to(dev) for k, v in arrays.items()}
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        read, outs = set(), []
        with torch.cuda.stream(self._stream):
            for batch in ([_slice(full, i) for i in range(slices)] if slices else [full]):
                log = _ReadLog(batch)
                outs.append(self.fn(log))
                read |= log.read
        torch.cuda.current_stream(dev).wait_stream(self._stream)
        self.keys |= read
        return full, read, outs if slices else outs[0]

    def _capture(self, key: Tuple, inputs: Dict[str, torch.Tensor], fn: Callable) -> _Bucket:
        """``fn`` captured from the static ``inputs``; its result is the
        bucket's outputs (a tensor or a tuple of tensors)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        counters = _counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        # a graph, event or stream that the collector frees during a capture
        # (say, of a trainer dropped in a reference cycle) is destroyed while
        # the stream captures, which CUDA refuses and which breaks the
        # capture: the collector is off during it.  Nothing else frees such
        # an object then, since the captured code drops no reference to one.
        enabled = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                out = fn(dict(inputs))
        finally:
            if enabled:
                gc.enable()
        self.capture_seconds.append(time.perf_counter() - t0)
        counts = []
        for c, b in zip(counters, before):
            counts.append({k: c[k] - b[k] for k in c if c[k] != b[k]})
            c.update(b)  # the capture launched nothing; each replay adds these
        outputs = tuple(out) if isinstance(out, tuple) else (out,)
        bucket = self._buckets[key] = _Bucket(graph, inputs, outputs, counts, key[0])
        self.captures += 1
        self._watch.record()
        return bucket

    def _replay(self, bucket: _Bucket, parts: List[Dict[str, np.ndarray]]) -> None:
        """Stage ``parts`` (the batch, or a group's k batches: each into its
        slice) in the bucket's pinned buffers, copy them in and replay."""
        bucket.copied.synchronize()
        self._stage(bucket, parts)
        self._launch(bucket)

    def _stage(self, bucket: _Bucket, parts: List[Dict[str, np.ndarray]]) -> None:
        """The host copies of ``parts`` into the bucket's pinned staging, each
        array's copy in queued as soon as it is staged."""
        for k, staged in bucket.staging.items():
            # on the intra-op threads; rounds to a bfloat16 staging
            if bucket.k:
                for i, part in enumerate(parts):
                    staged[i].copy_(torch.from_numpy(part[k]))
            else:
                staged.copy_(torch.from_numpy(parts[0][k]))
            bucket.inputs[k].copy_(staged, non_blocking=True)

    def _launch(self, bucket: _Bucket) -> None:
        """The replay, and the launch counters."""
        bucket.copied.record()
        bucket.graph.replay()
        for c, delta in zip(_counters(), bucket.counts):
            for k, n in delta.items():
                c[k] += n
        self.replays += 1

    def _parts(self, host_batch, k: int):
        """(the host arrays as staged: [the batch], or a ``StackedGroup``'s
        k batches as they are (nothing stacked), its bucket's key)."""
        if not k:
            arrays = {n: host_array(v) for n, v in host_batch.items() if v is not None}
            return [arrays], (0, self._bucket_key(arrays))
        parts = [{n: host_array(v) for n, v in b.items() if v is not None} for b in host_batch.batches]
        if len(parts) != k:
            raise ValueError(f"a group of {len(parts)} batches given as {k}")
        return parts, (k, tuple((n, (k, *v.shape), v.dtype.str) for n, v in sorted(parts[0].items())))


def _stacked(parts: List[Dict[str, np.ndarray]], k: int) -> Dict[str, np.ndarray]:
    """The batch of ``_parts``: the one batch, or the group's k stacked (a bucket's warm-up only)."""
    return {n: np.stack([p[n] for p in parts]) for n in parts[0]} if k else parts[0]


def _slice(batch: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Batch i of a stacked group (views)."""
    return {k: t[i] for k, t in batch.items()}


class CapturedForward(_Graphs):
    def __init__(self, fn: Callable, device: torch.device,
                 watch: Optional[Callable[[], Iterable[torch.Tensor]]] = None,
                 transfer_dtype: torch.dtype = torch.float32):
        """fn(batch: Dict[str, Tensor]) -> Tensor or tuple of Tensors on
        ``device`` (a CUDA device); ``watch()`` the tensors ``fn`` reads by
        address (parameters, buffers); floating arrays cross in
        ``transfer_dtype``."""
        super().__init__(fn, device, watch, transfer_dtype=transfer_dtype)

    def __call__(self, host_batch: Dict[str, np.ndarray]):
        """The outputs of ``fn`` on one host batch (numpy arrays), as float32
        numpy arrays on the host: one array, or a tuple where ``fn`` returns one."""
        return self._run(host_batch, 0)

    def group(self, stacked: StackedGroup, k: int):
        """The outputs of ``fn`` on each batch of a ``StackedGroup`` of ``k``,
        stacked [k, ...] as float32 numpy arrays (a tuple of them where
        ``fn`` returns a tuple): one replay."""
        return self._run(stacked, k)

    def _run(self, host_batch: Dict[str, np.ndarray], k: int):
        parts, key = self._parts(host_batch, k)
        with torch.inference_mode():
            self._watch.check()
            bucket = self._buckets.get(key)
            if bucket is None:
                with tracing.span("graphs.capture", bucket=key):
                    full, read, out = self._warm_up(_stacked(parts, k), slices=min(k, 1))
                    is_tuple = isinstance(out[0] if k else out, tuple)

                    def body(batch):
                        if not k:
                            return self.fn(batch)
                        outs = [self.fn(_slice(batch, i)) for i in range(k)]
                        return tuple(torch.stack(o) for o in zip(*outs)) if is_tuple else torch.stack(outs)

                    bucket = self._capture(key, {n: full[n] for n in sorted(read)}, body)
                    bucket.is_tuple = is_tuple
                    bucket.host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                        for t in bucket.outputs)
            self._replay(bucket, parts)
            for host, out in zip(bucket.host, bucket.outputs):
                host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        outs = tuple(h.numpy().astype(np.float32, copy=True) for h in bucket.host)
        return outs if bucket.is_tuple else outs[0]


class CapturedStep(_Graphs):
    def __init__(self, fn: Callable, device: torch.device,
                 watch: Optional[Callable[[], Iterable[torch.Tensor]]] = None,
                 generators: Sequence[torch.Generator] = (), transfer_dtype: torch.dtype = torch.float32):
        """fn(batch: Dict[str, Tensor]) -> Dict[str, 0-d float Tensor]: one
        train step on ``device`` (a CUDA device) that updates its state in
        place; ``watch()`` the tensors it reads or writes by address
        (parameters and their gradients, buffers, optimizer state, the LR);
        ``generators`` the generators it draws from; floating arrays cross
        in ``transfer_dtype``."""
        super().__init__(fn, device, watch, generators, transfer_dtype)

    def __call__(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One step on a host batch; its metrics as device tensors."""
        return self._run(host_batch, 0)

    def group(self, stacked: StackedGroup, k: int) -> Dict[str, torch.Tensor]:
        """``k`` steps on a ``StackedGroup`` of ``k`` host batches, one replay;
        each metric as a [k] device tensor, one value a step."""
        return self._run(stacked, k)

    def _replay(self, bucket: _Bucket, parts: List[Dict[str, np.ndarray]]) -> None:
        """``_Graphs._replay`` in spans: ``step.wait`` (the host blocked on the
        copy out of the staging that the bucket's previous replay queued),
        ``step.stage`` (the host copies into the staging, and the copies in
        queued) and ``step.launch`` (the replay, the counters)."""
        with tracing.span("step.wait"):
            bucket.copied.synchronize()
        with tracing.span("step.stage"):
            self._stage(bucket, parts)
        with tracing.span("step.launch"):
            self._launch(bucket)

    def _run(self, host_batch: Dict[str, np.ndarray], k: int) -> Dict[str, torch.Tensor]:
        parts, key = self._parts(host_batch, k)
        self._watch.check()
        bucket = self._buckets.get(key)
        if bucket is None:
            with tracing.span("graphs.capture", bucket=key):
                full, read, mets = self._warm_up(_stacked(parts, k), slices=k)
                names = list(mets[0] if k else mets)
                watched = self._watch.now()

                def stacked(batch):
                    out = self.fn(batch)
                    if list(out) != names:
                        raise RuntimeError(f"the captured step returned {list(out)}, its warm-up {names}")
                    return torch.stack([out[n] for n in names])

                def body(batch):
                    return torch.stack([stacked(_slice(batch, i)) for i in range(k)]) if k else stacked(batch)

                bucket = self._capture(key, {n: full[n] for n in sorted(read)}, body)
                bucket.names = names
            if self._watch.now() != watched:
                raise RuntimeError("the capture replaced a tensor that the step updates in place "
                                   "(a parameter's .grad, optimizer state, a buffer)")
            return {n: torch.stack([m[n] for m in mets]) for n in names} if k else mets
        self._replay(bucket, parts)
        out = bucket.outputs[0].clone()
        return dict(zip(bucket.names, out.unbind(-1 if k else 0)))
