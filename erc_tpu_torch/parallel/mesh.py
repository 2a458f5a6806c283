"""Data parallelism over processes: one process a card, ``torch.distributed``.

Port of ``erc_tpu.parallel.mesh``.  The JAX package declares a mesh whose
``data`` axis splits every batch over all devices of all processes, and XLA
emits the collectives: one program sees the global batch.  The port runs one
process a card (a rank), each holding the whole model and a strided slice of
every global batch (``data.loader``), and restores the global batch where the
maths needs it:

- gradients are summed over ranks (``allreduce_``, one flat buffer a step,
  inside the captured train step under NCCL), and every loss and metric of a
  step is this rank's share (its numerator over the global denominator,
  ``global_sum``), so the summed gradient is the global batch's and the summed
  metric the global one;
- batch-norm statistics are sums over every rank's rows through
  ``global_sum``, which is differentiable (its backward sums the gradient over
  ranks), so the backward is the global batch's too;
- the eval stages gather their rows (``allgather_rows``, ``allsum``) before any
  metric, so every rank takes the same decisions;
- the test name, a stop decision and a resumed checkpoint's path come from
  rank 0 (``broadcast_one_to_all``), and rank 0's parameters and buffers are
  copied to every rank after they are made or loaded (``broadcast_``).

``initialize_distributed`` starts the process group (the JAX
``jax.distributed.initialize``).  The backend is NCCL where every rank has a
card of its own, and gloo on the CPU or where two ranks share a card
(``core.device.pick_backend``); a gloo collective cannot be captured in a CUDA
graph, so under gloo the trainer steps eagerly (``captures_allowed``).

``MeshSpec``'s ``data`` axis is the process count.  Its ``model`` axis (tensor
parallelism) is not ported: no flag of the JAX trainer reaches it.  The JAX
module's ``shard_batch``, ``replicate``, ``shard_params`` and ``fetch_local``
place arrays on the devices of one program; under one process a card a batch
is already the rank's own rows and every tensor the rank's own, so they have
no counterpart here.  Neither has ``erc_tpu.parallel.cache`` (the XLA
compilation cache): the kernels' build directory plays its part.

Without a process group every function here is the identity (or says one
process), and the port runs as it did before this module.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from erc_tpu_torch.core.device import DeviceSpec, pick_backend, place_of, rank_card, resolve_device

ENV_COORDINATOR = "ERC_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "ERC_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "ERC_TPU_PROCESS_ID"
ENV_DIST = "ERC_TPU_DIST"  # "auto": the launcher's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK (and LOCAL_RANK)
TIMEOUT = datetime.timedelta(minutes=10)

# what initialize_distributed chose: this rank's device and local rank, every rank's place
_group: Dict[str, Any] = {}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The JAX mesh's axes: ``data`` (-1: every process) and ``model``."""

    data: int = -1
    model: int = 1

    def resolve(self, n_processes: int) -> tuple:
        if self.model > 1:
            raise NotImplementedError(
                f"MeshSpec(model={self.model}): tensor parallelism over the mesh's model axis is not ported "
                "(ROADMAP.md, the port's queue: the mesh's model axis); the port is data parallel only")
        data = self.data if self.data > 0 else n_processes
        if data != n_processes:
            raise ValueError(f"mesh data={data} != {n_processes} processes: one process a card is the data axis")
        return data, 1


def grouped() -> bool:
    """Whether a process group is up."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if grouped() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if grouped() else 0


def is_main_process() -> bool:
    return process_index() == 0


def backend() -> Optional[str]:
    """The group's backend (``nccl`` or ``gloo``), or None without a group."""
    import torch.distributed as dist

    return dist.get_backend() if grouped() else None


def captures_allowed() -> bool:
    """Whether a train step that calls collectives can be captured in a CUDA
    graph: without a group, or under NCCL (a gloo collective runs on the host)."""
    return not grouped() or backend() == "nccl"


def rank_device(spec: DeviceSpec) -> torch.device:
    """This rank's device: the one ``initialize_distributed`` chose, else
    ``resolve_device(spec)``."""
    dev = _group.get("device")
    return dev if dev is not None and grouped() else resolve_device(spec)


def describe() -> str:
    """One line on the group for the log: ranks, backend, places."""
    if not grouped():
        return "no process group: one process"
    places = _group.get("places") or []
    shared = len(set(places)) < len(places) and "cpu" not in places
    line = (f"process group: rank {process_index()} of {process_count()}, backend {backend()}, "
            f"ranks at {', '.join(places) or 'unknown places'}")
    if shared:
        line += ("; ranks share a card, so gloo (NCCL refuses two ranks on one device), and the train step runs "
                 "eagerly (a gloo collective cannot be captured in a CUDA graph)")
    return line


def initialize_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device: DeviceSpec = 0) -> bool:
    """Start the process group, before anything runs on a card; True where
    a group is up after it.

    Configuration, in priority order: the arguments (``--coordinator=host:port``,
    ``--num_processes``, ``--process_id``), then ``ERC_TPU_COORDINATOR``,
    ``ERC_TPU_NUM_PROCESSES`` and ``ERC_TPU_PROCESS_ID``, then, with
    ``ERC_TPU_DIST=auto``, the launcher's ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (torchrun's); else nothing
    happens (one process).  Rank 0 serves the rendezvous at the coordinator's
    address.  Each rank takes the card of ``core.device.rank_card(device,
    local rank)`` (the local rank is ``LOCAL_RANK``, or the rank's place among
    the ranks on its host) and makes it current; the backend is
    ``pick_backend`` of every rank's place.  A second call returns at once."""
    import torch.distributed as dist

    if grouped():
        return True
    env = os.environ
    local_rank = None
    coordinator = coordinator or env.get(ENV_COORDINATOR)
    if coordinator is None and env.get(ENV_DIST) == "auto":
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = num_processes if num_processes is not None else int(env["WORLD_SIZE"])
        process_id = process_id if process_id is not None else int(env["RANK"])
    if coordinator is None:
        return False
    if num_processes is None and ENV_NUM_PROCESSES in env:
        num_processes = int(env[ENV_NUM_PROCESSES])
    if process_id is None and ENV_PROCESS_ID in env:
        process_id = int(env[ENV_PROCESS_ID])
    if num_processes is None or process_id is None:
        raise ValueError(f"--coordinator={coordinator} needs --num_processes and --process_id "
                         f"(or {ENV_NUM_PROCESSES} and {ENV_PROCESS_ID})")
    num_processes, process_id = int(num_processes), int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id={process_id} outside [0, {num_processes})")
    if "LOCAL_RANK" in env:
        local_rank = int(env["LOCAL_RANK"])
    host_addr, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host_addr, int(port), num_processes, is_master=process_id == 0, timeout=TIMEOUT)
    host = socket.gethostname()
    hosts = _exchange(store, "host", host, num_processes, process_id)
    if local_rank is None:
        local_rank = hosts[:process_id].count(host)
    dev = resolve_device(rank_card(device, local_rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # before any kernel or collective on the card
    places = _exchange(store, "place", place_of(dev, host), num_processes, process_id)
    dist.init_process_group(pick_backend(places), store=store, rank=process_id, world_size=num_processes, timeout=TIMEOUT)
    _group.update(device=dev, local_rank=local_rank, places=places)
    return True


def _exchange(store, key: str, value: str, n: int, rank: int) -> List[str]:
    """Every rank's ``value`` through the rendezvous store, in rank order."""
    store.set(f"erc_tpu/{key}/{rank}", value)
    keys = [f"erc_tpu/{key}/{r}" for r in range(n)]
    store.wait(keys)
    return [store.get(k).decode() for k in keys]


def destroy() -> None:
    """End the process group (a process that made one ends it before it
    exits).  The captured graphs go first: NCCL waits, in destroying its
    communicator, for every graph that captured one of its collectives."""
    import gc

    import torch.distributed as dist

    from erc_tpu_torch.core.cuda_graphs import release_all

    if grouped():
        release_all()
        gc.collect()
        if backend() == "nccl":
            torch.cuda.synchronize()
        dist.destroy_process_group()
    _group.clear()


# ------------------------------------------------------------ collectives
def _comm_device() -> torch.device:
    """Where host values cross: the current card under NCCL, else the CPU."""
    return torch.device("cuda", torch.cuda.current_device()) if backend() == "nccl" else torch.device("cpu")


def _reduce(t: torch.Tensor) -> None:
    """Sum ``t`` over ranks in place; gloo reduces a copy on the host."""
    import torch.distributed as dist

    if backend() == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)


def _summed(x: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``x`` summed over ranks, reduced in float32 at least."""
    out = x.detach().to(torch.promote_types(x.dtype, torch.float32), copy=True).contiguous()
    _reduce(out)
    return out.to(x.dtype)


class _GlobalSum(torch.autograd.Function):
    """Σ over ranks; its backward sums the incoming gradient over ranks too:
    each rank's loss depends on every rank's rows through the sum, so the
    gradient of the global loss with respect to one rank's summand is the sum
    of every rank's gradient with respect to the total."""

    @staticmethod
    def forward(ctx, x):
        return _summed(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank (the global batch's sum where ``x`` is a
    sum over this rank's rows), differentiable; ``x`` itself without a group."""
    if not grouped():
        return x
    return _GlobalSum.apply(x) if x.requires_grad else _summed(x)


def allreduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum every tensor over ranks in place, as one flat float32 buffer (one
    collective; captured with the step under NCCL)."""
    if not grouped() or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    _reduce(flat)
    torch._foreach_copy_(list(tensors), [v.view_as(t) for v, t in
                                         zip(flat.split([t.numel() for t in tensors]), tensors)])


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Rank ``src``'s values of every tensor on every rank, in place, one
    collective a dtype."""
    import torch.distributed as dist

    if not grouped() or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            on = flat.cpu() if backend() == "gloo" else flat
            dist.broadcast(on, src)
            parts = on.to(flat.device).split([t.numel() for t in ts])
            torch._foreach_copy_(ts, [v.view_as(t) for v, t in zip(parts, ts)])


def broadcast_one_to_all(value: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``value`` (any picklable object) on every rank;
    ``value`` itself without a group."""
    import torch.distributed as dist

    if not grouped():
        return value
    box = [value]
    dist.broadcast_object_list(box, src, device=_comm_device())
    return box[0]


def barrier() -> None:
    import torch.distributed as dist

    if grouped():
        dist.barrier(**({"device_ids": [torch.cuda.current_device()]} if backend() == "nccl" else {}))


def allgather_rows(arr: np.ndarray) -> np.ndarray:
    """Every rank's rows of a host array of its own leading length, in rank
    order, the same array on every rank; ``arr`` itself without a group."""
    import torch.distributed as dist

    arr = np.asarray(arr)
    if not grouped():
        return arr
    n = process_count()
    dev = _comm_device()
    counts = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(n)]
    dist.all_gather(counts, torch.tensor([arr.shape[0]], dtype=torch.int64, device=dev))
    counts = [int(c.item()) for c in counts]
    most = max(counts)
    padded = np.zeros((most, *arr.shape[1:]), arr.dtype)
    padded[: arr.shape[0]] = arr
    mine = torch.from_numpy(padded).to(dev)
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine)
    return np.concatenate([p.cpu().numpy()[:c] for p, c in zip(parts, counts)], axis=0)


def allsum(*values: float):
    """Host scalars summed over ranks (float64): one value, or a tuple of them."""
    if grouped():
        t = torch.tensor(values, dtype=torch.float64, device=_comm_device())
        _reduce(t)
        values = tuple(float(v) for v in t.cpu())
    return values if len(values) > 1 else values[0]
