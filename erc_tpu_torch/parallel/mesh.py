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

``MeshSpec(data, model)`` lays ``data × model`` ranks out as the JAX mesh's
row-major ``(data, model)`` reshape: rank ``r`` has data index ``r // model``
and model index ``r % model`` (``set_axes``, which the trainer calls as it
initializes).  Each rank is in a data group (the ranks of its model index) and
a model group (the ranks of its data index).  The ranks of one data index hold
the same rows, so every sum over rows above (``global_sum``, ``allreduce_``,
``allgather_rows``, ``allsum``) runs over the data group only; the loader's
strided slice is taken over the data index.  Without a model axis the data
group is every rank.

The model axis (``ModelAxis``; the JAX ``shard_params``) splits each parameter
that is 2-D in its flax form, has at least ``SHARD_MIN_SIZE`` (65 536) elements
and whose flax last dimension divides by ``model``, along the torch dimension
holding that axis (dim 0 of an ``nn.Linear`` weight, whose flax kernel is its
transpose; the last dimension of a parameter kept in the JAX layout), and
replicates every other one.  Each rank's optimizer steps its block of each
split parameter, a view of the module's full parameter (its gradient a view of
the full gradient), so it keeps that block's moments only; after the step the
blocks are all-gathered over the model group into the full parameters (dim-0
blocks straight into them under NCCL, captured with the step).  The full
parameters and gradients stay on every rank, as the modules compute with them:
what a rank saves is the split parameters' moments × (1 − 1/model), the bytes
``ModelAxis.stored_bytes`` counts.  The
The
module's ``shard_batch``, ``replicate`` and ``fetch_local`` place arrays on
the devices of one program and have no counterpart here; neither has
``erc_tpu.parallel.cache`` (the XLA compilation cache): the kernels' build
directory plays its part.

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
    """The JAX mesh's axes: ``data`` (-1: every process left by ``model``) and ``model``."""

    data: int = -1
    model: int = 1

    def resolve(self, n_processes: int) -> tuple:
        """(data, model), their product the process count."""
        model = max(self.model, 1)
        data = self.data if self.data > 0 else max(n_processes // model, 1)
        if data * model != n_processes:
            raise ValueError(f"mesh {data}x{model} != {n_processes} processes (one process a card); "
                             "pass an explicit MeshSpec")
        return data, model


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


def set_axes(data: int, model: int) -> None:
    """Lay the ranks out as a ``data × model`` mesh (``MeshSpec.resolve``'s
    pair), making the data and model groups where ``model`` > 1: every rank
    calls it at the same point.  ``model`` = 1 makes the data group every rank.
    The layout is the process's: the last trainer initialized sets it."""
    import torch.distributed as dist

    if data * model != process_count():
        raise ValueError(f"mesh {data}x{model} != {process_count()} processes")
    if model == 1:
        _group.pop("axes", None)
        return
    groups = _group.setdefault("groups", {})
    if (data, model) not in groups:  # every rank makes every group, in one order
        rank = process_index()
        model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]  # one a data index
        data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]  # one a model index
        groups[(data, model)] = (data_groups[rank % model], model_groups[rank // model])
    data_group, model_group = groups[(data, model)]
    _group["axes"] = {"data": data, "model": model, "data_group": data_group, "model_group": model_group}


def model_count() -> int:
    """The mesh's model axis (1 without one)."""
    return _group["axes"]["model"] if "axes" in _group else 1


def data_count() -> int:
    """The mesh's data axis: the ranks that hold rows of their own."""
    return process_count() // model_count()


def data_index() -> int:
    """This rank's place on the data axis: its slice of every global batch."""
    return process_index() // model_count()


def model_index() -> int:
    return process_index() % model_count()


def _data_group():
    """The group that sums over rows (None: every rank)."""
    return _group["axes"]["data_group"] if "axes" in _group else None


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
    if model_count() > 1:
        line += f"; mesh {data_count()}x{model_count()}, data index {data_index()}, model index {model_index()}"
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
    """Sum ``t`` over the data group in place; gloo reduces a copy on the host."""
    import torch.distributed as dist

    group = _data_group()
    if backend() == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)


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
    """``x`` summed over the data group (the global batch's sum where ``x`` is
    a sum over this rank's rows), differentiable; ``x`` itself without a group."""
    if not grouped():
        return x
    return _GlobalSum.apply(x) if x.requires_grad else _summed(x)


def allreduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum every tensor over the data group in place, as one flat float32
    buffer (one collective; captured with the step under NCCL)."""
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
    """Every data rank's rows of a host array of its own leading length, in
    rank order, the same array on every rank; ``arr`` itself without a group."""
    import torch.distributed as dist

    arr = np.asarray(arr)
    if not grouped():
        return arr
    n, group = data_count(), _data_group()
    dev = _comm_device()
    counts = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(n)]
    dist.all_gather(counts, torch.tensor([arr.shape[0]], dtype=torch.int64, device=dev), group=group)
    counts = [int(c.item()) for c in counts]
    most = max(counts)
    padded = np.zeros((most, *arr.shape[1:]), arr.dtype)
    padded[: arr.shape[0]] = arr
    mine = torch.from_numpy(padded).to(dev)
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)
    return np.concatenate([p.cpu().numpy()[:c] for p, c in zip(parts, counts)], axis=0)


def allsum(*values: float):
    """Host scalars summed over the data group (float64): one value, or a tuple of them."""
    if grouped():
        t = torch.tensor(values, dtype=torch.float64, device=_comm_device())
        _reduce(t)
        values = tuple(float(v) for v in t.cpu())
    return values if len(values) > 1 else values[0]


# ------------------------------------------------------------ the model axis
SHARD_MIN_SIZE = 1 << 16  # shard_params' min_size


def flax_last_dim(module: torch.nn.Module, name: str, t: torch.Tensor) -> int:
    """The torch dimension of ``t`` (parameter ``name`` of ``module``) that holds
    its flax form's last axis: 0 for an ``nn.Linear`` weight (``convert.py``
    transposes a flax ``Dense`` kernel), the last one for a parameter that
    keeps the JAX layout (``convert.py``'s other maps)."""
    return 0 if isinstance(module, torch.nn.Linear) and name == "weight" else t.ndim - 1


def sharded_parameters(model: torch.nn.Module, n: int, min_size: Optional[int] = None):
    """``shard_params``' rule on each parameter's flax form: (name, parameter,
    torch dimension to split) of each parameter that is 2-D, has at least
    ``min_size`` (default ``SHARD_MIN_SIZE``, read at the call) elements and
    whose flax last dimension divides by ``n``; none where ``n`` is 1."""
    out = []
    if n <= 1:
        return out
    min_size = SHARD_MIN_SIZE if min_size is None else min_size
    for mod_name, mod in model.named_modules():
        for name, t in mod.named_parameters(recurse=False):
            if t.ndim != 2 or t.numel() < min_size:
                continue
            dim = flax_last_dim(mod, name, t)
            if t.shape[dim] % n == 0:
                out.append((f"{mod_name}.{name}" if mod_name else name, t, dim))
    return out


def _block(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


class ModelAxis:
    """The parameters of ``model`` split over the mesh's model axis
    (``sharded_parameters``): this rank's block of each, a view of the full
    parameter whose gradient is the same block of the full gradient, takes the
    full parameter's place in ``optimizer``'s groups, so that the optimizer
    steps the block in place and keeps its moments only.

    - ``gather()``: every rank's blocks, all-gathered over the model group,
      into the full parameters, in place; after each optimizer step, and
      captured with it under NCCL;
    - ``full_state(state)`` / ``shard_state()``: the optimizer's state dict with
      each block's moments gathered into the full parameter's layout (a
      checkpoint's, which loads into an unsharded run), and the blocks' moments
      taken from full ones that a load put in their place.

    The full gradients are made here and must stay where they are (the trainer
    zeroes them in place).  Every rank of a model group calls each method at
    the same point."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer, min_size: Optional[int] = None):
        # a declared schedule's count (``state["schedule"]``) is no parameter's state: it stays whole on every rank
        if any(isinstance(k, torch.Tensor) for k in optimizer.state):
            raise ValueError("ModelAxis: the optimizer has stepped already; split its parameters before")
        self.n, self.i = model_count(), model_index()
        self.entries = []  # (name, full parameter, block parameter, dim)
        for name, full, dim in sharded_parameters(model, self.n, min_size):
            if full.grad is None:
                full.grad = torch.zeros_like(full)
            block = torch.nn.Parameter(_block(full.detach(), dim, self.n, self.i))
            block.grad = _block(full.grad, dim, self.n, self.i)
            self.entries.append((name, full, block, dim))
        swap = {id(full): block for _, full, block, _ in self.entries}
        for g in optimizer.param_groups:
            g["params"] = [swap.get(id(p), p) for p in g["params"]]
        self.optimizer = optimizer
        optimizer.model_axis = self  # Lars takes whole-parameter norms through it
        self._splits: Dict[tuple, Any] = {}

    @property
    def names(self) -> List[str]:
        return [e[0] for e in self.entries]

    def _all_gather(self, flat: torch.Tensor) -> torch.Tensor:
        """[n, len(flat)]: every model rank's ``flat``, in model-index order."""
        import torch.distributed as dist

        group = _group["axes"]["model_group"]
        if backend() == "nccl":
            out = torch.empty(self.n * flat.numel(), dtype=flat.dtype, device=flat.device)
            dist.all_gather_into_tensor(out, flat, group=group)
            return out.view(self.n, -1)
        host = flat.cpu()
        parts = [torch.empty_like(host) for _ in range(self.n)]
        dist.all_gather(parts, host, group=group)
        return torch.stack(parts).to(flat.device)

    def _gathered(self, blocks: List[torch.Tensor], dims: List[int]) -> List[torch.Tensor]:
        """Each block's full tensor: the model ranks' blocks side by side along its dimension."""
        gathered = self._all_gather(torch.cat([b.reshape(-1) for b in blocks]))
        out, off = [], 0
        for b, d in zip(blocks, dims):
            parts = gathered[:, off: off + b.numel()].reshape(self.n, *b.shape)
            shape = list(b.shape)
            shape[d] *= self.n
            out.append(parts.movedim(0, d).reshape(shape))
            off += b.numel()
        return out

    @torch.no_grad()
    def gather(self) -> None:
        import torch.distributed as dist

        if not self.entries:
            return
        if backend() != "nccl":  # eager: one collective through the host
            fulls = self._gathered([b.detach() for _, _, b, _ in self.entries], [d for *_, d in self.entries])
            torch._foreach_copy_([f.detach() for _, f, _, _ in self.entries], fulls)
            return
        group = _group["axes"]["model_group"]
        for _, full, block, d in self.entries:  # a dim-0 block sits at its rank's offset: an in-place all-gather
            if d == 0:
                dist.all_gather_into_tensor(full.detach().view(-1), block.detach().view(-1), group=group)
            else:
                full.detach().copy_(self._gathered([block.detach()], [d])[0])

    def _moments(self):
        """(entry, state key) of every block's tensor state of the block's shape."""
        for e in self.entries:
            st = self.optimizer.state.get(e[2], {})
            for k in sorted(st):
                v = st[k]
                if isinstance(v, torch.Tensor) and v.shape == e[2].shape:
                    yield e, k

    @torch.no_grad()
    def full_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """``state`` (``optimizer.state_dict()``) with each block's moments
        gathered into its full parameter's layout."""
        moments = list(self._moments())
        if not moments:
            return state
        full = self._gathered([self.optimizer.state[e[2]][k].detach() for e, k in moments],
                              [e[3] for e, _ in moments])
        index = {id(p): i for i, p in enumerate(p for g in self.optimizer.param_groups for p in g["params"])}
        out = {**state, "state": {i: dict(v) for i, v in state["state"].items()}}
        for (e, k), t in zip(moments, full):
            out["state"][index[id(e[2])]][k] = t.clone()
        return out

    @torch.no_grad()
    def shard_state(self) -> None:
        """Each block's moments := this rank's block of the full-layout moments
        a load left in its place."""
        for _, full, block, d in self.entries:
            st = self.optimizer.state.get(block, {})
            for k, v in list(st.items()):
                if isinstance(v, torch.Tensor) and v.shape == full.shape and v.shape != block.shape:
                    st[k] = _block(v, d, self.n, self.i).clone()

    def full_norms(self, params: List[torch.Tensor], norms: torch.Tensor) -> torch.Tensor:
        """``norms`` [k, len(params)] of per-parameter norms, those of the blocks
        among ``params`` made the full parameters' (Σ of squares over the model
        group; captured with the step under NCCL)."""
        import torch.distributed as dist

        key = tuple(id(p) for p in params)
        split = self._splits.get(key)
        if split is None:  # made in the eager step before a capture, read by the replays
            mine = {id(b) for _, _, b, _ in self.entries}
            if not any(id(p) in mine for p in params):
                self._splits[key] = False
                return norms
            split = self._splits[key] = torch.tensor([id(p) in mine for p in params], device=norms.device)
        if split is False:
            return norms
        sq = torch.where(split, norms * norms, torch.zeros_like(norms))
        group = _group["axes"]["model_group"]
        if backend() == "gloo" and sq.device.type != "cpu":
            host = sq.cpu()
            dist.all_reduce(host, group=group)
            sq = host.to(norms.device)
        else:
            dist.all_reduce(sq, group=group)
        return torch.where(split, sq.sqrt(), norms)

    def stored_bytes(self) -> Dict[str, int]:
        """This rank's bytes of the optimizer's parameters, their gradients and
        their moments, and an unsplit run's moments: the full parameters and
        gradients stay on every rank (the blocks are views of them), a split
        parameter's moments are its block's.  ``split``: the split parameters'
        bytes."""
        full = {id(b): f for _, f, b, _ in self.entries}
        out = dict.fromkeys(("parameters", "gradients", "moments", "moments_unsplit"), 0)
        for p in (p for g in self.optimizer.param_groups for p in g["params"]):
            whole = full.get(id(p), p)
            n_moments = sum(isinstance(v, torch.Tensor) and v.shape == p.shape
                            for v in self.optimizer.state.get(p, {}).values())
            out["parameters"] += whole.numel() * whole.element_size()
            out["gradients"] += whole.numel() * whole.element_size() if p.grad is not None else 0
            out["moments"] += n_moments * p.numel() * p.element_size()
            out["moments_unsplit"] += n_moments * whole.numel() * whole.element_size()
        out["split"] = sum(f.numel() * f.element_size() for _, f, _, _ in self.entries)
        return out
