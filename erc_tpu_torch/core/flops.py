"""Matmul and convolution FLOPs of one eager step.

Port of ``erc_tpu.core.flops.mxu_flops``: the JAX function walks the
jaxpr of the train step (backward and recompute included); here the step
runs once, eagerly, under ``torch.utils.flop_counter.FlopCounterMode``,
which counts the matrix products, convolutions and attention that
dispatch (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``convolution`` and
their backward, ``scaled_dot_product_attention``), so a backward and a
checkpointed layer's recompute are counted as they run.  Two kinds of work
are counted otherwise:

- Recurrent layers (``nn.LSTM``, ``nn.GRU``): what the counter attributes to
  them (cuDNN's and oneDNN's fused calls have no formula, the CPU's
  decomposed cells do) is replaced by a formula over the rows the model
  needs, as the JAX package's scan computes them: per layer, direction and
  step, the input and hidden projections forward, and backward their
  weights' gradients, the hidden state's, and the input's where it requires
  grad.  So a count does not depend on the device, and ``ops.rnn.BiRNN``'s
  masked form, which runs each bidirectional layer over 2B rows and keeps
  half of each direction, counts B.
- The hand-written kernels K1/K2/K1ᵀ (``ops/kernels/banded.py``) and K3/K4
  (``ops/kernels/dag_block.py``) launch through ctypes, where the counter
  sees nothing.  Their work is left out on every device: on the CPU, what
  their plain versions dispatch is taken back out of the count.  A step
  that runs one of them is counted with ``lower_bound: True``; the band
  products and the DAG block's products (K3's attention, GRUs and value
  projections; K4's gradients of them) are missing from such a count.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Any, Dict, List

import torch
from torch.nn.utils.rnn import PackedSequence
from torch.utils.flop_counter import FlopCounterMode

# the kernel wrappers' device dispatch: a launch on CUDA tensors, the plain version on CPU ones
_KERNEL_ENTRIES = {"erc_tpu_torch.ops.kernels.banded": ("_gather", "_dot"),
                   "erc_tpu_torch.ops.kernels.dag_block": ("_forward", "dag_block_backward")}


def rnn_flops(cell: torch.nn.RNNBase, rows: int, steps: int, input_grad: bool) -> int:
    """Matmul FLOPs of one call of ``cell`` (all its layers and directions)
    over ``rows`` rows of ``steps`` steps, forward and backward."""
    G = {"LSTM": 4, "GRU": 3}.get(cell.mode, 1)
    H, dirs = cell.hidden_size, 2 if cell.bidirectional else 1
    n = rows * steps
    total = 0
    for layer in range(cell.num_layers):
        d_in = cell.input_size if layer == 0 else dirs * H
        x, h = 2 * n * d_in * G * H, 2 * n * H * G * H
        # forward x and h; backward d W_ih, d W_hh, d h and, where asked for, d input
        total += dirs * (2 * x + 3 * h + (x if layer > 0 or input_grad else 0))
    return total


@contextlib.contextmanager
def _kernels_left_out(counter: FlopCounterMode, state: Dict[str, Any]):
    """Run the hand-written kernels' dispatch with what it counts taken back
    out of ``counter`` (their plain versions on the CPU), noting in
    ``state`` that one ran."""
    saved = []

    def wrap(fn):
        def uncounted(*args, **kwargs):
            before = counter.get_total_flops()
            try:
                return fn(*args, **kwargs)
            finally:
                state["kernels"] = True
                state["left_out"] += counter.get_total_flops() - before
        return uncounted

    try:
        for module, names in _KERNEL_ENTRIES.items():
            mod = importlib.import_module(module)
            for name in names:
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, wrap(getattr(mod, name)))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def _rnn_calls(calls: List):
    """Record each recurrent layer's call as (layer, rows the model needs,
    steps, whether its input requires grad)."""
    from erc_tpu_torch.ops.rnn import BiRNN

    doubled: List[bool] = []

    def pre(module, args):  # a global hook gets no keyword arguments: the models pass the mask by position
        if isinstance(module, BiRNN):
            doubled.append(len(args) > 1 and args[1] is not None and module.layers[0].bidirectional)

    def post(module, args, out):
        if isinstance(module, BiRNN):
            doubled.pop()
        elif isinstance(module, (torch.nn.LSTM, torch.nn.GRU)):
            x = args[0]
            if isinstance(x, PackedSequence):
                rows, steps, grad = int(x.batch_sizes[0]), len(x.batch_sizes), x.data.requires_grad
            else:
                B, T = (x.shape[0], x.shape[1]) if module.batch_first else (x.shape[1], x.shape[0])
                rows, steps, grad = B, T, x.requires_grad
            calls.append((module, rows // 2 if doubled and doubled[-1] else rows, steps, grad))

    hooks = (torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(post))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def step_flops(fn, *args, **kwargs) -> Dict[str, Any]:
    """Matmul and convolution FLOPs of one call of ``fn(*args, **kwargs)``,
    run eagerly (a train step: forward and backward, and an optimizer step,
    which adds none).  Returns ``{"flops": float, "lower_bound": bool}`` as
    ``mxu_flops`` does; ``lower_bound`` is True where a hand-written kernel
    ran (its work is not in the count)."""
    counter = FlopCounterMode(display=False)
    state = {"kernels": False, "left_out": 0}
    calls: List = []
    with counter, _kernels_left_out(counter, state), _rnn_calls(calls):
        fn(*args, **kwargs)
    total = counter.get_total_flops() - state["left_out"]
    if calls:
        names = counter.mod_tracker._known_modules  # the module names the counter keyed its counts by
        counts = counter.get_flop_counts()
        for layer in {id(c[0]): c[0] for c in calls}.values():
            total -= sum(counts.get(names.get(layer), {}).values())
        total += sum(rnn_flops(*c) for c in calls)
    return {"flops": float(total), "lower_bound": state["kernels"]}
