"""Recurrent layers with torch-math cells.

Port of ``erc_tpu.ops.rnn``:

- ``gru_cell, gru_cell_proj``: gates stacked r, z, n along the last axis,
  with separate input and hidden biases, as ``torch.nn.GRUCell`` has them;
- ``BiRNN``: a multi-layer bidirectional LSTM (DialogueGCN, MMGCN,
  DialogueGCN v2) or GRU (DialogueGCN v2, CIM), or a one-direction LSTM
  (MMIN's ``LSTMEncoder``, ``bidirectional=False``), over a right-padded
  [B, L, D] batch, in one of three forms:
  - packed, by lengths on the host (the training steps): padded steps
    neither update the state nor produce output; each layer is one
    ``nn.LSTM`` or ``nn.GRU`` call on a ``PackedSequence``;
  - masked, by the mask alone (serving and the val and test stages): the
    JAX package's masked scan
    (``_scan_bidirectional``), with no host sync, so it can be captured in
    a CUDA graph.  The forward direction runs over the padded tensor (a
    valid step reads no later step), the reverse one over each row's valid
    prefix, and padded outputs are 0;
  - every step, padding included, where neither is given (the JAX
    package's mask of ones: MMIN's encoders, and ``lstm_mode='unpacked'``
    of MMGCN and DialogueGCN v2).
  The layers' gate order (i, f, g, o for the LSTM; r, z, n for the GRU,
  with ``b_hn`` inside ``r·(…)``) and dual biases are the JAX cells'; on the
  card each layer is one cuDNN call.
- ``reverse_padded``: each row's valid prefix reversed (DialogueRNN's
  reverse direction).

The recurrent layers' initialiser (``_uniform_init``) is ``ops.init.uniform_``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence

from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.init import uniform_


def gru_cell_proj(x_proj: torch.Tensor, h_proj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """GRU step with both projections precomputed: x_proj = x·W_ihᵀ + b_ih and
    h_proj = h·W_hhᵀ + b_hh, each [..., 3H]."""
    xr, xz, xn = x_proj.chunk(3, -1)
    hr, hz, hn = h_proj.chunk(3, -1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_cell(x_proj: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """One GRU step; x_proj = x·W_ihᵀ + b_ih, [..., 3H]."""
    return gru_cell_proj(x_proj, h @ w_hh.T + b_hh, h)


@contextlib.contextmanager
def cudnn_full_fp32(backend):
    """cuDNN's float32 ops of ``backend`` (``torch.backends.cudnn.rnn`` or
    ``.conv``) in full float32 within the block, whatever the process-wide
    flags say (torch lets cuDNN run them in TF32 by default, which misses the
    port's 1e-4 agreement with the CPU): the backend's own setting,
    ``fp32_precision``, is "ieee" within and restored after."""
    prev = backend.fp32_precision
    backend.fp32_precision = "ieee"
    try:
        yield
    finally:
        backend.fp32_precision = prev


def cudnn_rnn_full_fp32():
    """``cudnn_full_fp32`` for cuDNN's RNNs."""
    return cudnn_full_fp32(torch.backends.cudnn.rnn)


def _backward_in_full_fp32(t: torch.Tensor, backend=torch.backends.cudnn.rnn,
                           node_prefix: str = "CudnnRnnBackward") -> None:
    """cuDNN reads the setting again when the backward runs, outside the
    forward's block: hooks on the cuDNN node that made ``t`` (its name starts
    with ``node_prefix``) set ``backend``'s full float32 just before that
    node runs and restore the setting just after.  Where no such node made
    ``t`` (cuDNN disabled) there is nothing to do."""
    nodes, seen = [t.grad_fn], set()
    while nodes:
        node = nodes.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if node.name().startswith(node_prefix):
            prev = []

            def before(grad_outputs):
                prev.append(backend.fp32_precision)
                backend.fp32_precision = "ieee"

            def after(grad_inputs, grad_outputs):
                backend.fp32_precision = prev.pop()

            node.register_prehook(before)
            node.register_hook(after)
            return
        if len(seen) < 4:  # the cuDNN node is the output's, or a view's just above it
            nodes.extend(fn for fn, _ in node.next_functions)


class BiRNN(nn.Module):
    """``num_layers`` single-layer bidirectional (or, with
    ``bidirectional=False``, one-direction) ``nn.LSTM`` (``cell='lstm'``)
    or ``nn.GRU`` (``cell='gru'``), batch first, with dropout between layers
    and not after the last, as the JAX module has it.

    Each layer is its own module so that the dropout between layers draws
    from the port's seeded ``Dropout``; ``nn.LSTM(dropout=...)`` would draw
    from torch's global RNG.  Parameters per layer ``n`` are
    ``layers.{n}.weight_ih_l0[_reverse]`` etc.: the JAX
    ``w_ih_l{n}[_reverse]`` in the same layout.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1, dropout: float = 0.0,
                 cell: str = "lstm", bidirectional: bool = True, *, generator=None, device=None):
        super().__init__()
        rnn = {"lstm": nn.LSTM, "gru": nn.GRU}.get(cell)
        if rnn is None:
            raise ValueError(f"unknown cell {cell!r}: use 'lstm' or 'gru'")
        scale = 1.0 / math.sqrt(hidden_size)
        self.layers = nn.ModuleList()
        d_in = input_size
        for _ in range(num_layers):
            layer = rnn(d_in, hidden_size, batch_first=True, bidirectional=bidirectional, device=device)
            with torch.no_grad():
                for t in layer.parameters():
                    uniform_(t, scale, generator=generator)
            self.layers.append(layer)
            d_in = (2 if bidirectional else 1) * hidden_size
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, L, D]; mask: [B, L], 1 on each row's first ``lengths[b]``
        positions; lengths: [B] ints.  Returns [B, L, 2H] ([B, L, H] in one
        direction).

        - ``lengths`` on the host (a CPU tensor, taken from the host batch:
          packing needs them there, and a device tensor costs a copy that
          waits for the device): the packed form.
        - ``mask`` alone: the masked form (``_masked``), which reads the
          lengths from the mask on the device.
        - neither: every row runs all L steps, padding included, unpacked
          and unmasked: one cuDNN call a layer over the tensor as it is.
        The packed and masked forms give 0 at padded positions and on rows
        of length 0.

        cuDNN runs each layer, forward and backward, in full float32
        (``cudnn_rnn_full_fp32``).  Packed rows are sorted by length on the
        host and the permutations go to the device without blocking, so
        packing waits for nothing (``enforce_sorted=False`` would copy its
        permutation with a blocking copy).  A row of length 0 (a padding
        dialogue) is packed with length 1 and its output zeroed by the mask:
        packing refuses length 0.
        """
        if lengths is None:
            return self._unpacked(x) if mask is None else self._masked(x, mask)
        L = x.shape[1]
        n = lengths.to("cpu", torch.int64).clamp(min=1)
        order = torch.argsort(n, descending=True, stable=True)
        n_sorted, inverse = n[order], torch.argsort(order)
        if x.is_cuda:
            order, inverse = (t.pin_memory().to(x.device, non_blocking=True) for t in (order, inverse))
        packed = pack_padded_sequence(x.index_select(0, order), n_sorted, batch_first=True)
        for i, layer in enumerate(self.layers):
            if i:
                packed = packed._replace(data=self.dropout(packed.data))
            packed, _ = self._run(layer, packed)
        out, _ = pad_packed_sequence(packed, batch_first=True, total_length=L)
        return out.index_select(0, inverse) * mask[..., None].to(out.dtype)

    @staticmethod
    def _run(layer, inp):
        """One layer's cuDNN call in full float32, forward and backward."""
        with cudnn_rnn_full_fp32():
            out, state = layer(inp)
        data = out.data if isinstance(out, PackedSequence) else out
        if data.requires_grad and data.is_cuda:
            _backward_in_full_fp32(data)
        return out, state

    def _unpacked(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for i, layer in enumerate(self.layers):
            if i:
                out = self.dropout(out)
            out, _ = self._run(layer, out)
        return out

    def _masked(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The masked form: shapes depend on (B, L) alone and nothing waits
        for the host.  A bidirectional layer is one call over 2B rows: the B
        rows as they are, whose forward half is taken, and the B rows
        right-aligned (each valid prefix moved to the end of its row), whose
        reverse half is taken and moved back.  Run from the end, a
        right-aligned row meets its valid steps first, from a zero state, as
        the reverse direction of the masked scan does; the steps it meets
        after them are copies of its first and change nothing it returns."""
        B, L = mask.shape
        m = mask[..., None].to(x.dtype)
        out = x
        bidirectional = self.layers[0].bidirectional
        if bidirectional:
            n = mask.sum(-1, dtype=torch.int64)[:, None]
            pos = torch.arange(L, device=x.device)[None]
            to_right = (pos - (L - n)).clamp(min=0)  # [B, L]: source of each right-aligned step
            to_left = (pos + (L - n)).clamp(max=L - 1)  # and back
        for i, layer in enumerate(self.layers):
            if i:
                out = self.dropout(out)
            if bidirectional:
                y, _ = self._run(layer, torch.cat([out, _take_steps(out, to_right)]))
                H = y.shape[-1] // 2
                y = torch.cat([y[:B, :, :H], _take_steps(y[B:, :, H:], to_left)], -1)
            else:
                y, _ = self._run(layer, out)
            out = y * m
        return out


def _take_steps(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """out[b, t] = x[b, index[b, t]]; x: [B, L, D], index: [B, L]."""
    return x.gather(1, index[..., None].expand(-1, -1, x.shape[-1]))


def reverse_padded(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each row's valid prefix reversed, padding left at 0 (the reference's
    dgcnv2.py:119-133).  x: [B, L, D]; mask: [B, L]."""
    L = x.shape[1]
    lengths = mask.sum(-1).to(torch.int64)
    rev = (lengths[:, None] - 1 - torch.arange(L, device=x.device)[None]).clamp(0, L - 1)
    return _take_steps(x, rev) * mask[..., None]
