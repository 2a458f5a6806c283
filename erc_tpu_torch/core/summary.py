"""Model summary: parameters by module, output shapes and the footprint.

Port of ``erc_tpu.core.summary`` (the reference's vendored pytorch-summary,
lumo/sketch/torchsummary.py:19-122): ``param_summary`` groups a module's
``named_parameters`` by path prefix with counts and bytes;
``summarize_model`` runs the module once on a batch (eval mode, no grad)
with forward hooks that take each row's output shapes, and prints the
table with the torchsummary footprint block.  The JAX version evaluates
abstractly; here the batch is a real one, so give it a small one on the
CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch


def _rows(named, depth: int) -> List[Dict]:
    groups: Dict[str, Dict] = {}
    for name, t in named:
        prefix = ".".join(name.split(".")[:depth]) or "(root)"
        g = groups.setdefault(prefix, {"module": prefix, "n_params": 0, "bytes": 0})
        g["n_params"] += t.numel()
        g["bytes"] += t.numel() * t.element_size()
    return list(groups.values())


def param_summary(model: torch.nn.Module, depth: int = 2) -> List[Dict]:
    """Rows of {module, n_params, bytes} over the parameters, grouped by the
    first ``depth`` parts of their names, in registration order."""
    return _rows(model.named_parameters(), depth)


def _shapes(out) -> List[Tuple[int, ...]]:
    return [tuple(t.shape) for t in tensors(out)]


def _fmt_shapes(shapes) -> str:
    return ", ".join("x".join(map(str, s)) or "scalar" for s in shapes)


def summarize_model(model: torch.nn.Module, batch: Any, depth: int = 2) -> str:
    """The summary table of ``model`` run once on ``batch`` (a dict of
    tensors, or one tensor): per row of ``param_summary`` (buffers as
    ``buffers/<prefix>`` rows) its parameters, bytes and, where the row is a
    module, its output shapes; then the model's output shapes, the totals
    and the footprint in MB (forward/backward: twice the outputs' float32
    bytes, torchsummary's estimate)."""
    rows = param_summary(model, depth)
    rows += [{**r, "module": f"buffers/{r['module']}"} for r in _rows(model.named_buffers(), depth)]
    modules = dict(model.named_modules())
    seen: Dict[str, str] = {}

    def hook(name):
        def record(m, args, out):  # returns None: the output stays as it is
            seen.setdefault(name, _fmt_shapes(_shapes(out)))
        return record

    hooks = [modules[r["module"]].register_forward_hook(hook(r["module"])) for r in rows if r["module"] in modules]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            outputs = model(batch)
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)

    w_mod = max([len(r["module"]) for r in rows] + [12])
    w_out = max([len(v) for v in seen.values()] + [12])
    width = w_mod + w_out + 32
    lines = ["-" * width, f"{'Module':<{w_mod}}  {'Output':<{w_out}}  {'Param #':>12}  {'Bytes':>12}", "=" * width]
    for r in rows:
        lines.append(f"{r['module']:<{w_mod}}  {seen.get(r['module'], ''):<{w_out}}  "
                     f"{r['n_params']:>12,}  {r['bytes']:>12,}")
    lines.append("=" * width)
    total = sum(r["n_params"] for r in rows)
    trainable = sum(t.numel() for t in model.parameters() if t.requires_grad)
    inputs = tensors(batch)
    out_shapes = _shapes(outputs)
    mb = 1024.0 ** 2
    lines += [
        f"Model: {type(model).__name__}",
        f"Output shape(s): {_fmt_shapes(out_shapes)}",
        f"Total params: {total:,}",
        f"Trainable params: {trainable:,}",
        f"Non-trainable params: {total - trainable:,}",
        "-" * width,
        f"Input size (MB): {sum(t.numel() * t.element_size() for t in inputs) / mb:.2f}",
        f"Forward/backward pass size (MB): {2 * sum(_numel(s) for s in out_shapes) * 4 / mb:.2f}",
        f"Params size (MB): {sum(r['bytes'] for r in rows) / mb:.2f}",
        "-" * width,
    ]
    return "\n".join(lines)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def tensors(batch) -> List[torch.Tensor]:
    """The tensors of a tensor, or of a dict, tuple or list of them (nested)."""
    if isinstance(batch, torch.Tensor):
        return [batch]
    if isinstance(batch, dict):
        batch = list(batch.values())
    if isinstance(batch, (tuple, list)):
        return [t for b in batch for t in tensors(b)]
    return []
