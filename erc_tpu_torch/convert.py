"""Carry weights from the JAX package's flax trees onto the port's modules.

A flax tree is nested dicts of numpy arrays: ``params`` and, for modules
with running statistics, ``batch_stats``.  The same tree can come from a
flat ``.npz`` whose keys are ``/``-joined paths under ``params/`` and
``batch_stats/`` (``read_npz``), so JAX weights reach the card without JAX.

Layouts: a flax ``Dense.kernel`` is [in, out] and a torch ``Linear.weight``
[out, in]; the attention's packed projections and the RGCN ``weight`` /
``root`` keep the JAX layout.

    python -m erc_tpu_torch.convert [--module=cogmen|dagerc] variables.npz state_dict.pt

writes the module's state dict (COGMEN by default) that
``serve.InferenceEngine`` loads.
"""

from __future__ import annotations

import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

Tree = Mapping[str, object]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _prefixed(prefix: str, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def linear_state(p: Tree) -> Dict[str, torch.Tensor]:
    """flax Dense {kernel [in, out], bias} → Linear {weight [out, in], bias}."""
    return {"weight": _t(p["kernel"]).T.contiguous(), "bias": _t(p["bias"])}


def layer_norm_state(p: Tree) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def attention_state(p: Tree) -> Dict[str, torch.Tensor]:
    return {k: _t(p[k]) for k in ("in_proj_weight", "in_proj_bias", "out_proj_weight", "out_proj_bias")}


def encoder_layer_state(p: Tree) -> Dict[str, torch.Tensor]:
    return {
        **_prefixed("self_attn", attention_state(p["MultiheadAttention_0"])),
        **_prefixed("linear1", linear_state(p["Dense_0"])),
        **_prefixed("linear2", linear_state(p["Dense_1"])),
        **_prefixed("norm1", layer_norm_state(p["LayerNorm_0"])),
        **_prefixed("norm2", layer_norm_state(p["LayerNorm_1"])),
    }


def encoder_state(p: Tree) -> Dict[str, torch.Tensor]:
    sd = {}
    n = sum(1 for k in p if k.startswith("TransformerEncoderLayer_"))
    for i in range(n):
        sd.update(_prefixed(f"layers.{i}", encoder_layer_state(p[f"TransformerEncoderLayer_{i}"])))
    return sd


def as_is_state(p: Tree) -> Dict[str, torch.Tensor]:
    """Leaves with the same names and layout on both sides."""
    return {k: _t(v) for k, v in p.items()}


def rgcn_state(p: Tree) -> Dict[str, torch.Tensor]:
    """DenseRGCN / BandedRGCN: the same names and layout on both sides."""
    return as_is_state(p)


def transformer_conv_state(p: Tree) -> Dict[str, torch.Tensor]:
    sd = {}
    for name in ("lin_query", "lin_key", "lin_value", "lin_skip"):
        sd.update(_prefixed(name, linear_state(p[name])))
    return sd


def batch_norm_state(p: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(stats["mean"]), "running_var": _t(stats["var"])}


def cogmen_state(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.cogmen.COGMENModule`` from its flax tree."""
    gcn = params["gcn"]
    sd = {
        **_prefixed("transformer_out", linear_state(params["transformer_out"])),
        **_prefixed("gcn.conv1", rgcn_state(gcn["conv1"])),
        **_prefixed("gcn.conv2", transformer_conv_state(gcn["conv2"])),
        **_prefixed("gcn.bn", batch_norm_state(gcn["bn"], batch_stats["gcn"]["bn"])),
        **_prefixed("cls_0", linear_state(params["cls_0"])),
        **_prefixed("cls_1", linear_state(params["cls_1"])),
    }
    if "encoder" in params:
        sd.update(_prefixed("encoder", encoder_state(params["encoder"])))
    return sd


def dagerc_state(params: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.dagerc.DAGERCModule`` from its flax tree,
    fused (``stack/layer_{l}_*``) or per layer (``layer_{l}/*``).  The DAG
    parameters have the same names and torch's layout on both sides."""
    sd = _prefixed("fc1", linear_state(params["fc1"]))
    for i in range(3):
        sd.update(_prefixed(f"out_{i}", linear_state(params[f"out_{i}"])))
    if "stack" in params:
        sd.update(_prefixed("stack", as_is_state(params["stack"])))
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for l in range(n_layers):
        sd.update(_prefixed(f"layers.{l}", as_is_state(params[f"layer_{l}"])))
    if "nodal_att" in params:
        sd.update(_prefixed("nodal_att.transform", linear_state(params["nodal_att"]["transform"])))
    return sd


STATES = {
    "cogmen": lambda trees: cogmen_state(trees["params"], trees["batch_stats"]),
    "dagerc": lambda trees: dagerc_state(trees["params"]),
}
USAGE = "usage: python -m erc_tpu_torch.convert [--module=cogmen|dagerc] variables.npz state_dict.pt"


def read_npz(path: str) -> Dict[str, dict]:
    """{'params': tree, 'batch_stats': tree} from a flat npz of '/'-joined paths."""
    trees: Dict[str, dict] = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = trees
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return trees


def main(argv: Optional[list] = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    module = "cogmen"
    paths = []
    for a in args:
        if a.startswith("--module="):
            module = a.split("=", 1)[1]
        else:
            paths.append(a)
    if len(paths) != 2 or module not in STATES:
        raise SystemExit(USAGE)
    torch.save(STATES[module](read_npz(paths[0])), paths[1])


if __name__ == "__main__":
    main()
