"""Carry weights from the JAX package's flax trees onto the port's modules.

A flax tree is nested dicts of numpy arrays: ``params`` and, for modules
with running statistics, ``batch_stats``.  The same tree can come from a
flat ``.npz`` whose keys are ``/``-joined paths under ``params/`` and
``batch_stats/`` (``read_npz``), so JAX weights reach the card without JAX.

Layouts: a flax ``Dense.kernel`` is [in, out] and a torch ``Linear.weight``
[out, in]; the attention's packed projections, the RGCN ``weight`` /
``root`` / ``basis``, DialogueGCN's edge-attention ``weight`` and the
recurrent layers' ``w_ih`` / ``w_hh`` and MMGCN's GCNII ``convs`` keep
the JAX layout, as do DialogueGCN v2's DialogueRNN cells, edge attention
and nodal attention; a flax ``Conv`` kernel is [K, in, out] and a torch
``Conv1d.weight`` [out, in, K], and likewise HWIO → OIHW (``Conv2d``) and
THWIO → OIDHW (``Conv3d``), a grouped kernel's I being its group's inputs in
both; a flax ``BatchNorm``'s ``scale``/``bias`` and ``batch_stats``
``mean``/``var`` are ``weight``/``bias``/``running_mean``/``running_var``.
The video backbones (``resnet50``, ``tsm``, ``x3d``) map onto the port's
``preprocess/video.py``, ``tsm.py`` and ``x3d.py``.

    python -m erc_tpu_torch.convert [--module=NAME] variables.npz state_dict.pt

writes the state dict of module NAME (``cogmen``, the default, ``dagerc``,
``dgcn``, ``mmgcn``, ``dgcnv2``, ``dgcnv2_daily``, ``cim`` or
``cogmen_mosei``) that ``serve.InferenceEngine`` loads, of ``mmin_base``,
``mmin_miss`` or ``mmin_miss2``, which the MMIN trainers load (MMIN has no
serving engine), of ``resnet50``, ``tsm`` or ``x3d``, which the
extractors of ``preprocess/video.py`` load, of ``wideresnet`` or
``resnet_cifar`` (``models/image_backbones.py``), or of
``simple_attention``, ``matching_attention`` (its ``att_type`` read from the
tree) or ``mm_gated_attention`` (``ops/fusion.py``).
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


def birnn_state(p: Tree) -> Dict[str, torch.Tensor]:
    """ops.rnn.BiRNN: flax ``{w_ih,w_hh,b_ih,b_hh}_l{n}[_reverse]`` → layer n's
    ``{weight_ih,weight_hh,bias_ih,bias_hh}_l0[_reverse]``, the same layout."""
    names = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih", "b_hh": "bias_hh"}
    sd = {}
    for key, value in p.items():
        kind, rest = key.rsplit("_l", 1)
        layer, _, reverse = rest.partition("_")
        sd[f"layers.{layer}.{names[kind]}_l0{'_' + reverse if reverse else ''}"] = _t(value)
    return sd


def dgcn_state(params: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.dgcn.DGCNModule`` from its flax tree.  The
    banded JAX module names its GraphConv ``conv2_lin_rel`` / ``conv2_lin_root``
    at the top level, the dense one ``conv2/lin_rel`` / ``conv2/lin_root``:
    both load into ``conv2.lin_rel`` / ``conv2.lin_root``."""
    conv2 = params["conv2"] if "conv2" in params else {
        "lin_rel": params["conv2_lin_rel"], "lin_root": params["conv2_lin_root"]}
    return {
        **_prefixed("rnn", birnn_state(params["rnn"])),
        **_prefixed("edge_att", as_is_state(params["edge_att"])),
        **_prefixed("conv1", rgcn_state(params["conv1"])),
        **_prefixed("conv2.lin_rel", linear_state(conv2["lin_rel"])),
        **_prefixed("conv2.lin_root", linear_state(conv2["lin_root"])),
        **_prefixed("clf_lin1", linear_state(params["clf_lin1"])),
        **_prefixed("clf_lin2", linear_state(params["clf_lin2"])),
    }


def mmgcn_state(params: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.mmgcn.MMGCNModule`` from its flax tree,
    which is the same for both ``adj_impl``s; the encoders of the modalities
    the tree has, and ``gcnii/convs`` as is ([nlayers, 2·nh, nh] on both
    sides)."""
    sd = {}
    for name in ("linear_a", "linear_v", "linear_l", "fc0", "smax_fc"):
        if name in params:
            sd.update(_prefixed(name, linear_state(params[name])))
    if "lstm_l" in params:
        sd.update(_prefixed("lstm_l", birnn_state(params["lstm_l"])))
    if "speaker_embeddings" in params:
        sd["speaker_embeddings.weight"] = _t(params["speaker_embeddings"]["embedding"])
    sd["gcnii.convs"] = _t(params["gcnii"]["convs"])
    return sd


def conv1d_state(p: Tree) -> Dict[str, torch.Tensor]:
    """flax Conv {kernel [K, in, out], bias} → Conv1d {weight [out, in, K], bias}."""
    return {"weight": _t(np.transpose(p["kernel"], (2, 1, 0))), "bias": _t(p["bias"])}


def text_cnn_state(p: Tree) -> Dict[str, torch.Tensor]:
    """models.dgcnv2.CNNFeatureExtractor: flax ``embedding/embedding``,
    ``conv_{K}`` and ``fc``."""
    sd = {"embedding.weight": _t(p["embedding"]["embedding"]), **_prefixed("fc", linear_state(p["fc"]))}
    for name in p:
        if name.startswith("conv_"):
            sd.update(_prefixed(name, conv1d_state(p[name])))
    return sd


def dgcnv2_state(params: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.dgcnv2.DGCNV2Module`` from its flax tree,
    for every base encoder (``dialog_rnn_f``/``_r``, ``rnn`` or
    ``base_linear``) and for the token track (``cnn_feat_extractor``)."""
    sd = {}
    for name in ("dialog_rnn_f", "dialog_rnn_r", "att_model", "conv1"):
        if name in params:
            sd.update(_prefixed(name, as_is_state(params[name])))
    if "rnn" in params:
        sd.update(_prefixed("rnn", birnn_state(params["rnn"])))
    for name in ("base_linear", "linear", "smax_fc"):
        if name in params:
            sd.update(_prefixed(name, linear_state(params[name])))
    for name in ("lin_rel", "lin_root"):
        sd.update(_prefixed(f"conv2.{name}", linear_state(params["conv2"][name])))
    sd["matchatt_w"], sd["matchatt_b"] = _t(params["matchatt_w"]), _t(params["matchatt_b"])
    if "cnn_feat_extractor" in params:
        sd.update(_prefixed("cnn_feat_extractor", text_cnn_state(params["cnn_feat_extractor"])))
    return sd


def cim_state(params: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.cim.CIMModule`` from its flax tree (the
    same for both ``fused_rnn`` settings): the biGRUs ``rnn_{a,v,t}`` as
    ``birnn_state``, the adapters and heads as Dense → Linear."""
    sd = {}
    for m in ("a", "v", "t"):
        sd.update(_prefixed(f"rnn_{m}", birnn_state(params[f"rnn_{m}"])))
        sd.update(_prefixed(f"adapter_{m}", linear_state(params[f"adapter_{m}"])))
    for name in ("cls2", "cls7"):
        sd.update(_prefixed(name, linear_state(params[name])))
    return sd


def mmin_encoder_state(p: Tree) -> Dict[str, torch.Tensor]:
    """models.mmin_models' ``netA``/``netV`` (``LSTMEncoder``: ``rnn`` as
    ``birnn_state``, and the ``attention`` readout's ``attention_layer`` and
    ``attention_vector_weight`` where the tree has them) and ``netL``
    (``TextCNN``: ``conv{3,4,5}``, ``embd``)."""
    sd = {}
    for net in ("netA", "netV"):
        enc = p[net]
        sd.update(_prefixed(f"{net}.rnn", birnn_state(enc["rnn"])))
        if "attention_layer" in enc:
            sd.update(_prefixed(f"{net}.attention_layer", linear_state(enc["attention_layer"])))
            sd[f"{net}.attention_vector_weight"] = _t(enc["attention_vector_weight"])
    for name, leaf in p["netL"].items():
        sd.update(_prefixed(f"netL.{name}", (conv1d_state if name.startswith("conv") else linear_state)(leaf)))
    return sd


def dense_tree_state(p: Tree) -> Dict[str, torch.Tensor]:
    """A tree of Dense layers only (``Classifier``, ``ResidualAE``): each → Linear."""
    sd = {}
    for name, leaf in p.items():
        sd.update(_prefixed(name, linear_state(leaf)))
    return sd


def mmin_base_state(params: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.mmin_models.MMINBaseModule`` from its flax tree."""
    return {**mmin_encoder_state(params), **_prefixed("netC", dense_tree_state(params["netC"]))}


def mmin_miss_state(params: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.mmin_models.MMINMissModule``: the encoders,
    ``netAE``, ``netAE_cycle`` and ``netC``."""
    sd = mmin_encoder_state(params)
    for name in ("netAE", "netAE_cycle", "netC"):
        sd.update(_prefixed(name, dense_tree_state(params[name])))
    return sd


def mmin_miss2_state(params: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.mmin_models.MMINMiss2Module``: ``net`` and ``netB``."""
    return {**_prefixed("net", mmin_base_state(params["net"])), **_prefixed("netB", mmin_base_state(params["netB"]))}


def conv_state(p: Tree) -> Dict[str, torch.Tensor]:
    """flax Conv {kernel [*spatial, in/groups, out] (, bias)} → Conv2d/Conv3d
    {weight [out, in/groups, *spatial] (, bias)}."""
    k = np.asarray(p["kernel"])
    out = {"weight": _t(k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))).contiguous()}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def bn_state(p: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    """flax BatchNorm (eps 1e-5) → BatchNorm2d/3d, ``num_batches_tracked`` 0."""
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]), "running_mean": _t(stats["mean"]),
            "running_var": _t(stats["var"]), "num_batches_tracked": torch.zeros((), dtype=torch.long)}


def resnet50_state(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``preprocess.video.ResNet50`` (with or without the
    shift, which has no parameters): flax ``layer{L}_{i}`` → ``layer{L}.{i}``,
    ``downsample_conv``/``_bn`` → ``downsample.0``/``.1``."""
    sd = {**_prefixed("conv1", conv_state(params["conv1"])), **_prefixed("bn1", bn_state(params["bn1"],
                                                                                      batch_stats["bn1"]))}
    for name, p in params.items():
        if not name.startswith("layer"):
            continue
        st = batch_stats[name]
        dst = name.replace("_", ".")
        for k in (1, 2, 3):
            sd.update(_prefixed(f"{dst}.conv{k}", conv_state(p[f"conv{k}"])))
            sd.update(_prefixed(f"{dst}.bn{k}", bn_state(p[f"bn{k}"], st[f"bn{k}"])))
        if "downsample_conv" in p:
            sd.update(_prefixed(f"{dst}.downsample.0", conv_state(p["downsample_conv"])))
            sd.update(_prefixed(f"{dst}.downsample.1", bn_state(p["downsample_bn"], st["downsample_bn"])))
    return sd


def tsm_state(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``preprocess.tsm.TSMRecognizer``."""
    return {**_prefixed("base_model", resnet50_state(params["base_model"], batch_stats["base_model"])),
            **_prefixed("new_fc", linear_state(params["new_fc"]))}


def _x3d_unit(p: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    """One flax X3D level: ``<unit>_conv``/``<unit>_bn`` → ``<unit>.conv``/``.bn``,
    ``se_module`` → ``se_module.fc1``/``.fc2``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in p.items():
        if name == "se_module":
            for fc in ("fc1", "fc2"):
                sd.update(_prefixed(f"se_module.{fc}", conv_state(node[fc])))
            continue
        unit, kind = name.rsplit("_", 1)
        sd.update(_prefixed(f"{unit}.conv", conv_state(node)) if kind == "conv"
                  else _prefixed(f"{unit}.bn", bn_state(node, stats[name])))
    return sd


def x3d_state(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``preprocess.x3d.X3D`` (mmaction's names):
    ``conv1_s_conv`` → ``conv1_s.conv``, ``layer{L}_{i}/conv2_bn`` →
    ``layer{L}.{i}.conv2.bn`` and so on."""
    top = {k: v for k, v in params.items() if not k.startswith("layer")}
    sd = _x3d_unit(top, batch_stats)
    for name, p in params.items():
        if name.startswith("layer"):
            sd.update(_prefixed(name.replace("_", "."), _x3d_unit(p, batch_stats.get(name, {}))))
    return sd


def _dense_state(p: Tree) -> Dict[str, torch.Tensor]:
    """flax Dense with or without a bias → Linear."""
    out = {"weight": _t(p["kernel"]).T.contiguous()}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def simple_attention_state(params: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``ops.fusion.SimpleAttention``."""
    return _prefixed("scalar", _dense_state(params["scalar"]))


def matching_attention_state(params: Tree, att_type: str = "general") -> Dict[str, torch.Tensor]:
    """The state dict of ``ops.fusion.MatchingAttention(att_type=...)``: 'dot'
    has no parameters, 'general' a bias-free ``transform``, 'general2' a
    biased one, 'concat' ``transform`` and ``vector_prod``."""
    names = {"dot": (), "general": ("transform",), "general2": ("transform",),
             "concat": ("transform", "vector_prod")}[att_type]
    sd: Dict[str, torch.Tensor] = {}
    for name in names:
        sd.update(_prefixed(name, _dense_state(params[name])))
    return sd


def _att_type_of(params: Tree) -> str:
    if "vector_prod" in params:
        return "concat"
    if "transform" in params:
        return "general2" if "bias" in params["transform"] else "general"
    return "dot"


def mm_gated_attention_state(params: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``ops.fusion.MMGatedAttention``: the flax module's
    ``transform_{a,v,l,av,al,vl}`` that its modality subset made."""
    return {k: v for name, node in params.items() for k, v in _prefixed(name, linear_state(node)).items()}


def _flax_bn_state(p: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    """The image backbones' ``_BN`` (a flax BatchNorm named ``BatchNorm_0``
    inside) → ``models.image_backbones.BatchNorm2d``."""
    p, stats = p["BatchNorm_0"], stats["BatchNorm_0"]
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]), "running_mean": _t(stats["mean"]),
            "running_var": _t(stats["var"])}


def _image_backbone_state(params: Tree, batch_stats: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        dst = prefix + (name.replace("_", ".") if name.startswith("layer") else name)
        if "kernel" in node:
            sd.update(_prefixed(dst, conv_state(node)))
        elif "BatchNorm_0" in node:
            sd.update(_prefixed(dst, _flax_bn_state(node, batch_stats[name])))
        else:
            sd.update(_image_backbone_state(node, batch_stats.get(name, {}), dst + "."))
    return sd


def wideresnet_state(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.image_backbones.WideResnet``: flax
    ``layer{S}_{b}`` → ``layer{S}.{b}``, HWIO kernels → OIHW, each ``_BN``'s
    ``BatchNorm_0`` → the block's batch norm."""
    return _image_backbone_state(params, batch_stats)


def resnet_cifar_state(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.image_backbones.ResNetCifar`` (``resnet18``,
    ``resnet50``), mapped as ``wideresnet_state``."""
    return _image_backbone_state(params, batch_stats)


STATES = {
    "cogmen": lambda trees: cogmen_state(trees["params"], trees["batch_stats"]),
    "dagerc": lambda trees: dagerc_state(trees["params"]),
    "dgcn": lambda trees: dgcn_state(trees["params"]),
    "mmgcn": lambda trees: mmgcn_state(trees["params"]),
    "dgcnv2": lambda trees: dgcnv2_state(trees["params"]),
    "dgcnv2_daily": lambda trees: dgcnv2_state(trees["params"]),
    "cim": lambda trees: cim_state(trees["params"]),
    "cogmen_mosei": lambda trees: cogmen_state(trees["params"], trees["batch_stats"]),
    "mmin_base": lambda trees: mmin_base_state(trees["params"]),
    "mmin_miss": lambda trees: mmin_miss_state(trees["params"]),
    "mmin_miss2": lambda trees: mmin_miss2_state(trees["params"]),
    "resnet50": lambda trees: resnet50_state(trees["params"], trees["batch_stats"]),
    "tsm": lambda trees: tsm_state(trees["params"], trees["batch_stats"]),
    "x3d": lambda trees: x3d_state(trees["params"], trees["batch_stats"]),
    "wideresnet": lambda trees: wideresnet_state(trees["params"], trees["batch_stats"]),
    "resnet_cifar": lambda trees: resnet_cifar_state(trees["params"], trees["batch_stats"]),
    "simple_attention": lambda trees: simple_attention_state(trees["params"]),
    "matching_attention": lambda trees: matching_attention_state(trees["params"], _att_type_of(trees["params"])),
    "mm_gated_attention": lambda trees: mm_gated_attention_state(trees["params"]),
}
USAGE = ("usage: python -m erc_tpu_torch.convert [--module=cogmen|dagerc|dgcn|mmgcn|dgcnv2|dgcnv2_daily|cim|"
         "cogmen_mosei|mmin_base|mmin_miss|mmin_miss2|resnet50|tsm|x3d|wideresnet|resnet_cifar|simple_attention|"
         "matching_attention|mm_gated_attention] variables.npz state_dict.pt")


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
