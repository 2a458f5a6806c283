"""DAG-ERC (Shen et al., ACL 2021), plain PyTorch in float32: the
published recurrence one utterance at a time, over each batch as the
reference pads it.  Imports nothing of the program.

For utterance i of a dialogue and each DAG layer, with H the layer's input
and h1 its outputs so far:

- predecessors: every earlier utterance back to, and including, the
  ``windowp``-th earlier turn of i's speaker (all earlier ones where there
  are fewer such turns);
- attention: a_ij = softmax_j(H_i·wq + h1_j·wk + b) over the predecessors;
- message: M_i = Σ_j a_ij (Wr0 h1_j if j's speaker is i's, else Wr1 h1_j),
  and M_0 = 0;
- node: h1_i = GRU_c(x=H_i, h=M_i) + GRU_p(x=M_i, h=H_i).

The model: H0 = relu(fc1(x)), the layers, then relu(out_0(·)) → relu(out_1)
→ out_2 on the concatenation [H0, h1 of each layer, x].  Dropout is 0.
The tensors' names are the port's ``state_dict`` keys; the initial bounds
are its initialisers' scales (a uniform of the same variance where it draws
a normal).
"""

from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path
from typing import Callable, Dict

import torch


def _plain():
    """``plain.py`` beside this file (references load by path, outside any package)."""
    spec = importlib.util.spec_from_file_location("perfbench_reference_plain", Path(__file__).with_name("plain.py"))
    if spec.name not in sys.modules:
        sys.modules[spec.name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[spec.name])
    return sys.modules[spec.name]


plain = _plain()


def _linear_spec(name: str, fan_in: int, fan_out: int) -> dict:
    # lecun normal: variance 1 / fan_in; a uniform of that variance
    return {f"{name}.weight": ((fan_out, fan_in), ("uniform", math.sqrt(3.0 / fan_in))),
            f"{name}.bias": ((fan_out,), ("zeros",))}


def param_specs(m: Dict) -> Dict:
    E, D, C, layers = int(m["input_width"]), int(m["hidden_dim"]), int(m["n_classes"]), int(m["gnn_layers"])
    specs = _linear_spec("fc1", E, D)
    s = 1.0 / math.sqrt(D)
    for l in range(layers):
        p = f"stack.layer_{l}_"
        specs[p + "att_w"] = ((2 * D, 1), ("uniform", 1.0 / math.sqrt(2 * D)))
        specs[p + "att_b"] = ((1,), ("uniform", 1.0 / math.sqrt(2 * D)))
        specs[p + "Wr0"] = ((D, D), ("uniform", s))
        specs[p + "Wr1"] = ((D, D), ("uniform", s))
        for cell in ("c", "p"):
            specs[p + f"gru_{cell}_w_ih"] = ((3 * D, D), ("uniform", s))
            specs[p + f"gru_{cell}_w_hh"] = ((3 * D, D), ("uniform", s))
            specs[p + f"gru_{cell}_b_ih"] = ((3 * D,), ("uniform", s))
            specs[p + f"gru_{cell}_b_hh"] = ((3 * D,), ("uniform", s))
    F = D * (layers + 1) + E
    specs.update(_linear_spec("out_0", F, D))
    specs.update(_linear_spec("out_1", D, D))
    specs.update(_linear_spec("out_2", D, C))
    return specs


def buffer_specs(m: Dict) -> Dict:
    return {}


def predecessors(speakers: torch.Tensor, lengths: torch.Tensor, windowp: int) -> torch.Tensor:
    """pred[b, i, j]: j is a predecessor of i (bool [B, L, L])."""
    B, L = speakers.shape
    same = speakers[:, :, None] == speakers[:, None, :]  # [b, i, k]
    idx = torch.arange(L, device=speakers.device)
    # a direct count: for each (i, j) the same-speaker turns k with j < k < i
    k = idx[None, None, None, :]
    i_ = idx[None, :, None, None]
    j_ = idx[None, None, :, None]
    between = ((k > j_) & (k < i_) & same[:, :, None, :]).sum(-1)
    valid = idx[None, :] < lengths[:, None]
    return (j_[..., 0] < i_[..., 0]) & (between < windowp) & valid[:, :, None] & valid[:, None, :]


def forward(params: Dict[str, torch.Tensor], buffers: Dict, batch: Dict, m: Dict, training: bool = False,
            mm: Callable = plain.mm, relu: Callable = torch.relu) -> torch.Tensor:
    """Logits [B, L, classes]; ``training`` changes nothing (dropout 0, no
    batch statistics).  Every ReLU goes through ``relu``, so that the first
    step's comparison can find its inputs (``plain.Relus``)."""
    x, spk = batch["x"], batch["speakers"]
    B, L, _ = x.shape
    D, layers = int(m["hidden_dim"]), int(m["gnn_layers"])
    pred = predecessors(spk, batch["lengths"], int(m["windowp"]))
    same = (spk[:, :, None] == spk[:, None, :]).to(x.dtype)
    lin = lambda h, name: plain.linear(h, params[name + ".weight"], params[name + ".bias"], mm)  # noqa: E731
    H = relu(lin(x, "fc1"))
    feats = [H]
    for l in range(layers):
        p = lambda n: params[f"stack.layer_{l}_{n}"]  # noqa: E731
        wq, wk = p("att_w")[:D], p("att_w")[D:]
        q = mm(H, wq)[..., 0] + p("att_b")[0]  # [B, L]
        outs, V0, V1, K = [], [], [], []
        for i in range(L):
            if i == 0:
                M = H.new_zeros(B, D)
            else:
                Kp = torch.stack(K, 1)  # [B, i]
                score = q[:, i, None] + Kp
                score = torch.where(pred[:, i, :i], score, torch.full_like(score, -1e30))
                a = torch.softmax(score, -1)
                s = same[:, i, :i]
                M = (mm((a * s)[:, None, :], torch.stack(V0, 1))
                     + mm((a * (1.0 - s))[:, None, :], torch.stack(V1, 1)))[:, 0]
            Hi = H[:, i]
            c = plain.gru_cell(Hi, M, p("gru_c_w_ih"), p("gru_c_w_hh"), p("gru_c_b_ih"), p("gru_c_b_hh"), mm)
            pp = plain.gru_cell(M, Hi, p("gru_p_w_ih"), p("gru_p_w_hh"), p("gru_p_b_ih"), p("gru_p_b_hh"), mm)
            h1 = c + pp
            outs.append(h1)
            V0.append(plain.linear(h1, p("Wr0"), None, mm))
            V1.append(plain.linear(h1, p("Wr1"), None, mm))
            K.append(mm(h1, wk)[:, 0])
        H = torch.stack(outs, 1)
        feats.append(H)
    h = relu(lin(torch.cat([*feats, x], -1), "out_0"))
    h = relu(lin(h, "out_1"))
    return lin(h, "out_2")

