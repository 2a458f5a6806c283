"""The TSM (Temporal Shift Module) recognizer: the TSN head over the
shift-enabled ResNet-50.

Port of ``erc_tpu.preprocess.tsm`` (reference preprocess/video/
tsm_model.py: TemporalShift :26-59, make_temporal_shift place='blockres'
:112-155, ConsensusModule :224-250, TSN :619-770).  The shift is
``video.temporal_shift``; ``ResNet50(n_segment=T)`` is the shifted backbone.
The head: per-frame features → dropout (training only) → ``new_fc`` → the
segment consensus (``avg`` or ``identity``); ``before_softmax=False``
applies the softmax before the mean (:750; only with ``avg``).

``port_torch_tsm`` takes a torch TSN/TSM checkpoint: the TemporalShift
wrapper's ``layerX.Y.conv1.net.*`` keys lose their ``.net``, a
``module.`` prefix is stripped, and the classifier is ``new_fc`` or, in a
dropout-0 checkpoint, ``base_model.fc`` (TSN._prepare_tsn, :688-696).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from erc_tpu_torch.preprocess.video import ResNet50, port_torch_resnet, temporal_shift

__all__ = ["TSMRecognizer", "port_torch_tsm", "temporal_shift"]


class TSMRecognizer(nn.Module):
    """[N, T, 3, H, W] normalised frames → [N, num_class] (``avg``) or
    [N, T, num_class] (``identity``)."""

    def __init__(self, num_class: int, n_segment: int = 8, n_div: int = 8, dropout: float = 0.8,
                 consensus: str = "avg", before_softmax: bool = True, is_shift: bool = True):
        super().__init__()
        self.num_class, self.n_segment = num_class, n_segment
        self.consensus, self.before_softmax = consensus, before_softmax
        self.base_model = ResNet50(n_segment=n_segment if is_shift else 0, n_div=n_div)
        self.drop = nn.Dropout(dropout)
        self.new_fc = nn.Linear(2048, num_class)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t = x.shape[:2]
        assert t == self.n_segment, (t, self.n_segment)
        feats = self.base_model(x.reshape((n * t,) + x.shape[2:]))  # [N·T, 2048]
        logits = self.new_fc(self.drop(feats))
        if not self.before_softmax:
            if self.consensus != "avg":  # tsm_model.py:646-647
                raise ValueError("Only avg consensus can be used after Softmax")
            logits = torch.softmax(logits, -1)
        logits = logits.reshape(n, t, self.num_class)
        return logits.mean(1) if self.consensus == "avg" else logits


def port_torch_tsm(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A torch TSN/TSM ``state_dict`` → the state dict of the port's
    ``TSMRecognizer`` (bare or ``module.``-prefixed keys, the TemporalShift
    ``conv1.net.*`` nesting)."""

    def norm_key(k: str) -> str:
        if k.startswith("module."):
            k = k[len("module."):]
        return k.replace(".conv1.net.", ".conv1.")

    sd = {norm_key(k): v for k, v in state_dict.items()}
    out = {f"base_model.{k}": v for k, v in port_torch_resnet(sd, "base_model.").items()}
    if "new_fc.weight" in sd:
        fc_w, fc_b = sd["new_fc.weight"], sd["new_fc.bias"]
    elif "base_model.fc.weight" in sd:
        fc_w, fc_b = sd["base_model.fc.weight"], sd["base_model.fc.bias"]
    else:
        raise KeyError("TSM checkpoint has neither new_fc nor base_model.fc — "
                       f"classifier missing (keys: {sorted(sd)[:5]}…)")
    out["new_fc.weight"] = torch.as_tensor(fc_w).float()
    out["new_fc.bias"] = torch.as_tensor(fc_b).float()
    return out
