"""Synthetic dialogue generator matching the real feature-dump geometry.

Port of ``erc_tpu.data.synthetic.synthetic_erc``: the same numpy streams
from the same seed.  Labels are a noisy function of the features, so a
model can learn on the data.
"""

from __future__ import annotations

import numpy as np

# dataset-name-driven dims
_DIMS = {
    "iemocap-cogmen": dict(text=100, audio=100, visual=512, n_speakers=2),
    "meld-mmgcn": dict(text=600, audio=300, visual=342, n_speakers=9),
    "mosei": dict(text=300, audio=74, visual=35, n_speakers=1),
}


def synthetic_erc(
    prefix: str,
    n_classes: int,
    split: str = "train",
    n_train: int = 120,
    n_test: int = 31,
    min_len: int = 16,
    max_len: int = 110,
    seed: int = 0,
    text_dim=None,
    audio_dim=None,
    visual_dim=None,
):
    dims = dict(_DIMS.get(prefix, _DIMS["iemocap-cogmen"]))
    if text_dim:
        dims["text"] = text_dim
    if audio_dim:
        dims["audio"] = audio_dim
    if visual_dim:
        dims["visual"] = visual_dim
    S = dims["n_speakers"]
    n = n_train if split == "train" else n_test
    # distinct stream per split, so val never silently equals test
    offset = {"train": 0, "test": 1, "val": 2, "valid": 2}.get(split, 3)
    rng = np.random.default_rng(seed + offset)
    # fixed class prototypes shared by all splits so test is learnable
    proto_rng = np.random.default_rng(seed + 1234)
    protos = {
        m: proto_rng.normal(size=(n_classes, dims[m])).astype(np.float32)
        for m in ("text", "audio", "visual")
    }
    res = []
    for _ in range(n):
        L = int(rng.integers(min_len, max_len + 1))
        label = rng.integers(0, n_classes, L)
        spk = rng.integers(0, S, L)
        sample = {
            "speakers": [np.eye(S, dtype=int)[s].tolist() for s in spk],
            "label": label.astype(np.int64),
            "sentence": [f"utt_{i}" for i in range(L)],
        }
        for m in ("text", "audio", "visual"):
            feat = protos[m][label] + 0.8 * rng.normal(size=(L, dims[m]))
            sample[m] = feat.astype(np.float32)
        res.append(sample)
    return res
