"""Synthetic dialogue generators matching the real corpora's geometry.

Port of ``erc_tpu.data.synthetic.synthetic_erc`` (feature dialogues),
``synthetic_mosei`` (MOSEI dialogues with multitask labels) and
``synthetic_daily`` (DailyDialog token dialogues): the same numpy streams
from the same seed.  Labels are a noisy function of the features or
tokens, so a model can learn on the data.
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


def synthetic_mosei(n_classes: int, split: str = "train", seed: int = 0, **kw):
    """MOSEI-shaped dialogues (text 300, audio 74, visual 35, one speaker
    row ``[[0]]``) with the multitask labels: a multi-hot ``emo_label`` [L, 7]
    of the 7-way label, ``senti2_label`` and ``senti7_label`` derived from it
    with 10 % flips; ``label`` is ``senti2_label`` at 2 classes, else the
    7-way label.  The same numpy stream as the JAX package's
    ``synthetic_mosei`` from the same seed."""
    base = synthetic_erc("mosei", 7, split, seed=seed, **kw)
    rng = np.random.default_rng(seed + 7)
    for s in base:
        L = len(s["label"])
        s["speakers"] = [[0]]
        emo = np.zeros((L, 7), dtype=int)
        emo[np.arange(L), s["label"]] = 1
        s["emo_label"] = emo
        # sentiment follows the (feature-correlated) emotion label, so a
        # sentiment head can learn on the data
        flip = rng.random(L) < 0.1
        s["senti2_label"] = np.where(flip, rng.integers(0, 2, L), (s["label"] >= 4).astype(np.int64))
        s["senti7_label"] = np.where(flip, rng.integers(0, 7, L), s["label"])
        s["label"] = s["senti2_label"].astype(np.int64) if n_classes == 2 else s["label"]
    return base


def synthetic_daily(n_classes=7, split="train", n_train=24, vocab=400,
                    min_len=4, max_len=12, n_words=20, seed=0):
    """Token dialogues shaped like the DailyDialog reader's output
    (``data/dailydialog.py``): the same numpy stream as the JAX package's
    ``synthetic_daily`` from the same seed."""
    rng = np.random.default_rng(seed + {"train": 0, "test": 1}.get(split, 2))
    n = n_train if split == "train" else max(n_train // 3, 2)
    # each class draws most tokens from its own slice of the vocabulary (20 %
    # uniform noise), so the token track can learn on the data
    band = max((vocab - 2) // max(n_classes, 1), 1)
    out = []
    for _ in range(n):
        ln = int(rng.integers(min_len, max_len + 1))
        labels = rng.integers(0, n_classes, size=ln)
        tokens = []
        for y in labels:
            k = int(rng.integers(3, n_words))
            # the band stays inside [1, vocab) however small the vocabulary
            lo = min(1 + int(y) * band, max(vocab - band, 1))
            toks = rng.integers(lo, min(lo + band, vocab), size=k)
            noise = rng.random(k) < 0.2
            toks = np.where(noise, rng.integers(1, vocab, size=k), toks)
            tokens.append(toks.tolist())
        out.append({"tokens": tokens, "speakers": rng.integers(0, 2, size=ln).tolist(), "label": labels.tolist()})
    return out
