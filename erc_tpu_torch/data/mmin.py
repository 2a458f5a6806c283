"""MMIN's utterance-level data: the readers and the batcher.

Port of ``erc_tpu.data.mmin``, the port's own copy:

- ``iemocap_mmin_4``: the MMIN2021 IEMOCAP dump (ComparE audio [T, 130],
  Denseface visual [50, 342], BERT-large text [22, 1024] in h5 files, the
  fold's labels and names in npy files).  It needs ``h5py``, imported when it
  is called: the package does not depend on it;
- ``synthetic_mmin``: utterances with that geometry made in memory from a
  seed, the same numpy arrays as the JAX package's for the same arguments;
- ``MMINBatcher``: static-shape batches of utterances (audio cut or
  zero-padded to ``max_audio_len``, rows padded to ``pad_batch_to`` with
  ``sample_mask`` 0 and label -1), and the ``Missing`` augmentation: each
  row keeps one of six modality patterns (``MISSING_TYPES``) drawn from the
  generator it was given, and the dropped features go to ``*_reverse``;
  ``shard`` packs one rank's rows of a batch with the patterns the whole
  batch draws for them.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

MISSING_TYPES = np.array(
    [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1]], dtype=np.float32
)  # order: visual, text, audio


def iemocap_mmin_4(root, split="train"):
    """The fold-1 split of ``<root>/MMIN2021/IEMOCAP_features_2021``: sample
    dicts with ``visual_feature``, ``text_feature``, ``audio_feature``,
    ``label`` (argmax of the one-hot labels) and ``name``."""
    import h5py

    base = os.path.join(root, "MMIN2021/IEMOCAP_features_2021")

    def h5map(rel):
        with h5py.File(os.path.join(base, rel)) as f:
            return {k: f[k][()] for k in f.keys()}

    v = h5map("V/denseface.h5")
    a = h5map("A/comparE.h5")
    t = h5map("L/bert_large.h5")
    tag = {"train": "trn", "val": "val", "test": "tst"}.get(split, "tst")
    label = np.argmax(np.load(os.path.join(base, "target", "1", f"{tag}_label.npy")), axis=1)
    int2name = [i[0].decode() for i in np.load(os.path.join(base, "target", "1", f"{tag}_int2name.npy")).tolist()]
    return [
        {"visual_feature": v[name], "text_feature": t[name], "audio_feature": a[name], "label": label[i],
         "name": name}
        for i, name in enumerate(int2name)
    ]


def synthetic_mmin(n_classes=4, split="train", n_train=256, n_test=64, seed=0):
    """Class prototypes plus noise with MMIN's geometry; audio 30–119 frames.
    Each split draws from its own stream (val is not test)."""
    rng = np.random.default_rng(seed + {"train": 0, "test": 1, "val": 2, "valid": 2}.get(split, 3))
    proto = np.random.default_rng(seed + 99)
    protos = {
        "v": proto.normal(size=(n_classes, 342)).astype(np.float32),
        "t": proto.normal(size=(n_classes, 1024)).astype(np.float32),
        "a": proto.normal(size=(n_classes, 130)).astype(np.float32),
    }
    n = n_train if split == "train" else n_test
    res = []
    for i in range(n):
        y = int(rng.integers(0, n_classes))
        T_a = int(rng.integers(30, 120))
        res.append({
            "visual_feature": (protos["v"][y] + 0.8 * rng.normal(size=(50, 342))).astype(np.float32),
            "text_feature": (protos["t"][y] + 0.8 * rng.normal(size=(22, 1024))).astype(np.float32),
            "audio_feature": (protos["a"][y] + 0.8 * rng.normal(size=(T_a, 130))).astype(np.float32),
            "label": y,
            "name": f"utt_{split}_{i}",
        })
    return res


def pick_mmin_datas(root, dataset_name: str, split="train"):
    if dataset_name.startswith("synthetic"):
        return synthetic_mmin(round(float(dataset_name.split("-")[-1])), split)
    if dataset_name == "iemocap-mmin-4":
        return iemocap_mmin_4(root, split)
    raise ValueError(f"unknown mmin dataset {dataset_name!r}")


class MMINBatcher:
    """Static-shape utterance batching with optional Missing augmentation."""

    def __init__(self, max_audio_len: int = 128, has_miss: bool = False, pad_batch_to: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None):
        self.max_audio_len = max_audio_len
        self.has_miss = has_miss
        self.pad_batch_to = pad_batch_to
        self.rng = rng or np.random.default_rng(0)

    def _patterns(self, Bp: int) -> Optional[np.ndarray]:
        """The Missing patterns of a batch of ``Bp`` rows, one a row (None without Missing)."""
        return MISSING_TYPES[self.rng.integers(0, len(MISSING_TYPES), Bp)] if self.has_miss else None

    def __call__(self, samples: List[dict]) -> dict:
        Bp = self.pad_batch_to or len(samples)
        return self._collate(samples, Bp, self._patterns(Bp), samples[0])

    def shard(self, samples: List[dict], rank: int, world: int) -> dict:
        """Rank ``rank``'s rows of the batch of ``samples`` among ``world``
        ranks: rows ``rank, rank + world, ...`` padded to ⌈Bp / world⌉ rows,
        with the Missing patterns that the whole batch draws for them (every
        rank draws the whole batch's, so the generator stays in step and a
        row's pattern is the one it gets in one process)."""
        Bp = self.pad_batch_to or len(samples)
        rows = -(-Bp // world)
        typ = self._patterns(Bp)
        if typ is not None:
            mine = typ[rank::world]
            typ = np.concatenate([mine, np.repeat(MISSING_TYPES[:1], rows - len(mine), 0)])
        return self._collate(samples[rank::world], rows, typ, samples[0])

    def _collate(self, samples: List[dict], Bp: int, typ: Optional[np.ndarray], like: dict) -> dict:
        """``samples`` padded to ``Bp`` rows, widths from ``like``; ``typ`` the
        rows' Missing patterns."""
        A = self.max_audio_len
        a_dim = like["audio_feature"].shape[-1]
        v = np.zeros((Bp,) + like["visual_feature"].shape, np.float32)
        t = np.zeros((Bp,) + like["text_feature"].shape, np.float32)
        a = np.zeros((Bp, A, a_dim), np.float32)
        a_len = np.zeros(Bp, np.int32)
        label = np.full(Bp, -1, np.int32)
        sample_mask = np.zeros(Bp, np.float32)
        for i, s in enumerate(samples):
            v[i] = s["visual_feature"]
            t[i] = s["text_feature"]
            af = np.asarray(s["audio_feature"], np.float32)[:A]
            a[i, : len(af)] = af
            a_len[i] = len(af)
            label[i] = s["label"]
            sample_mask[i] = 1
        batch = {"visual_feature": v, "text_feature": t, "audio_feature": a, "audio_length": a_len, "label": label,
                 "sample_mask": sample_mask}
        if typ is not None:
            for i, key in enumerate(["visual_feature", "text_feature", "audio_feature"]):
                keep = typ[:, i][:, None, None]
                batch[f"{key}_reverse"] = batch[key] * (1.0 - keep)
                batch[key] = batch[key] * keep
            batch["missing_type"] = typ
        return batch
