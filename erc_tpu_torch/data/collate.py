"""Static-shape dialogue batching.

Port of ``erc_tpu.data.collate``: lengths round up to a few buckets, and
the batch dict has the same keys, dtypes and values as the JAX package's
``ERCBatcher`` (label padded with -1, speakers with 0; MOSEI samples add
``emo_label`` and ``senti2_label``).  A one-entry speaker row
(``mosei_cim``'s ``[0]``) is broadcast over the dialogue.  The mask, labels,
speakers and features are packed by the native packer (``data.native``,
``csrc/collate.cpp``), as in the JAX package, on one thread (the JAX
package's 4 spawned threads a call were slower on the H100's host);
``native=False`` packs them with ``_pack``, the plain numpy version, which
gives the same arrays bit for bit.  ``shard`` packs one rank's rows of a
batch (``data.loader`` over several processes) at the whole batch's length.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def bucket_length(L: int, bucket: int = 0, max_len: int = 128) -> int:
    """bucket <= 0 → single bucket (always pad to max_len); otherwise round
    L up to a multiple of `bucket`, capped at max_len."""
    if bucket <= 0:
        return max_len
    return min(max(((L + bucket - 1) // bucket) * bucket, bucket), max_len)


def _pack(rows: List[np.ndarray], lens: np.ndarray, shape: tuple, dtype, fill) -> np.ndarray:
    """Rows of [len_i, ...] into a [Bp, L, ...] array; rows past len(rows)
    and positions past lens[i] hold `fill`."""
    out = np.full(shape, fill, dtype)
    for i, r in enumerate(rows):
        n = int(lens[i])
        out[i, :n] = np.asarray(r, dtype)[:n]
    return out


class ERCBatcher:
    def __init__(
        self,
        modality: str = "atv",
        n_classes: int = 6,
        n_speakers: int = 2,
        speaker_onehot: bool = False,
        bucket: int = 0,
        max_len: int = 128,
        pad_batch_to: Optional[int] = None,
        native: bool = True,
    ):
        self.modality = modality
        self.n_classes = n_classes
        self.n_speakers = n_speakers
        self.speaker_onehot = speaker_onehot
        self.bucket = bucket
        self.max_len = max_len
        self.pad_batch_to = pad_batch_to
        self.native = native

    def length_of(self, samples: List[dict]) -> int:
        """The padded length of a batch of ``samples``: the bucket of the longest."""
        return bucket_length(max(min(len(s["text"]), self.max_len) for s in samples), self.bucket, self.max_len)

    def __call__(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        return self._collate(samples, self.pad_batch_to or len(samples), self.length_of(samples), samples[0])

    def shard(self, samples: List[dict], rank: int, world: int) -> Dict[str, np.ndarray]:
        """Rank ``rank``'s rows of the batch of ``samples`` among ``world``
        ranks: rows ``rank, rank + world, ...``, padded to ⌈Bp / world⌉ rows
        (Bp the whole batch's padded size) at the length of the whole batch,
        so that every rank's batch has one shape; a rank may get padding rows
        only."""
        Bp = self.pad_batch_to or len(samples)
        return self._collate(samples[rank::world], -(-Bp // world), self.length_of(samples), samples[0])

    def _collate(self, samples: List[dict], Bp: int, L: int, like: dict) -> Dict[str, np.ndarray]:
        """``samples`` padded to ``Bp`` rows of length ``L``; feature widths and
        keys from ``like``."""
        B = len(samples)
        if B > Bp:
            raise ValueError(f"{B} dialogues do not fit a batch padded to {Bp}")
        lengths = np.array([min(len(s["text"]), self.max_len) for s in samples], dtype=np.int32)
        lengths = np.minimum(lengths, L)
        lens_p = np.zeros(Bp, np.int32)
        lens_p[:B] = lengths

        pad = [None] * (Bp - B)
        if self.native:
            from erc_tpu_torch.data import native

            mask = native.fill_mask(lens_p, L)

            def labels(rows, fill):
                return native.pack_labels(rows + pad, lens_p, L, fill)

            def features(rows, D):
                return native.pack_rows(rows + pad, lens_p, L, D, n_threads=1)
        else:
            mask = (np.arange(L)[None, :] < lens_p[:, None]).astype(np.float32)

            def labels(rows, fill):
                return _pack(rows, lens_p, (Bp, L), np.int32, fill)

            def features(rows, D):
                return _pack(rows, lens_p, (Bp, L, D), np.float32, 0.0)

        label = labels([np.asarray(s["label"]) for s in samples], -1)

        spk_rows = []
        for s in samples:
            spk_arr = np.asarray(s["speakers"])
            if spk_arr.ndim == 2 and spk_arr.shape[0] >= 1 and spk_arr.shape[0] < len(s["label"]):
                spk_rows.append(np.zeros(len(s["label"]), np.int32))  # MOSEI [[0]]
            elif spk_arr.ndim == 2:
                spk_rows.append(spk_arr.argmax(-1).astype(np.int32))
            elif spk_arr.shape[0] == 1:  # mosei_cim's one entry [0] for the whole dialogue
                spk_rows.append(np.full(len(s["label"]), spk_arr[0], np.int32))
            else:
                spk_rows.append(spk_arr.astype(np.int32))
        spk = labels(spk_rows, 0)

        mod_arrays = {}
        key_of = {"a": "audio", "t": "text", "v": "visual"}
        for m in self.modality:
            D = np.asarray(like[key_of[m]]).shape[-1]
            mod_arrays[m] = features([np.asarray(s[key_of[m]], np.float32) for s in samples], D)

        input_tensor = np.concatenate([mod_arrays[m] for m in self.modality], -1)

        # MOSEI's multitask labels: multi-hot emotions (0 past each length)
        # and binary sentiment (-1 past each length)
        multitask = {}
        if "emo_label" in like:
            multitask["emo_label"] = _pack([s["emo_label"] for s in samples], lens_p, (Bp, L, 7), np.int32, 0)
            multitask["senti2_label"] = _pack([s["senti2_label"] for s in samples], lens_p, (Bp, L), np.int32, -1)

        if self.speaker_onehot:
            speaker_tensor = np.eye(self.n_speakers, dtype=np.float32)[spk] * mask[..., None]
        else:
            speaker_tensor = spk

        return {
            "attention_mask": mask,
            "text_length": lens_p,
            "text_feature": mod_arrays.get("t"),
            "audio_feature": mod_arrays.get("a"),
            "visual_feature": mod_arrays.get("v"),
            "input_tensor": input_tensor,
            "speaker_tensor": speaker_tensor,
            "speaker_ids": spk,
            "label": label,
            **multitask,
        }
