"""Feature-dump readers: IEMOCAP in the COGMEN dump, MELD in the MMGCN dump.

Port of ``erc_tpu.data.readers`` for the ``iemocap-cogmen-*`` and
``meld-mmgcn-*`` names (the reference's pickle formats:
mmdatasets/datas/mm/iemocap_feature.py:360-408, meld_feature.py:14-45).
Every reader returns a list of per-dialogue sample dicts with keys
    speakers   — list of one-hot speaker vectors per utterance
    visual / audio / text — [L_i, D_m] float arrays
    label      — [L_i] int array
    sentence   — list of strings
    ids        — the dialogue's id.
The MOSEI readers come with the slice that needs them.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def load_pkl(path: str):
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"feature dump not found: {path}\n"
            "Point ERC_TPU_DATA_ROOT (or .erc_tpurc.json data_root) at a "
            "directory holding the reference-format dumps, or use a "
            "synthetic-* dataset name to generate data in-memory."
        ) from None


def _apply_text_visual_swap(root, subdir, video_text, video_visual, text, visual):
    """sbert/robert text and tsn/tsnss/x3d (+ concatenated) visual replacement
    (iemocap_feature.py:369-393)."""
    text_fn = None
    if text == "robert":
        text_fn = os.path.join(root, subdir, "robert_map.pkl")
    elif text == "sbert":
        text_fn = os.path.join(root, subdir, "sbert_map.pkl")
    if text_fn:
        video_text = load_pkl(text_fn)

    visual_fn = None
    if visual and "tsnss" in visual:
        visual_fn = os.path.join(root, subdir, "tsn_vfeat_ss.pkl")
    elif visual and "tsn" in visual:
        visual_fn = os.path.join(root, subdir, "tsn_vfeat.pkl")
    elif visual and "x3d" in visual:
        visual_fn = os.path.join(root, subdir, "x3d_vfeat.pkl")
    if visual_fn:
        new_visual = load_pkl(visual_fn)
        if "+" in visual:
            video_visual = {k: np.concatenate([video_visual[k], new_visual[k]], axis=1) for k in new_visual}
        else:
            video_visual = new_visual
    return video_text, video_visual


def _iemocap_cogmen(root, pkl_rel, subdir, split, text="", visual=""):
    (video_ids, video_speakers, video_labels, video_text, video_audio,
     video_visual, video_sentence, train_ids, test_ids) = load_pkl(os.path.join(root, pkl_rel))
    video_text, video_visual = _apply_text_visual_swap(root, subdir, video_text, video_visual, text, visual)
    ids = train_ids if split == "train" else test_ids
    return [
        {
            "ids": video_ids[k],
            "speakers": [[1, 0] if s == "M" else [0, 1] for s in video_speakers[k]],
            "visual": video_visual[k],
            "audio": video_audio[k],
            "text": video_text[k],
            "label": video_labels[k],
            "sentence": video_sentence[k],
        }
        for k in ids
    ]


def iemocap_cogmen_6(root, split="train", text="", visual=""):
    """The 9-tuple COGMEN dump, 6 classes (iemocap_feature.py:360-408)."""
    return _iemocap_cogmen(root, "cogmen/iemocap/IEMOCAP_features.pkl", "cogmen/iemocap", split, text, visual)


def iemocap_cogmen_4(root, split="train", text="", visual=""):
    """The 9-tuple COGMEN dump, 4 classes."""
    return _iemocap_cogmen(root, "cogmen/iemocap_4/IEMOCAP_features_4.pkl", "cogmen/iemocap_4", split, text,
                           visual)


def meld_mmgcn_7(root, split="train", text=None):
    """The 10-tuple MMGCN MELD dump, 7 classes (meld_feature.py:14-45);
    ``text="sbert"`` takes the text features from ``MMGCN/sbert_map.pkl``.
    The speakers are the dump's one-hot rows; features become float32."""
    (video_ids, video_speakers, video_labels, video_text, video_audio, video_visual, video_sentence,
     train_ids, test_ids, _) = load_pkl(os.path.join(root, "MMGCN/MELD_features_raw.pkl"))
    if text == "sbert":
        video_text = load_pkl(os.path.join(root, "MMGCN", "sbert_map.pkl"))
    ids = train_ids if split == "train" else test_ids
    return [
        {
            "ids": video_ids[k],
            "speakers": video_speakers[k],
            "visual": video_visual[k].astype(np.float32),
            "audio": video_audio[k].astype(np.float32),
            "text": video_text[k].astype(np.float32),
            "label": video_labels[k],
            "sentence": video_sentence[k],
        }
        for k in ids
    ]
