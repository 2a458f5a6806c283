"""Feature-dump readers: IEMOCAP in the COGMEN dump, MELD in the MMGCN dump,
MOSEI in the adapted pickle and in the CIM npz dumps.

Port of ``erc_tpu.data.readers`` for the ``iemocap-cogmen-*``,
``meld-mmgcn-*`` and ``mosei-*`` names (the reference's formats:
mmdatasets/datas/mm/iemocap_feature.py:360-408, meld_feature.py:14-45,
mosei_feature.py:55-223).  Every reader returns a list of per-dialogue
sample dicts with keys
    speakers   — list of one-hot speaker vectors per utterance (MOSEI: one
                 row for the whole video, ``[[0]]`` or ``[0]``)
    visual / audio / text — [L_i, D_m] float arrays
    label      — [L_i] int array
    sentence   — list of strings (not in the CIM dumps)
    ids        — the dialogue's id
plus MOSEI's ``emo_label`` [L_i, 7] multi-hot, ``senti2_label`` and
``senti7_label``.

The extraction views feed the feature re-extraction entry points
(``python -m erc_tpu_torch.preprocess text|video``): ``text_cogmen`` and
``meld_mmgcn_text`` (dialogue → sentences), ``video_cogmen`` (the
transcript ↔ avi table of ``preprocess/video_walk.py``), ``mosei_text``
and ``mosei_interval`` (the adapted MOSEI pickle's sentence and interval
maps), and ``load_iemocap_cogmen_raw`` (the COGMEN dump's raw fields).
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


def _cogmen_rel(n_class) -> str:
    return ("cogmen/iemocap_4/IEMOCAP_features_4.pkl" if int(n_class) == 4
            else "cogmen/iemocap/IEMOCAP_features.pkl")


def load_iemocap_cogmen_raw(root, n_class=4):
    """Raw per-dialogue fields of the COGMEN dump: what the video
    re-extraction aligns against (iemocap_feature.py:157-186)."""
    (video_ids, video_speakers, video_labels, _text, _audio, _visual, video_sentence,
     train_ids, test_ids) = load_pkl(os.path.join(root, _cogmen_rel(n_class)))
    return {
        "video_ids": video_ids,
        "video_speakers": video_speakers,
        "video_labels": video_labels,
        "video_sentence": video_sentence,
        "train_ids": train_ids,
        "test_ids": test_ids,
    }


def iemocap_cogmen_6(root, split="train", text="", visual=""):
    """The 9-tuple COGMEN dump, 6 classes (iemocap_feature.py:360-408)."""
    return _iemocap_cogmen(root, _cogmen_rel(6), "cogmen/iemocap", split, text, visual)


def iemocap_cogmen_4(root, split="train", text="", visual=""):
    """The 9-tuple COGMEN dump, 4 classes."""
    return _iemocap_cogmen(root, _cogmen_rel(4), "cogmen/iemocap_4", split, text, visual)


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


# -- MOSEI ---------------------------------------------------------------


def cmumosei_7(a: float) -> int:
    """7-bin sentiment (mosei_feature.py:9-26)."""
    if a < -2:
        return 0
    if a < -1:
        return 1
    if a < 0:
        return 2
    if a == 0:
        return 3
    if a <= 1:
        return 4
    if a <= 2:
        return 5
    return 6


def cmumosei_2(a: float) -> int:
    return 0 if a < 0 else 1


def create_emotion_label(emo_label: np.ndarray) -> np.ndarray:
    """Multi-hot rows of 7; a row with no emotion gets class 6
    (mosei_feature.py:36-52)."""
    rows = []
    for j in range(emo_label.shape[0]):
        temp = np.zeros(7, dtype=int)
        pos = np.nonzero(emo_label[j])[0]
        if len(pos) == 0:
            temp[-1] = 1
        else:
            temp[pos] = 1
        rows.append(temp)
    return np.array(rows)


def mosei_adapted(root, split="train", audio=None, text=None, label_type="emo", balance=False):
    """The 13-tuple ``MOSEI.adpated.pkl`` (mosei_feature.py:129-223).
    ``label_type``: ``emo`` (argmax of the six emotions), ``multi`` (the raw
    [L, 7] rows), ``sent_2``, ``sent_2+`` (non-zero sentiment only: a video
    with none is dropped, the others keep their non-zero utterances) or
    ``sent_7``.  ``balance`` adds ``balanced_train_id.pkl`` to the train ids;
    ``text="sbert"`` reads ``sbert_map.pkl``, ``audio="fbank"``
    ``fbank480.pkl`` and ``audio="is10"`` ``MOSEI.is10.pkl``."""
    pkl = load_pkl(os.path.join(root, "MOSEI.adpated.pkl"))
    (
        train_id, test_id, valid_id, video_interval, video_emo_label,
        video_audio, video_text, video_vision, video_sentence,
        empty_vision, empty_audio, empty_text, invalid_time,
    ) = pkl

    ids = list(train_id if split == "train" else test_id if split == "test" else valid_id)
    if balance and split == "train":
        ids.extend(load_pkl(os.path.join(root, "balanced_train_id.pkl")))

    if text == "sbert":
        video_text = load_pkl(os.path.join(root, "sbert_map.pkl"))
    if audio == "fbank":
        video_audio = load_pkl(os.path.join(root, "fbank480.pkl"))
    elif audio == "is10":
        video_audio = load_pkl(os.path.join(root, "MOSEI.is10.pkl"))

    res = []
    for k in ids:
        emo = video_emo_label[k]  # [L, 7]: sentiment, then hap, sad, ang, surprise, disgust, fear
        if label_type == "emo":
            label = emo[:, 1:].argmax(axis=-1)
        elif label_type == "multi":
            label = emo
        elif label_type in ("sent_2", "sent_2+"):
            if label_type == "sent_2+" and not emo[:, 0].any():
                continue
            label = np.array([cmumosei_2(i) for i in emo[:, 0]], dtype=int)
        elif label_type == "sent_7":
            label = np.array([cmumosei_7(i) for i in emo[:, 0]], dtype=int)
        else:
            raise NotImplementedError(label_type)

        senti2 = np.array([cmumosei_2(i) for i in emo[:, 0]])
        senti7 = np.array([cmumosei_7(i) for i in emo[:, 0]])
        emo_multi = create_emotion_label(emo[:, 1:])

        visual_data, audio_data = video_vision[k], video_audio[k]
        text_data, sentence_data = video_text[k], video_sentence[k]

        if label_type == "sent_2+":
            keep = emo[:, 0] != 0
            visual_data, audio_data, text_data = visual_data[keep], audio_data[keep], text_data[keep]
            sentence_data = np.array(sentence_data)[keep].tolist()
            label, emo_multi = label[keep], emo_multi[keep]
            senti2, senti7 = senti2[keep], senti7[keep]

        res.append({
            "ids": k,
            "label": label,
            "speakers": [[0]],
            "visual": visual_data,
            "audio": audio_data,
            "text": text_data,
            "sentence": sentence_data,
            "emo_label": emo_multi,
            "senti2_label": senti2,
            "senti7_label": senti7,
        })
    return res


def mosei_cim(root, split="train", audio=None):
    """The NAACL-19 CIM npz dumps (``CIM/{text,video,audio}.npz``,
    mosei_feature.py:55-128): binary sentiment as ``label``, plus
    ``emo_label`` and ``senti7_label``.  The val split reads
    ``valid_idName`` where the dump has it, else ``train_idName`` as the
    reference does (mosei_feature.py:85).  ``audio="pad80"`` pads the audio
    features with 6 zero columns (the reference's padding, whose shape
    argument is wrong, mosei_feature.py:110)."""
    text = np.load(os.path.join(root, "CIM/text.npz"))
    video = np.load(os.path.join(root, "CIM/video.npz"))
    audio_npz = np.load(os.path.join(root, "CIM/audio.npz"))

    tag = {"train": "train", "val": "valid", "test": "test"}.get(split)
    if tag is None:
        raise NotImplementedError(f"split {split!r} in MOSEI CIM")
    lengths = text[f"{tag}_length"]
    emo_labels = text[f"{tag}EmoLabel"]
    sent_labels = text[f"{tag}SentiLabel"]
    text_features = text[f"{tag}_data"]
    video_features = video[f"{tag}_data"]
    audio_features = audio_npz[f"{tag}_data"]
    id_key = f"{tag}_idName"
    if tag == "valid" and id_key not in text:
        id_key = "train_idName"
    ids = text[id_key]

    res = []
    for i in range(len(ids)):
        length = int(lengths[i])
        senti2 = np.array([cmumosei_2(v) for v in sent_labels[i][:length, 0]])
        senti7 = np.array([cmumosei_7(v) for v in sent_labels[i][:length, 0]])
        emo = create_emotion_label(emo_labels[i][:length])
        audio_feature = audio_features[i][:length].astype(np.float32)
        if audio == "pad80":
            audio_feature = np.concatenate([audio_feature, np.zeros((audio_feature.shape[0], 6), np.float32)], -1)
        res.append({
            "ids": ids[i],
            "length": length,
            "speakers": [0],
            "visual": video_features[i][:length].astype(np.float32),
            "audio": audio_feature,
            "text": text_features[i][:length].astype(np.float32),
            "label": senti2,
            "emo_label": emo,
            "senti2_label": senti2,
            "senti7_label": senti7,
        })
    return res


def mosei_text(root, split="train"):
    """The adapted pickle's raw sentence map (mosei_feature.py:239-249)."""
    return load_pkl(os.path.join(root, "MOSEI.adpated.pkl"))[8]


def mosei_interval(root, split="train"):
    """The adapted pickle's raw interval map (mosei_feature.py:226-236)."""
    return load_pkl(os.path.join(root, "MOSEI.adpated.pkl"))[3]


# -- extraction views --------------------------------------------------------
# Resolved through the registry like the reference (datas/__init__.py:73-81);
# ``split`` is ignored: extraction covers the whole corpus.


def text_cogmen(root, split="train", n_class=4):
    """Dialogue id → sentence list of the COGMEN dump (iemocap_feature.py:133-154)."""
    return load_pkl(os.path.join(root, _cogmen_rel(n_class)))[6]


def meld_mmgcn_text(root, split="train"):
    """MELD's sentence map of the MMGCN dump (meld_feature.py:43-52)."""
    return load_pkl(os.path.join(root, "MMGCN/MELD_features_raw.pkl"))[6]


def video_cogmen(root, split="train", n_class=4, release_dir="IEMOCAP_full_release"):
    """The transcript ↔ avi table for video re-extraction
    (iemocap_feature.py:157-225; the walk is ``preprocess/video_walk.py``)."""
    from erc_tpu_torch.preprocess.video_walk import video_alignment

    raw = load_iemocap_cogmen_raw(root, n_class=int(n_class))
    return video_alignment(os.path.join(root, release_dir), raw["video_sentence"], raw["video_speakers"],
                           raw["video_labels"])
