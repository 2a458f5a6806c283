"""CMU-MOSEI raw alignment: flattened seq_length_50 dumps → the dialogue-
format ``MOSEI.adpated.pkl`` the data layer consumes.

Port of ``erc_tpu.preprocess.mosei`` (host code, copied; ``h5py`` imported
in ``load_mosei_labels`` alone)::

    python -m erc_tpu_torch.preprocess.mosei --senti_pkl=mosei_senti_data.pkl \
        --labels_csd=CMU_MOSEI_Labels.csd [--transcript_root=DIR] [--out=MOSEI.adpated.pkl]

A re-design of reference preprocess/mosei.py (a flat script with the split
loop copy-pasted three times) as functions over:
  - ``mosei_senti_data.pkl``: {'train'/'test'/'valid':
        {'id': [N, 3] (key, t0, t1), 'vision'/'audio'/'text': [N, 50, D]}}
  - ``CMU_MOSEI_Labels.csd``: h5 with All Labels/data/<key>/{features,
        intervals} — per-utterance 7-dim emotion vectors
  - Raw/Transcript/Segmented/Combined/*.txt:
        ``key___idx___t0___t1___utterance``

Output list (13 fields, order fixed — consumed by
erc_tpu_torch/data/readers.py mosei_adapted):
  [train_id, test_id, valid_id, video_interval, video_emo_label,
   video_audio, video_glove, video_vision, video_sentence,
   empty_vision, empty_audio, empty_text, invalid_time]

Utterance pooling: mean over the rows of the [50, D] window that are not
all-zero; all-zero modalities fall back to row 0 (reference :60-72) and
are recorded in the empty_* diagnostics.  Utterances shorter than 0.5 s or
with negative times are recorded in invalid_time but kept (reference
:42-46 keeps them — the `continue` is commented out).
"""

from __future__ import annotations

import os
import pickle
from itertools import chain
from typing import Dict, List, Optional, Tuple

import numpy as np

SPLITS = ("train", "test", "valid")


def _pool(window: np.ndarray) -> Tuple[np.ndarray, bool]:
    """Mean of non-zero rows; (row 0, True) when the window is all-zero."""
    any_rows = window.any(axis=1)
    if any_rows.any():
        return window[any_rows].mean(axis=0), False
    return window[0], True


def _sorted_ids(align: dict, split: str) -> List[list]:
    ids = [list(v) for v in np.asarray(align[split]["id"]).tolist()]
    return sorted(ids, key=lambda x: (x[0], float(x[1]), float(x[2])))


def adapt_mosei(
    align: dict,
    label_map: Dict[Tuple[str, float, float], np.ndarray],
    transcript_map: Optional[Dict[Tuple[str, float, float], str]] = None,
) -> list:
    """Regroup flattened utterances into per-video dialogue arrays."""
    video_audio: Dict[str, list] = {}
    video_glove: Dict[str, list] = {}
    video_vision: Dict[str, list] = {}
    video_interval: Dict[str, list] = {}
    video_emo_label: Dict[str, list] = {}
    video_sentence: Dict[str, list] = {}
    empty_vision, empty_audio, empty_text, invalid_time = [], [], [], []

    split_ids = {}
    all_sorted = []
    for split in SPLITS:
        sorted_ids = _sorted_ids(align, split)
        split_ids[split] = sorted({key for key, _, _ in sorted_ids})
        index = {
            tuple(v): i for i, v in enumerate(np.asarray(align[split]["id"]).tolist())
        }
        for key, left_s, right_s in sorted_ids:
            i = index[(key, left_s, right_s)]
            left, right = float(left_s), float(right_s)
            if right - left < 0.5 or left < 0 or right < 0:
                invalid_time.append([key, left, right])  # recorded, not dropped

            vision, v_empty = _pool(np.asarray(align[split]["vision"][i]))
            audio, a_empty = _pool(np.asarray(align[split]["audio"][i]))
            text_win = np.asarray(align[split]["text"][i])
            if not text_win.any():
                empty_text.append([key, left, right])
            # all-zero text pools to a NaN row, exactly as the reference's
            # unconditional mean does (:72) — recorded in empty_text above
            text = text_win[text_win.any(axis=1)].mean(axis=0) if text_win.any() else text_win[0] * np.nan
            if v_empty:
                empty_vision.append([key, left, right])
            if a_empty:
                empty_audio.append([key, left, right])

            video_vision.setdefault(key, []).append(vision)
            video_audio.setdefault(key, []).append(audio)
            video_glove.setdefault(key, []).append(text)
            video_interval.setdefault(key, []).append((left, right))
            video_emo_label.setdefault(key, []).append(label_map[(key, left, right)])
            if transcript_map is not None:
                video_sentence.setdefault(key, []).append(
                    transcript_map[(key, left, right)]
                )
        all_sorted.extend(sorted_ids)

    for k in chain(*split_ids.values()):
        for res in (video_interval, video_emo_label, video_audio, video_glove, video_vision):
            res[k] = np.asarray(res[k], np.float32)

    if transcript_map is None:
        video_sentence = video_audio  # reference :204-206 fallback

    return [
        list(split_ids["train"]), list(split_ids["test"]), list(split_ids["valid"]),
        video_interval, video_emo_label, video_audio, video_glove, video_vision,
        video_sentence, empty_vision, empty_audio, empty_text, invalid_time,
    ]


def load_mosei_labels(csd_path: str) -> Dict[Tuple[str, float, float], np.ndarray]:
    """CMU_MOSEI_Labels.csd → {(key, t0, t1): 7-dim label vector}."""
    import h5py

    out = {}
    with h5py.File(csd_path, "r") as f:
        data = f["All Labels"]["data"]
        for key in data.keys():
            feats = data[key]["features"][()]
            intervals = data[key]["intervals"][()].tolist()
            for i, (left, right) in enumerate(intervals):
                out[(key, float(left), float(right))] = feats[i]
    return out


def load_transcripts(transcript_root: str) -> Dict[Tuple[str, float, float], str]:
    """Raw/Transcript/Segmented/Combined → {(key, t0, t1): utterance}."""
    out = {}
    for name in sorted(os.listdir(transcript_root)):
        if not name.endswith("txt"):
            continue
        with open(os.path.join(transcript_root, name)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key, _idx, left, right, uttr = line.split("___", maxsplit=4)
                out[(key, float(left), float(right))] = uttr
    return out


def main(argv=None):
    from erc_tpu_torch.core.params import BaseParams

    p = BaseParams()
    p.senti_pkl = "mosei_senti_data.pkl"
    p.labels_csd = "CMU_MOSEI_Labels.csd"
    p.transcript_root = None  # Raw/Transcript/Segmented/Combined
    p.out = "MOSEI.adpated.pkl"
    p.finalize(argv)

    with open(p.senti_pkl, "rb") as f:
        align = pickle.load(f)
    labels = load_mosei_labels(p.labels_csd)
    transcripts = (
        load_transcripts(p.transcript_root) if p.get("transcript_root") else None
    )
    dataset = adapt_mosei(align, labels, transcripts)
    with open(p.out, "wb") as f:
        pickle.dump(dataset, f)
    print(f"wrote {p.out}: {len(dataset[0])} train / {len(dataset[1])} test / "
          f"{len(dataset[2])} valid videos")


if __name__ == "__main__":
    main()
