"""Raw IEMOCAP corpus walker — no feature dumps required.

Port of ``erc_tpu.data.iemocap_raw`` (host code, copied: the port imports
nothing of the JAX package), itself a re-design of the reference's
mmdatasets/datas/mm/iemocap_raw.py:1-240: walks an
``IEMOCAP_full_release``-shaped tree and yields utterance-level
(text / audio / text+audio, label) views.  ``_TRANS_RE`` is the one
transcript grammar of the port (``preprocess/video_walk.py`` reads it here).

Corpus layout parsed:
    <root>/Session{1..5}/dialog/EmoEvaluation/Categorical/*.txt
        ``Ses01F_impro01_F000 :Neutral; ()``  — one line per annotator;
        the utterance label is the majority vote over all annotators'
        category tokens (reference :46-70)
    <root>/Session{N}/dialog/transcriptions/*.txt
        ``Ses01F_impro01_F000 [6.2901-8.2357]: Excuse me.``  (:73-92)
    <root>/Session{N}/sentences/wav/<dialogue>/<utterance>.wav  (:95-106)

Split convention (reference :109-121, citing SMIN): Sessions 1-4 = train,
Session 5 = test.
"""

from __future__ import annotations

import os
import re
from collections import Counter
from typing import Dict, List, Tuple

# reference :15-42 — class-name → id maps; '4.1' folds Excited into Happiness
CLASS_MAPS = {
    "4": {"Happiness": 0, "Sadness": 1, "Neutral": 2, "Anger": 3},
    "4.1": {"Happiness": 0, "Excited": 0, "Sadness": 1, "Neutral": 2, "Anger": 3},
    "6": {
        "Happiness": 0, "Sadness": 1, "Neutral": 2, "Anger": 3,
        "Excited": 4, "Frustration": 5,
    },
}

_LABEL_RE = re.compile(r"(Ses.*\d) :(.*)\(")
_TRANS_RE = re.compile(r"(Ses\S*) \[([0-9.]+)-([0-9.]+)\]: ?(.*)")


def split_sessions(split: str) -> List[str]:
    if split == "train":
        return ["Session1", "Session2", "Session3", "Session4"]
    return ["Session5"]


def _iter_txt(dirpath: str):
    if not os.path.isdir(dirpath):
        return
    for name in sorted(os.listdir(dirpath)):
        if name.endswith("txt") and not name.startswith("."):
            with open(os.path.join(dirpath, name)) as f:
                yield from f.readlines()


def parse_label_votes(lines) -> Dict[str, str]:
    """Majority vote per utterance over annotators' category tokens."""
    votes: Dict[str, Counter] = {}
    for line in lines:
        m = _LABEL_RE.findall(line)
        if not m:
            continue
        name, label = m[0]
        tokens = [t.strip(";").strip(":") for t in label.split()]
        votes.setdefault(name, Counter()).update(t for t in tokens if t)
    return {k: v.most_common(1)[0][0] for k, v in votes.items()}


def walk_labels(root: str, sessions: List[str]) -> Dict[str, str]:
    lines = []
    for s in sessions:
        lines.extend(_iter_txt(os.path.join(root, s, "dialog/EmoEvaluation/Categorical")))
    return parse_label_votes(lines)


def walk_transcripts(root: str, sessions: List[str]) -> Dict[str, Tuple[str, float, float]]:
    """{utterance_id: (sentence, t_start, t_end)}."""
    out: Dict[str, Tuple[str, float, float]] = {}
    for s in sessions:
        for line in _iter_txt(os.path.join(root, s, "dialog/transcriptions")):
            m = _TRANS_RE.findall(line)
            if m:
                name, left, right, sent = m[0]
                out[name] = (sent.strip(), float(left), float(right))
    return out


def walk_wavs(root: str, sessions: List[str]) -> Dict[str, str]:
    """{utterance_id: wav path} from sentences/wav/** (reference :95-106)."""
    out: Dict[str, str] = {}
    for s in sessions:
        base = os.path.join(root, s, "sentences/wav")
        for dirpath, _, files in os.walk(base):
            for name in files:
                if name.endswith("wav") and not name.startswith("."):
                    out[os.path.splitext(name)[0]] = os.path.join(dirpath, name)
    return out


def walk_utterances(root: str, split: str = "train") -> List[dict]:
    """All label-bearing utterances as records — the one generic walk the
    per-view helpers (text/audio/text_audio) slice from."""
    sessions = split_sessions(split)
    labels = walk_labels(root, sessions)
    trans = walk_transcripts(root, sessions)
    wavs = walk_wavs(root, sessions)
    recs = []
    for uid in sorted(labels):
        sent = trans.get(uid)
        recs.append(
            {
                "id": uid,
                "dialogue": uid.rsplit("_", 1)[0],
                "label": labels[uid],
                "sentence": sent[0] if sent else None,
                "t_start": sent[1] if sent else None,
                "t_end": sent[2] if sent else None,
                "wav": wavs.get(uid),
            }
        )
    return recs


def iemocap_text(root: str, split: str = "train") -> Tuple[List[str], List[str]]:
    recs = [r for r in walk_utterances(root, split) if r["sentence"] is not None]
    return [r["sentence"] for r in recs], [r["label"] for r in recs]


def iemocap_audio(root: str, split: str = "train") -> Tuple[List[str], List[str]]:
    recs = [r for r in walk_utterances(root, split) if r["wav"] is not None]
    return [r["wav"] for r in recs], [r["label"] for r in recs]


def iemocap_text_audio(root: str, split: str = "train"):
    recs = [
        r for r in walk_utterances(root, split)
        if r["wav"] is not None and r["sentence"] is not None
    ]
    return (
        [r["wav"] for r in recs],
        [r["sentence"] for r in recs],
        [r["label"] for r in recs],
    )


def subset_classes(xs_ys: Tuple, n_classes: str = "4"):
    """Keep rows whose label name is in the class map; map names → ids
    (reference :193-239 subset factories)."""
    cmap = CLASS_MAPS[str(n_classes)]
    cols = list(zip(*[c for c in xs_ys]))
    kept = [row for row in cols if row[-1] in cmap]
    if not kept:
        return tuple([] for _ in xs_ys)
    out = list(zip(*kept))
    return tuple(list(c) for c in out[:-1]) + (
        [cmap[y] for y in out[-1]],
    )


def iemocap_text_subset(n_classes: str = "4"):
    return lambda root, split="train": subset_classes(iemocap_text(root, split), n_classes)


def iemocap_audio_subset(n_classes: str = "4"):
    return lambda root, split="train": subset_classes(iemocap_audio(root, split), n_classes)


def iemocap_text_audio_subset(n_classes: str = "4"):
    return lambda root, split="train": subset_classes(
        iemocap_text_audio(root, split), n_classes
    )
