"""DailyDialog token-level reader.

Port of ``erc_tpu.data.dailydialog`` (pure Python, copied so that the port
imports nothing of the JAX package).  It reads the public distribution
format (http://yanran.li/dailydialog):

    <root>/{train,validation,test}/dialogues_{split}.txt
        one dialogue per line, utterances separated by ``__eou__``
    <root>/{train,validation,test}/dialogues_emotion_{split}.txt
        space-separated per-utterance emotion ids
        (0 neutral, 1 anger, 2 disgust, 3 fear, 4 happiness, 5 sadness,
         6 surprise: 7 classes, hence the ``dailydialog-token-7`` name)

Files are also accepted directly under ``<root>`` (the flat layout of the
per-split zips) and under ``<root>/ijcnlp_dailydialog/<split>``.  Speakers
alternate A/B per utterance.  The vocabulary is frequency-ranked over the
train split (0 = PAD, 1 = UNK) and capped at ``vocab_size``; tokenization
is whitespace (the corpus is pre-tokenized).  A line whose utterance and
emotion counts differ, or that has no utterance, is skipped.
"""

from __future__ import annotations

import os
from collections import Counter
from functools import lru_cache
from typing import Dict, List

EMOTIONS = ("neutral", "anger", "disgust", "fear", "happiness", "sadness", "surprise")

_SPLIT_NAME = {"train": "train", "val": "validation", "validation": "validation", "test": "test"}


def _find(root: str, fname: str, split_dir: str) -> str:
    for cand in (
        os.path.join(root, split_dir, fname),
        os.path.join(root, fname),
        os.path.join(root, "ijcnlp_dailydialog", split_dir, fname),
    ):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"DailyDialog file not found: {fname} (looked under {root!r})\n"
        "Point ERC_TPU_DATA_ROOT (or .erc_tpurc.json data_root) at the "
        "extracted ijcnlp_dailydialog tree, or use synthetic-daily-token-7 "
        "to generate token dialogues in memory."
    )


def _read_split(root: str, split: str):
    """Yield (utterance_token_lists, emotion_ids) per dialogue."""
    sd = _SPLIT_NAME[split]
    text_fn = _find(root, f"dialogues_{sd}.txt", sd)
    emo_fn = _find(root, f"dialogues_emotion_{sd}.txt", sd)
    with open(text_fn, encoding="utf-8") as ft, open(emo_fn, encoding="utf-8") as fe:
        for tline, eline in zip(ft, fe):
            utts = [u.strip() for u in tline.strip().split("__eou__")]
            utts = [u for u in utts if u]
            emos = [int(x) for x in eline.split()]
            if not utts or len(utts) != len(emos):  # malformed line: skip
                continue
            yield [u.lower().split() for u in utts], emos


@lru_cache(maxsize=4)
def build_vocab(root: str, vocab_size: int = 20000) -> Dict[str, int]:
    """Frequency-ranked train-split vocabulary: {word: id}, 0 = PAD, 1 = UNK."""
    counts: Counter = Counter()
    for utts, _ in _read_split(root, "train"):
        for toks in utts:
            counts.update(toks)
    vocab = {"<pad>": 0, "<unk>": 1}
    for w, _ in counts.most_common(max(vocab_size - 2, 0)):
        vocab[w] = len(vocab)
    return vocab


def dailydialog_token(root: str, split: str = "train", vocab_size: int = 20000) -> List[dict]:
    """Sample list for the dgcnv2_daily track: one dict per dialogue with
    ``tokens`` (per-utterance id lists), alternating ``speakers``, and
    per-utterance emotion ``label``."""
    vocab = build_vocab(root, int(vocab_size))
    unk = vocab["<unk>"]
    return [
        {
            "tokens": [[vocab.get(w, unk) for w in toks] or [unk] for toks in utts],
            "speakers": [i % 2 for i in range(len(utts))],
            "label": emos,
        }
        for utts, emos in _read_split(root, split)
    ]
