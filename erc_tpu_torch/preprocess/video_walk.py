"""Dialogue-video walking + transcript↔avi alignment for feature
re-extraction.

Port of ``erc_tpu.preprocess.video_walk`` (host code, copied); a
re-design of reference preprocess/video/extractor.py:170-227 (the extract
loop) and mmdatasets/datas/mm/iemocap_feature.py:157-225 (``video_cogmen``
alignment).  The TSN/X3D backbones (``preprocess/video.py``, ``x3d.py``)
consume the [T, H, W, 3] clips this module produces.

Pipeline:
  1. parse every Session's dialog/transcriptions/*.txt into
     (utterance_id, t_start, t_end, sentence) per dialogue
  2. align those rows against the feature dump's per-dialogue sentence
     lists (the dumps drop some utterances; alignment advances through the
     transcript until sentences match — iemocap_feature.py:203-214)
  3. locate each dialogue's avi under dialog/avi/DivX
  4. per utterance: frames[t_start·fps : t_end·fps], crop rows 120:365 and
     the speaker's half-frame (left when ('F' in filename) == gender,
     extractor.py:196-208), run the extractor; failures yield [] for the
     dialogue (extractor.py:212-217)

Video decode uses cv2 (decord in the reference), imported in
``read_video_cv2`` alone; any callable returning ([T, H, W, 3] uint8, fps)
can be injected instead.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

# one transcript grammar for the whole port (see iemocap_raw)
from erc_tpu_torch.data.iemocap_raw import _TRANS_RE

SESSIONS = ["Session1", "Session2", "Session3", "Session4", "Session5"]


def parse_transcripts(release_root: str) -> Dict[str, List[list]]:
    """{dialogue_id: [[utt_id, t_start, t_end, sentence], ...]} in file order."""
    out: Dict[str, List[list]] = {}
    for sess in SESSIONS:
        dirfn = os.path.join(release_root, sess, "dialog/transcriptions")
        if not os.path.isdir(dirfn):
            continue
        for name in sorted(os.listdir(dirfn)):
            if not name.endswith("txt") or name.startswith("."):
                continue
            dia = name.split(".")[0]
            with open(os.path.join(dirfn, name)) as f:
                for line in f:
                    m = _TRANS_RE.findall(line)
                    if m:
                        uid, left, right, sent = m[0]
                        out.setdefault(dia, []).append(
                            [uid, float(left), float(right), sent.strip()]
                        )
    return out


def find_avis(release_root: str) -> Dict[str, str]:
    """{dialogue_id: avi path} from dialog/avi/DivX (iemocap_feature.py:188-191)."""
    avis: Dict[str, str] = {}
    for sess in SESSIONS:
        dirfn = os.path.join(release_root, sess, "dialog/avi/DivX")
        if not os.path.isdir(dirfn):
            continue
        for name in sorted(os.listdir(dirfn)):
            if name.endswith("avi") and not name.startswith("."):
                avis[name.split(".")[0]] = os.path.join(dirfn, name)
    return avis


def align_transcripts(
    transcripts: Dict[str, List[list]], video_sentence: Dict[str, List[str]]
) -> Dict[str, List[list]]:
    """Per dialogue, walk the transcript rows forward matching each feature
    dump sentence in order; rows the dump dropped are skipped
    (iemocap_feature.py:203-214).  Returns {dia: [[utt_id, t0, t1], ...]}
    with exactly one row per dump sentence."""
    aligned: Dict[str, List[list]] = {}
    for dia, sents in video_sentence.items():
        if dia not in transcripts:
            continue
        rows = iter(transcripts[dia])
        picked = []
        try:
            for target in sents:
                uid, left, right, sent = next(rows)
                while sent != target:
                    uid, left, right, sent = next(rows)
                picked.append([uid, left, right])
        except StopIteration:
            continue  # dump sentence never found — skip the dialogue
        aligned[dia] = picked
    return aligned


def video_alignment(
    release_root: str,
    video_sentence: Dict[str, List[str]],
    video_speakers: Dict[str, list],
    video_labels: Dict[str, list],
) -> Dict[str, dict]:
    """Full clip table: one entry per dialogue with timestamps, the avi
    path, speakers, sentences and labels (≡ video_cogmen's return,
    iemocap_feature.py:216-225)."""
    transcripts = parse_transcripts(release_root)
    avis = find_avis(release_root)
    aligned = align_transcripts(transcripts, video_sentence)
    clips = {}
    for dia, stamps in aligned.items():
        if dia not in avis:
            continue
        clips[dia] = {
            "timestamp": stamps,
            "speaker": video_speakers[dia],
            "fn": avis[dia],
            "video_sentence": video_sentence[dia],
            "video_labels": video_labels[dia],
        }
    return clips


def read_video_cv2(path: str):
    """Decode a whole video → ([T, H, W, 3] uint8 RGB, fps)."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames), float(fps)


def crop_speaker(frames: np.ndarray, take_left: bool) -> np.ndarray:
    """IEMOCAP split-screen crop: rows 120:365, speaker's half of the width
    (extractor.py:204-208)."""
    half = frames.shape[2] // 2
    if take_left:
        return frames[:, 120:365, :half]
    return frames[:, 120:365, half:]


def _gender_flag(g) -> bool:
    """Speaker entries may be scalars or one-hot lists; truthiness of the
    leading component reproduces the reference's ``f_left == gender`` test."""
    arr = np.asarray(g).reshape(-1)
    return bool(arr[0])


def extract_dialogue_features(
    clips: Dict[str, dict],
    extract_fn: Callable[[np.ndarray], np.ndarray],
    read_video: Callable = read_video_cv2,
    log: Optional[Callable] = None,
) -> Dict[str, np.ndarray]:
    """The reference's extraction loop (extractor.py:192-227): per
    utterance, slice the frame span, crop the speaker half, run the
    backbone; any failure records [] for the dialogue and moves on."""
    out: Dict[str, np.ndarray] = {}
    for dia, sample in clips.items():
        try:
            frames, fps = read_video(sample["fn"])
            f_left = "F" in os.path.basename(sample["fn"])
            feats = []
            for (uid, left, right), gender in zip(sample["timestamp"], sample["speaker"]):
                lf, rf = round(left * fps), round(right * fps)
                arr = crop_speaker(frames[lf:rf], take_left=(f_left == _gender_flag(gender)))
                feats.append(np.asarray(extract_fn(arr)))
            out[dia] = np.stack(feats)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # failure → empty list, keep walking (:212-217)
            if log:
                log(f"extract failed for {dia} ({sample.get('fn')}): {e!r}")
            out[dia] = []
    return out
