"""openSMILE IS10 paralinguistic features for MOSEI audio.

Port of ``erc_tpu.preprocess.opensmile`` (host code, copied)::

    python -m erc_tpu_torch.preprocess.opensmile --wav_root=Raw/Audio/Full/WAV_16000 \
        [--adapted_pkl=MOSEI.adpated.pkl] [--smilextract=SMILExtract] [--config=IS10_paraling.conf]

A re-design of reference preprocess/acoustic/opensmile.py (a flat script) as
functions: segment the full-video wavs by the adapted dataset's utterance
intervals, run ``SMILExtract -C IS10_paraling.conf`` per segment, parse the
csv outputs (1584-dim vectors) and collect ``MOSEI.is10.pkl`` keyed by
video id — the file the ``mosei-*-is10-*`` dataset names consume
(data/readers.py mosei_adapted audio swap).

The SMILExtract binary is external; every step that needs it is gated and
injectable so the pipeline is unit-testable without openSMILE installed.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import wave
from typing import Dict

import numpy as np


def read_wav(path: str):
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        sig = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
        if w.getnchannels() > 1:
            sig = sig.reshape(-1, w.getnchannels())[:, 0]
    return rate, sig


def write_wav(path: str, rate: int, sig: np.ndarray):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(sig, np.int16).tobytes())


def segment_wavs(video_interval: Dict[str, np.ndarray], wav_root: str, out_dir: str):
    """Cut each video's wav into per-utterance segments named
    ``{key}_{i:02d}.wav`` (reference :14-23; negative t0 clamps via abs)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for key, intervals in video_interval.items():
        src = os.path.join(wav_root, f"{key}.wav")
        if not os.path.exists(src):
            continue
        rate, sig = read_wav(src)
        for i, (left, right) in enumerate(np.asarray(intervals).tolist()):
            lo, hi = abs(int(left * rate)), int(right * rate)
            out = os.path.join(out_dir, f"{key}_{i:02d}.wav")
            write_wav(out, rate, sig[lo:hi])
            written.append(out)
    return written


def run_smilextract(
    wav_path: str, csv_path: str, bin_fn: str, config_fn: str
) -> bool:
    r = subprocess.run(
        [bin_fn, "-C", config_fn, "-I", wav_path, "-csvoutput", csv_path],
        capture_output=True,
    )
    return r.returncode == 0 and os.path.exists(csv_path)


def parse_is10_csv(text: str) -> np.ndarray:
    """Last data row of an openSMILE csv → float vector (reference :40-43:
    the 'unknown' name field becomes 0, ';' separated)."""
    line = text.split("\n")[-2].replace("'unknown'", "0")
    return np.array([float(v) for v in line.split(";")], np.float32)


def collect_features(csv_dir: str) -> Dict[str, np.ndarray]:
    """{video_key: [n_utterances, D]} from ``{key}_{index}.wav.csv`` files,
    ordered by *numeric* segment index (any digit count — videos with
    ≥100 utterances outgrow the 2-digit zero padding)."""
    import re

    seg_re = re.compile(r"^(.+)_(\d+)\.wav\.csv$")
    by_key: Dict[str, list] = {}
    for name in os.listdir(csv_dir):
        m = seg_re.match(name)
        if not m:
            continue
        key, idx = m.group(1), int(m.group(2))
        with open(os.path.join(csv_dir, name)) as f:
            by_key.setdefault(key, []).append((idx, parse_is10_csv(f.read())))
    return {
        k: np.stack([vec for _, vec in sorted(v)]).astype(np.float32)
        for k, v in by_key.items()
    }


def main(argv=None):
    from erc_tpu_torch.core.params import BaseParams

    p = BaseParams()
    p.adapted_pkl = "MOSEI.adpated.pkl"
    p.wav_root = None  # Raw/Audio/Full/WAV_16000
    p.seg_dir = "mosei_wav_segments"
    p.csv_dir = "mosei_is10_csv"
    p.smilextract = "SMILExtract"
    p.config = "IS10_paraling.conf"
    p.out = "MOSEI.is10.pkl"
    p.finalize(argv)
    assert p.get("wav_root"), "--wav_root required"

    with open(p.adapted_pkl, "rb") as f:
        dataset = pickle.load(f)
    video_interval = dataset[3]

    segs = segment_wavs(video_interval, p.wav_root, p.seg_dir)
    print(f"segmented {len(segs)} utterance wavs")
    os.makedirs(p.csv_dir, exist_ok=True)
    n_ok = 0
    for wav in segs:
        csv = os.path.join(p.csv_dir, os.path.basename(wav) + ".csv")
        n_ok += run_smilextract(wav, csv, p.smilextract, p.config)
    print(f"SMILExtract ok on {n_ok}/{len(segs)}")
    feats = collect_features(p.csv_dir)
    with open(p.out, "wb") as f:
        pickle.dump(feats, f)
    print(f"wrote {p.out}: {len(feats)} videos")


if __name__ == "__main__":
    main()
