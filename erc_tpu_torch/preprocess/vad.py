"""Unsupervised energy-based voice activity detection.

Port of ``erc_tpu.preprocess.vad`` (numpy, copied). Reference: lumo/sketch/audio/unsupervised_vad.py:43-113 +
audio_tools.py:27-53 — per-frame log-energy, mean/var normalized, then a
context-window vote picks voiced frames.  The reference computes the vote
with a python loop per frame; here it is one cumulative-sum box filter
(vectorized), bit-matching the loop's exact window semantics — including
its half-open `xnrgs[start:end]` slice paired with an inclusive
`end - start + 1` denominator (unsupervised_vad.py:96-101), which we
reproduce rather than "fix" so thresholds transfer.

Host-side preprocessing altitude (numpy): VAD runs once per wav during
dataset preparation; the heavy acoustic features (mel/fbank/MFCC) run on
the card in preprocess/acoustic.py.
"""

from __future__ import annotations

import numpy as np


def enframe(x: np.ndarray, win_len: int, hop_len: int) -> np.ndarray:
    """1-D signal → [n_frames, win_len] strided frames (audio_tools.py:27-39)."""
    x = np.squeeze(np.asarray(x))
    if x.ndim != 1:
        raise ValueError("enframe input must be 1-D")
    n_frames = 1 + (len(x) - win_len) // hop_len
    idx = np.arange(n_frames)[:, None] * hop_len + np.arange(win_len)[None, :]
    return x[idx].astype(np.float64)


def deframe(x_framed: np.ndarray, win_len: int, hop_len: int) -> np.ndarray:
    """Frame-rate values → per-sample values; overlaps resolved last-writer-
    wins like the reference's sequential writes (audio_tools.py:42-53)."""
    x_framed = np.asarray(x_framed).reshape(-1)
    n_frames = len(x_framed)
    n_samples = n_frames * hop_len + win_len
    j = np.arange(n_samples)
    i = np.minimum(j // hop_len, n_frames - 1)
    covered = j < i * hop_len + win_len
    return np.where(covered, x_framed[i], 0.0)


def log_energy(frames: np.ndarray) -> np.ndarray:
    """Mean/var-normalized per-frame log energy (unsupervised_vad.py:59-63:
    jitter +1e-5 before the energy, /win_len inside the log's scale)."""
    frames = np.asarray(frames, dtype=np.float64)
    win_len = frames.shape[1]
    nrg = np.sum((frames + 1e-5) ** 2, axis=1) / win_len
    raw = np.log(nrg) / win_len
    return (raw - raw.mean()) / np.sqrt(raw.var())


def energy_vad(
    frames: np.ndarray,
    percent_thr: float = 0.5,
    nrg_thr: float = 0.0,
    context: int = 5,
) -> np.ndarray:
    """Voiced-frame mask [n_frames] in {0.,1.} — the reference's context
    vote (unsupervised_vad.py:75-102) as one cumsum box filter."""
    frames = np.asarray(frames, dtype=np.float64)
    frames = frames - frames.mean(axis=1, keepdims=True)
    xnrgs = log_energy(frames)
    n = len(xnrgs)
    above = (xnrgs > nrg_thr).astype(np.float64)
    csum = np.concatenate([[0.0], np.cumsum(above)])
    i = np.arange(n)
    start = np.maximum(i - context, 0)
    end = np.minimum(i + context, n - 1)
    # reference counts over the half-open slice [start, end) but divides by
    # the inclusive width end-start+1 — reproduced exactly
    n_above = csum[end] - csum[start]
    n_total = (end - start + 1).astype(np.float64)
    return (n_above / n_total > percent_thr).astype(np.float64)


def voiced_samples(
    signal: np.ndarray,
    fs: int,
    percent_thr: float = 0.5,
    nrg_thr: float = 0.0,
    context: int = 5,
    win_s: float = 0.025,
    hop_s: float = 0.010,
) -> np.ndarray:
    """Strip silence from a 1-D signal (unsupervised_vad.py:105-113's
    `vad_x`): frame → vote → deframe → keep voiced samples."""
    win_len = int(fs * win_s)
    hop_len = int(fs * hop_s)
    frames = enframe(signal, win_len, hop_len)
    vad = energy_vad(frames, percent_thr, nrg_thr, context)
    mask = deframe(vad, win_len, hop_len)[: len(signal)]
    signal = np.asarray(signal)
    return signal[mask[: len(signal)].astype(bool)]
