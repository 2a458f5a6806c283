"""Acoustic features: STFT, log-mel filterbank and MFCC of [B, T] signals.

Port of ``erc_tpu.preprocess.acoustic`` (the reference's numpy pipeline,
preprocess/acoustic/melfeature.py:93-199): Hamming/Povey windows, 0.97
pre-emphasis after DC removal, a Kaldi-style mel filterbank (hz2mel =
1127·ln(1+f/700), triangular filters, DC bin dropped), log(|STFT|² +
1e-6)·melfilter, an MFCC DCT with Q = 22 liftering and the log energy in
place of c0.  The windows, filterbank and DCT are numpy constants (copied
from the JAX package); framing is ``Tensor.unfold``, the transform
``torch.fft.rfft``.  The functions run where ``sig`` lies (a numpy array
goes to ``device``: the card unless ``device="cpu"``) and return tensors
there; the mel and DCT products run in full float32 (``full_fp32``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from erc_tpu_torch.core.device import DeviceSpec, resolve_device
from erc_tpu_torch.preprocess import full_fp32


def win_hamming(n: int) -> np.ndarray:
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n, dtype=np.float32) / (n - 1))).astype(np.float32)


def win_povey(n: int) -> np.ndarray:
    return ((0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n, dtype=np.float32) / (n - 1))) ** 0.85).astype(np.float32)


def hz2mel(hz):
    return 1127.0 * np.log(1 + np.asarray(hz, np.float64) / 700.0)


def mel_filterbank(fb_dim=80, fft_size=512, sample_rate=16000, low_freq=0.0, high_freq=8000.0) -> np.ndarray:
    """Triangular mel filters, DC bin dropped (melfeature.py:57-73)."""
    high_freq = high_freq or sample_rate / 2
    low_mel, high_mel = hz2mel(low_freq), hz2mel(high_freq)
    filtfreq = np.linspace(low_mel, high_mel, fb_dim + 2)
    bins = hz2mel(sample_rate * np.arange(fft_size // 2 + 1) / fft_size)
    fbank = np.zeros((fft_size // 2 + 1, fb_dim), np.float32)
    for j in range(fb_dim):
        left, mid, right = filtfreq[j], filtfreq[j + 1], filtfreq[j + 2]
        up = (bins - left) / (mid - left)
        down = (right - bins) / (right - mid)
        fbank[:, j] = np.where(
            (bins >= left) & (bins <= mid), up,
            np.where((bins > mid) & (bins <= right), down, 0.0),
        )
    return fbank[1:, :]


def mfcc_dct(mfcc_dim=23, fb_dim=40) -> np.ndarray:
    """DCT matrix with Q=22 cepstral liftering folded in (melfeature.py:76-90)."""
    Q = 22.0
    n1, n2 = np.sqrt(1.0 / fb_dim), np.sqrt(2.0 / fb_dim)
    coef = np.zeros((fb_dim, mfcc_dim), np.float32)
    for i in range(mfcc_dim):
        cc = 1.0 + 0.5 * Q * np.sin(np.pi * i / Q)
        for j in range(fb_dim):
            coef[j, i] = (n1 if i == 0 else n2 * np.cos(np.pi * (j + 0.5) * i / fb_dim)) * cc
    return coef


@lru_cache(maxsize=None)
def _constant(name: str, args: tuple, device: torch.device) -> torch.Tensor:
    fn = {"hamming": win_hamming, "povey": win_povey, "mel": mel_filterbank, "dct": mfcc_dct}[name]
    return torch.from_numpy(fn(*args)).to(device)


def _signal(sig, device: DeviceSpec) -> torch.Tensor:
    """[B, T] float32 on the tensor's own device, or a numpy array moved to ``device``."""
    if isinstance(sig, torch.Tensor):
        return sig.float()
    return torch.from_numpy(np.asarray(sig, np.float32)).to(resolve_device(device))


def frame_signal(sig: torch.Tensor, frm_size: int, frm_sft: int) -> torch.Tensor:
    """[B, T] → [B, F, frm_size] frames, F = (T - frm_size) // frm_sft + 1 (melfeature.py:25-46)."""
    return sig.unfold(-1, frm_size, frm_sft)


def _preprocess_frames(frames: torch.Tensor, window: torch.Tensor, with_energy: bool):
    frames = frames - frames.mean(-1, keepdim=True)
    energy = torch.log((frames * frames).sum(-1, keepdim=True) + 1e-6) if with_energy else None
    coeff = 0.97
    frames = torch.cat([frames[..., :1] * (1 - coeff), frames[..., 1:] - coeff * frames[..., :-1]], -1)
    return frames * window, energy


def _log_mel(frames: torch.Tensor, frm_size: int, fft_size: int, fb_dim: int, low_freq: float,
             high_freq: float) -> torch.Tensor:
    frames = torch.nn.functional.pad(frames, (0, fft_size - frm_size))
    stft = torch.fft.rfft(frames)[..., 1: fft_size // 2 + 1]
    psd = stft.real ** 2 + stft.imag ** 2 + 1e-6
    mf = _constant("mel", (fb_dim, fft_size, 16000, low_freq, high_freq), frames.device)
    return torch.log(psd @ mf)


def wav_to_stft(sig, frm_size=400, frm_sft=160, fft_size=400, device: DeviceSpec = None) -> torch.Tensor:
    """Complex64 STFT [B, F, fft_size // 2 + 1] of Hamming-windowed, pre-emphasised frames."""
    x = _signal(sig, device)
    with full_fp32():
        frames = frame_signal(x, frm_size, frm_sft)
        frames, _ = _preprocess_frames(frames, _constant("hamming", (frm_size,), x.device), False)
        return torch.fft.rfft(frames, n=fft_size)


def wav_to_fb(sig, frm_size=400, frm_sft=160, fft_size=512, fb_dim=80, low_freq=0.0, high_freq=8000.0,
              device: DeviceSpec = None) -> torch.Tensor:
    """Log-mel filterbank [B, F, fb_dim] (melfeature.py:123-155)."""
    x = _signal(sig, device)
    with full_fp32():
        frames = frame_signal(x, frm_size, frm_sft)
        frames, _ = _preprocess_frames(frames, _constant("hamming", (frm_size,), x.device), False)
        return _log_mel(frames, frm_size, fft_size, fb_dim, low_freq, high_freq)


def wav_to_mfcc(sig, frm_size=400, frm_sft=160, fft_size=512, fb_dim=40, mfcc_dim=23,
                device: DeviceSpec = None) -> torch.Tensor:
    """MFCC with the log energy as c0 [B, F, mfcc_dim] (melfeature.py:158-199)."""
    x = _signal(sig, device)
    with full_fp32():
        frames = frame_signal(x, frm_size, frm_sft)
        frames, energy = _preprocess_frames(frames, _constant("povey", (frm_size,), x.device), True)
        fb = _log_mel(frames, frm_size, fft_size, fb_dim, 0.0, 8000.0)
        mfcc = fb @ _constant("dct", (mfcc_dim, fb_dim), x.device)
        return torch.cat([energy, mfcc[..., 1:]], -1)
