"""The port's acoustic features (``erc_tpu_torch/preprocess/acoustic.py``),
VAD and the ``acoustic`` entry point, held against the JAX package on the CPU.

Tolerances: the windows, mel filterbank and DCT bit for bit; the complex
STFT 1e-5 absolute against JAX's.  Log-mel and MFCC: each package's float32
FFT lies up to ~3e-4 from a float64 evaluation of the same formula in the
bands that pre-emphasis attenuates (JAX's and torch's FFTs round
differently), so the port is held to the JAX package's own float32 error:
its largest deviation from the float64 evaluation at most 1.5 × JAX's plus
1e-5, and its distance from JAX's output at most 1e-5 plus 2.5 × JAX's
own error.  The VAD and the entry's pickle exactly (the entry's values to
the same rule as the functions).
"""

import os
import pickle
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from erc_tpu.preprocess import acoustic as jac
from erc_tpu.preprocess import vad as jvad
from erc_tpu_torch.preprocess import acoustic as tac
from erc_tpu_torch.preprocess import vad as tvad
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _signals(seed=0, n=2, T=16000):
    """B signals of 1.0 s at 16 kHz: white noise at a speech-like -20 dBFS."""
    return np.clip(np.random.default_rng(seed).normal(size=(n, T)) * 0.1, -1, 1).astype(np.float32)


def _float64_features(sig, feature, fft_size=512, fb_dim=None):
    """The JAX package's formula evaluated in float64 (numpy)."""
    fb_dim = fb_dim or (80 if feature == "fbank" else 40)
    window = jac.win_hamming(400) if feature == "fbank" else jac.win_povey(400)
    idx = np.arange((sig.shape[1] - 400) // 160 + 1)[:, None] * 160 + np.arange(400)[None, :]
    fr = sig.astype(np.float64)[:, idx]
    fr = fr - fr.mean(-1, keepdims=True)
    energy = np.log((fr * fr).sum(-1, keepdims=True) + 1e-6)
    fr = np.concatenate([fr[..., :1] * 0.03, fr[..., 1:] - 0.97 * fr[..., :-1]], -1) * window.astype(np.float64)
    st = np.fft.rfft(np.pad(fr, ((0, 0), (0, 0), (0, fft_size - 400))))[..., 1: fft_size // 2 + 1]
    fb = np.log((st.real ** 2 + st.imag ** 2 + 1e-6) @ jac.mel_filterbank(fb_dim, fft_size).astype(np.float64))
    if feature == "fbank":
        return fb
    mfcc = fb @ jac.mfcc_dct(23, fb_dim).astype(np.float64)
    return np.concatenate([energy, mfcc[..., 1:]], -1)


def _assert_within_float32_fft_error(got, want, exact):
    own = np.abs(want - exact).max()
    assert np.abs(got - exact).max() <= 1.5 * own + 1e-5, (np.abs(got - exact).max(), own)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 + 2.5 * own)


def test_constants_equal_jax():
    for args in ((80, 512, 16000, 0.0, 8000.0), (40, 512, 16000, 0.0, 8000.0), (23, 256, 8000, 100.0, 0.0)):
        np.testing.assert_array_equal(tac.mel_filterbank(*args), jac.mel_filterbank(*args))
    for args in ((23, 40), (13, 80)):
        np.testing.assert_array_equal(tac.mfcc_dct(*args), jac.mfcc_dct(*args))
    np.testing.assert_array_equal(tac.win_hamming(400), jac.win_hamming(400))
    np.testing.assert_array_equal(tac.win_povey(400), jac.win_povey(400))
    np.testing.assert_array_equal(tac.hz2mel([0.0, 700.0, 8000.0]), jac.hz2mel([0.0, 700.0, 8000.0]))


def test_framing_equals_jax():
    sig = _signals(1, T=2000)
    got = tac.frame_signal(torch.from_numpy(sig), 400, 160).numpy()
    np.testing.assert_array_equal(got, np.asarray(jac.frame_signal(sig, 400, 160)))


def test_stft_matches_jax():
    sig = _signals()
    got = tac.wav_to_stft(sig, device="cpu")
    want = np.asarray(jac.wav_to_stft(sig))
    assert got.dtype == torch.complex64 and got.shape == want.shape == (2, 98, 201)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("feature", ["fbank", "mfcc"])
def test_fbank_and_mfcc_match_jax(feature):
    sig = _signals()
    fn_t, fn_j = {"fbank": (tac.wav_to_fb, jac.wav_to_fb), "mfcc": (tac.wav_to_mfcc, jac.wav_to_mfcc)}[feature]
    got = fn_t(sig, device="cpu")
    want = np.asarray(fn_j(sig))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 98, 80 if feature == "fbank" else 23)
    _assert_within_float32_fft_error(got.numpy(), want, _float64_features(sig, feature))
    # a tensor input stays where it lies, and matches the numpy input
    torch.testing.assert_close(fn_t(torch.from_numpy(sig)), got, rtol=0, atol=0)


def test_functions_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tac.wav_to_fb(_signals())


def test_vad_equals_jax():
    rng = np.random.default_rng(3)
    sig = np.concatenate([rng.normal(size=4000) * 0.01, rng.normal(size=8000) * 0.5,
                          rng.normal(size=4000) * 0.01]).astype(np.float32)
    frames = tvad.enframe(sig, 400, 160)
    np.testing.assert_array_equal(frames, jvad.enframe(sig, 400, 160))
    np.testing.assert_array_equal(tvad.log_energy(frames), jvad.log_energy(frames))
    for kw in ({}, dict(percent_thr=0.3, nrg_thr=-0.5, context=3)):
        np.testing.assert_array_equal(tvad.energy_vad(frames, **kw), jvad.energy_vad(frames, **kw))
    vad = tvad.energy_vad(frames)
    np.testing.assert_array_equal(tvad.deframe(vad, 400, 160), jvad.deframe(vad, 400, 160))
    got = tvad.voiced_samples(sig, 16000)
    np.testing.assert_array_equal(got, jvad.voiced_samples(sig, 16000))
    assert 0 < len(got) < len(sig)


def _write_wavs(d, seconds=(1.0, 0.02, 1.5)):
    """Three 16 kHz int16 wavs (one under 400 samples, which both entries
    skip), one of them stereo, and a file that is no wav."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(5)
    for i, s in enumerate(seconds):
        ch = 2 if i == 2 else 1
        pcm = np.clip(rng.normal(size=(int(16000 * s), ch)) * 3000, -32768, 32767).astype(np.int16)
        with wave.open(os.path.join(d, f"utt{i}.wav"), "wb") as w:
            w.setnchannels(ch)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
    open(os.path.join(d, "notes.txt"), "w").close()


@pytest.mark.parametrize("feature", ["fbank", "mfcc", "stft"])
def test_acoustic_entry_equals_root_script(tmp_path, monkeypatch, feature):
    import preprocess as jentry  # the JAX package's root script

    from erc_tpu_torch.preprocess import entry

    wavs = str(tmp_path / "wavs")
    _write_wavs(wavs)
    np.testing.assert_array_equal(entry.read_wav(os.path.join(wavs, "utt2.wav")),
                                  jentry.read_wav(os.path.join(wavs, "utt2.wav")))
    want_pkl, got_pkl = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    monkeypatch.setattr(sys, "argv", ["preprocess.py", f"--wav_dir={wavs}", f"--feature={feature}",
                                      f"--out={want_pkl}"])
    jentry.main()
    entry.main(["acoustic", f"--wav_dir={wavs}", f"--feature={feature}", f"--out={got_pkl}", "--device=cpu"])
    with open(want_pkl, "rb") as f:
        want = pickle.load(f)
    with open(got_pkl, "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want) == ["utt0", "utt2"]
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if feature == "stft":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
        else:
            sig = jentry.read_wav(os.path.join(wavs, f"{k}.wav"))[None]
            _assert_within_float32_fft_error(got[k], want[k], _float64_features(sig, feature)[0])


def test_new_modules_and_acoustic_entry_load_no_jax(tmp_path):
    """Importing every module of the extraction port and running the acoustic
    entry on the CPU loads nothing of JAX, flax, optax or the JAX package."""
    wavs = str(tmp_path / "wavs")
    _write_wavs(wavs)
    code = (
        "import importlib, sys\n"
        "for m in ('data.iemocap_raw', 'data.readers', 'data.registry', 'convert', 'preprocess',\n"
        "          'preprocess.acoustic', 'preprocess.vad', 'preprocess.opensmile', 'preprocess.mosei',\n"
        "          'preprocess.lexical', 'preprocess.video', 'preprocess.x3d', 'preprocess.tsm',\n"
        "          'preprocess.video_walk', 'preprocess.entry', 'preprocess.__main__'):\n"
        "    importlib.import_module('erc_tpu_torch.' + m)\n"
        "from erc_tpu_torch.preprocess.entry import main\n"
        f"main(['acoustic', '--wav_dir={wavs}', '--out={tmp_path / 'f.pkl'}', '--device=cpu'])\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'erc_tpu',\n"
        "                                                        'transformers', 'cv2', 'h5py')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "wrote 2 features" in res.stdout
