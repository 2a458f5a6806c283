"""The feature re-extraction entry points, with the flags and defaults of
the JAX package's root scripts (``preprocess.py``, ``preprocess_text.py``,
``preprocess_video.py``) and ``--device`` (the card unless ``cpu``)::

    python -m erc_tpu_torch.preprocess acoustic --wav_dir=/path/wavs [--feature=fbank|mfcc|stft] \\
        [--out=acoustic_features.pkl] [--device=cpu]
    python -m erc_tpu_torch.preprocess text --dataset=iemocap-cogmen-4 --mode=sbert|robert \\
        [--model_path=/path/to/local/model] [--out=/path/out.pkl]
    python -m erc_tpu_torch.preprocess video --dataset=iemocap-cogmen-video-4 \\
        [--checkpoint=/path/tsn_r50.pth] [--backbone=tsn|x3d] [--n_segments=8] [--out=...]

``acoustic`` writes {wav name: [F, D] feature} for every ``.wav`` of at
least 400 samples, one file a call (``--fb_dim`` is read and, as in the root
script, not passed on: fbank takes 80 filters and MFCC 40).  ``text`` needs
``transformers`` and a local model; ``video`` decodes with ``cv2`` and
needs the IEMOCAP release tree and the COGMEN dump under the dataset root.
"""

from __future__ import annotations

import os
import pickle
import sys
import wave
from typing import List, Optional

import numpy as np

from erc_tpu_torch.core.params import BaseParams


def read_wav(path: str) -> np.ndarray:
    """Mono float32 in [-1, 1) from a 16-bit wav (channels averaged)."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        data = np.frombuffer(w.readframes(n), dtype=np.int16).astype(np.float32)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(-1)
    return data / 32768.0


def acoustic(argv: Optional[List[str]] = None) -> str:
    p = BaseParams()
    p.wav_dir = None
    p.feature = p.choice("fbank", "mfcc", "stft")
    p.out = "acoustic_features.pkl"
    p.fb_dim = 80
    p.device = None
    p.finalize(argv)
    assert p.get("wav_dir"), "--wav_dir required"

    from erc_tpu_torch.core.device import resolve_device
    from erc_tpu_torch.preprocess import acoustic as ac

    device = resolve_device(p.get("device"))
    fn = {"fbank": ac.wav_to_fb, "mfcc": ac.wav_to_mfcc, "stft": ac.wav_to_stft}[p.feature]
    res = {}
    for name in sorted(os.listdir(p.wav_dir)):
        if not name.endswith(".wav"):
            continue
        sig = read_wav(os.path.join(p.wav_dir, name))[None, :]
        if sig.shape[1] < 400:
            continue
        res[name[:-4]] = fn(sig, device=device)[0].cpu().numpy()
    with open(p.out, "wb") as f:
        pickle.dump(res, f)
    print(f"wrote {len(res)} features to {p.out}")
    return p.out


def text(argv: Optional[List[str]] = None) -> str:
    from erc_tpu_torch.preprocess.lexical import extract_text_features

    p = BaseParams()
    p.dataset = "iemocap-cogmen-4"
    p.mode = p.choice("sbert", "robert")
    p.model_path = None
    p.out = None
    p.device = None
    p.finalize(argv)
    path = extract_text_features(p.dataset, p.mode, p.get("model_path"), p.get("out"), device=p.get("device"))
    print(f"wrote {path}")
    return path


def video(argv: Optional[List[str]] = None) -> str:
    p = BaseParams()
    p.dataset = "iemocap-cogmen-video-4"
    p.checkpoint = None
    p.backbone = p.choice("tsn", "x3d")
    p.out = None
    p.n_segments = 8
    p.release_dir = "IEMOCAP_full_release"
    p.prefix = ""
    p.device = None
    p.finalize(argv)

    from erc_tpu_torch.data.registry import get_root, pick_datas
    from erc_tpu_torch.preprocess.video import TSNExtractor, X3DExtractor
    from erc_tpu_torch.preprocess.video_walk import extract_dialogue_features

    # the alignment table through the registry, as the reference (datas/__init__.py:78-81)
    n_class = int(p.dataset.rsplit("-", 1)[-1])
    root = get_root(p.dataset)
    clips = pick_datas(root, p.dataset, release_dir=p.release_dir)
    print(f"aligned {len(clips)} dialogue videos")

    if p.backbone == "x3d":
        cls, kw = X3DExtractor, {}
    else:
        cls, kw = TSNExtractor, {"n_segments": int(p.n_segments)}
    kw["device"] = p.get("device")
    if p.get("checkpoint"):
        ex = cls.from_torch_checkpoint(p.checkpoint, **kw)
    else:
        ex = cls(**kw)
        print("warning: no --checkpoint given — random backbone weights")

    feats = extract_dialogue_features(clips, ex.extract, log=print)

    prefix = p.get("prefix") or p.backbone
    sub = "iemocap_4" if n_class == 4 else "iemocap"
    out = p.get("out") or os.path.join(root, "cogmen", sub, f"{prefix}_vfeat.pkl")
    out_dir = os.path.dirname(out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(feats, f)
    n_ok = sum(1 for v in feats.values() if len(v))
    print(f"wrote {out}: {n_ok}/{len(feats)} dialogues extracted")
    return out


COMMANDS = {"acoustic": acoustic, "text": text, "video": video}
USAGE = "usage: python -m erc_tpu_torch.preprocess acoustic|text|video [--flag=value ...]"


def main(argv: Optional[List[str]] = None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(USAGE)
    return COMMANDS[argv[0]](argv[1:])
