"""Feature extraction: the port of ``erc_tpu.preprocess`` and of the root
scripts ``preprocess.py``, ``preprocess_text.py`` and ``preprocess_video.py``.

- ``acoustic``: STFT, log-mel filterbank and MFCC of a batch of signals;
- ``lexical``: sentence embeddings from a transformer encoder (sBERT mean
  pooling, or RoBERTa's pooler output);
- ``video``: the TSN ResNet-50 (with the TSM shift when ``n_segment > 0``),
  ``tsm``: the TSN/TSM head over it, ``x3d``: the X3D backbone; NCHW and
  NCDHW, with torchvision/mmaction module names, so an mmaction
  ``state_dict`` loads by stripping its ``backbone.`` prefix;
- ``video_walk``: the IEMOCAP release walk and per-utterance extraction
  loop; ``vad``, ``mosei`` and ``opensmile``: host code (numpy, h5py, the
  ``SMILExtract`` binary).

The extractors run on the card unless given ``device="cpu"``
(``core/device.py``), and their device work runs inside ``full_fp32()``.
Entry points: ``python -m erc_tpu_torch.preprocess acoustic|text|video``
(``entry.py``), ``python -m erc_tpu_torch.preprocess.mosei`` and
``python -m erc_tpu_torch.preprocess.opensmile``.  ``transformers``,
``cv2`` and ``h5py`` are imported inside the functions that need them.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from erc_tpu_torch.core import precision
from erc_tpu_torch.ops.rnn import cudnn_full_fp32


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """cuBLAS's float32 products and cuDNN's float32 convolutions in full
    float32 (TF32 would move a ResNet-50's features and the log-mel products
    by ~1e-3 relative), and ``cudnn.benchmark`` off, within the block; the
    previous settings after.  Scoped to the extractor's call, never set for
    the process."""
    cudnn = torch.backends.cudnn
    prev = cudnn.benchmark
    cudnn.benchmark = False
    try:
        with precision.scoped("ieee"), cudnn_full_fp32(cudnn.conv):
            yield
    finally:
        cudnn.benchmark = prev
