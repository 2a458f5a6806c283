"""Text features on the card (reference: preprocess/lexical/extractor.py:52-93).

Port of ``erc_tpu.preprocess.lexical``: sBERT
(``paraphrase-distilroberta-base-v1``, mean-pooled) or RoBERTa-large
(pooler output) utterance embeddings → ``{sbert|robert}_map.pkl`` keyed by
dialogue id.  ``TextEncoder`` takes any torch module with the Hugging Face
call convention (``model(input_ids=..., attention_mask=...)`` returning
``.last_hidden_state`` and, optionally, ``.pooler_output``) and a tokenizer
with ``transformers``' call convention.  Batches keep the JAX package's
static shape: the tokenizer pads every sentence to ``max_tokens`` and the
last batch is padded to ``batch_size`` rows, which are dropped after.

``from_pretrained`` reads a local model directory with ``transformers``'
``AutoModel``/``AutoTokenizer`` (imported there alone; nothing is
downloaded when ``path`` is a directory).
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from erc_tpu_torch.core.device import DeviceSpec, resolve_device
from erc_tpu_torch.preprocess import full_fp32


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Sentence-transformers mean pooling over valid tokens."""
    m = attention_mask[..., None].to(hidden.dtype)
    return (hidden * m).sum(1) / m.sum(1).clamp_min(1e-9)


class TextEncoder:
    def __init__(self, model=None, tokenizer=None, mode: str = "sbert", max_tokens: int = 64, batch_size: int = 64,
                 device: DeviceSpec = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval() if model is not None else None
        self.tokenizer = tokenizer
        self.mode = mode
        self.max_tokens = max_tokens
        self.batch_size = batch_size

    @classmethod
    def from_pretrained(cls, path: str, mode: str = "sbert", **kw) -> "TextEncoder":
        try:
            from transformers import AutoModel, AutoTokenizer
        except ImportError as e:
            raise ImportError(f"TextEncoder.from_pretrained({path!r}) needs the `transformers` package, which is "
                              "not installed; pass a model and a tokenizer to TextEncoder instead") from e
        return cls(AutoModel.from_pretrained(path), AutoTokenizer.from_pretrained(path), mode, **kw)

    def _embed(self, ids: np.ndarray, am: np.ndarray) -> np.ndarray:
        ids = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        am = torch.from_numpy(np.asarray(am, np.int64)).to(self.device)
        with torch.inference_mode(), full_fp32():
            out = self.model(input_ids=ids, attention_mask=am)
            if self.mode == "robert" and getattr(out, "pooler_output", None) is not None:
                emb = out.pooler_output
            else:
                emb = mean_pool(out.last_hidden_state, am)
            return emb.float().cpu().numpy()

    def encode(self, sentences: List[str]) -> np.ndarray:
        enc = self.tokenizer(sentences, padding="max_length", truncation=True, max_length=self.max_tokens,
                             return_tensors="np")
        outs = []
        bs = self.batch_size
        n = len(sentences)
        for i in range(0, n, bs):
            ids = enc["input_ids"][i: i + bs]
            am = enc["attention_mask"][i: i + bs]
            pad = bs - len(ids)  # static batch shape
            if pad:
                ids = np.pad(ids, ((0, pad), (0, 0)))
                am = np.pad(am, ((0, pad), (0, 0)))
            outs.append(self._embed(ids, am)[: min(bs, n - i)])
        return np.concatenate(outs, 0)

    def encode_dialogues(self, video_sentence: Dict[str, List[str]]) -> Dict[str, np.ndarray]:
        """Per-dialogue embedding map (extractor.py:64-77 semantics)."""
        return {k: self.encode(v) for k, v in video_sentence.items()}


def extract_text_features(dataset_name: str, mode: str = "sbert", model_path: Optional[str] = None,
                          out_path: Optional[str] = None, device: DeviceSpec = None) -> str:
    """The CLI flow (extractor.py:52-93): dataset → sentences → map pkl.

    Extraction-view names (iemocap-cogmen-text-4/6, meld-mmgcn-text-7,
    mosei-text-any-7 — reference datas/__init__.py:73-81) resolve straight
    to a {dialogue: sentences} map; training names fall back to collecting
    sentences from their sample lists."""
    from erc_tpu_torch.data.registry import get_root, pick_datas

    root = get_root(dataset_name)
    if "-text-" in dataset_name:
        video_sentence = pick_datas(root, dataset_name)
    else:
        samples = pick_datas(root, dataset_name, split="train") + pick_datas(root, dataset_name, split="test")
        video_sentence = {s.get("ids", i): s["sentence"] for i, s in enumerate(samples) if s.get("sentence")}
    default_model = ("sentence-transformers/paraphrase-distilroberta-base-v1" if mode == "sbert"
                     else "roberta-large")
    enc = TextEncoder.from_pretrained(model_path or default_model, mode, device=device)
    res = enc.encode_dialogues(video_sentence)
    out_path = out_path or f"{root}/{mode}_map.pkl"
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    return out_path
