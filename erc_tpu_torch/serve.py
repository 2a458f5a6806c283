"""Batched inference / serving engine.

Port of ``erc_tpu.serve``: build a model, optionally load a torch state
dict, and serve dialogue → per-utterance emotion predictions, either
programmatically (``InferenceEngine.predict``) or over HTTP::

    python -m erc_tpu_torch.serve --module=cogmen --graph_impl=banded
    python -m erc_tpu_torch.serve --module=dagerc --batch_size=32
    python -m erc_tpu_torch.serve --module=dgcn --graph_impl=banded
    python -m erc_tpu_torch.serve --module=mmgcn --adj_impl=dense --batch_size=32
    python -m erc_tpu_torch.serve --module=dgcnv2 --base_model=DialogRNN --batch_size=32
    python -m erc_tpu_torch.serve --module=cim --batch_size=32
    python -m erc_tpu_torch.serve --module=cogmen_mosei --dataset=synthetic-mosei-6
    python -m erc_tpu_torch.serve --module=cogmen --checkpoint=model.last.ckpt

``--checkpoint`` takes a file of either package's Saver (the port's
``model.*.ckpt``, or the JAX package's flax-msgpack file, converted on
load with no JAX installed) or a state dict from ``erc_tpu_torch.convert``.
DialogueGCN v2 serves its feature track (``--base_model=DialogRNN|LSTM|GRU|None``);
its DailyDialog token track (``dgcnv2_daily``) and the MMIN family
(``mmin_base``, ``mmin_miss``, ``mmin_miss2``) train but have no serving
path, as in the JAX package: their modules declare ``SERVED = False`` and
``from_module`` refuses them.  CIM's forward returns two heads: the engine
serves the first, ``cls2``, as the JAX engine does.

Requests are micro-batched: every chunk of up to ``batch_size`` dialogues
is padded to ``batch_size`` dialogues and a bucketed length.  The engine
runs on the card unless ``device='cpu'`` is given, and always in float32.
On the card each batch is one replay of the eval forward captured as a CUDA
graph for its (batch size, bucketed length), at most ``max_seq_len /
length_bucket`` graphs (``core.cuda_graphs.CapturedForward``, the JAX
engine's jit once per shape bucket): only the inputs the model reads are
copied, through pinned buffers, and the logits come back through one.
``cuda_graphs=False`` runs the eager forward instead, to hold the replay
against it.  On the CPU the forward is eager.
"""

from __future__ import annotations

import importlib
import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from erc_tpu_torch.core.cuda_graphs import CapturedForward, host_tensor
from erc_tpu_torch.core.device import resolve_device
from erc_tpu_torch.data.collate import ERCBatcher, bucket_length
from erc_tpu_torch.data.synthetic import synthetic_erc
from erc_tpu_torch.train.checkpoint import load_model_state


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, params, device: torch.device,
                 checkpoint_path: Optional[str] = None, batch_size: int = 8, cuda_graphs: bool = True):
        """``checkpoint_path``: see ``train.checkpoint.load_model_state``; a
        flax file is converted for ``params.module``.  ``cuda_graphs``: on
        the card, replay the captured forward (the default) or run it eagerly."""
        self.params = params
        self.device = device
        if checkpoint_path:
            model.load_state_dict(load_model_state(checkpoint_path, params.get("module")))
        self.model = model.to(device=device, dtype=torch.float32).eval()
        self.batch_size = batch_size
        self.batcher = ERCBatcher(
            modality=params.modality,
            n_classes=params.n_classes,
            n_speakers=params.n_speakers,
            speaker_onehot=bool(params.get("speaker_onehot", False)),
            bucket=params.get("length_bucket", 0),
            max_len=params.get("max_seq_len", 128),
            pad_batch_to=batch_size,
        )
        self.class_names = list(params.get("class_names", []) or [])
        self.captured: Optional[CapturedForward] = None
        if device.type == "cuda" and cuda_graphs:
            model = self.model
            self.captured = CapturedForward(
                self._forward, device, watch=lambda: [*model.parameters(), *model.buffers()])

    @classmethod
    def from_module(
        cls, module: str, checkpoint_path: Optional[str] = None,
        dataset: Optional[str] = None, batch_size: int = 8, cuda_graphs: bool = True, **param_overrides,
    ) -> "InferenceEngine":
        """Engine for ``erc_tpu_torch.models.<module>`` (``cogmen``, ``dagerc``,
        ``dgcn``, ``mmgcn``, ``dgcnv2``, ``cim``, ``cogmen_mosei``).
        Overrides set params (e.g. ``graph_impl='banded'``, ``dag_impl='eager'``,
        ``adj_impl='structured'``, ``base_model='DialogRNN'``, ``device='cpu'``); weights come from
        ``checkpoint_path`` or else from a generator seeded with ``seed``;
        ``cuda_graphs`` as in ``__init__``.
        A module that declares ``SERVED = False`` (a family that trains only)
        raises ``ValueError``."""
        mod = importlib.import_module(f"erc_tpu_torch.models.{module}")
        if not getattr(mod, "SERVED", True):
            raise ValueError(f"{module!r} trains only: it has no serving path, in either package")
        p = mod.ParamsType()
        p.module = module
        if dataset:
            p.dataset = dataset
        for k, v in param_overrides.items():
            p[k] = v
        p.iparams()
        device = resolve_device(p.device)
        generator = torch.Generator().manual_seed(int(p.seed))
        model = mod.build(p, generator=generator)
        return cls(model, p, device, checkpoint_path, batch_size, cuda_graphs)

    def _forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The model's logits; the first head's where it returns several (CIM)."""
        out = self.model(batch)
        return out[0] if isinstance(out, tuple) else out

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Every array of the batch on the device (the eager route)."""
        return {k: host_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if v is not None}

    def logits(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """float32 logits [B, L, C] of one packed batch, on the host; of the
        first head where the model returns several (CIM).  A replay of the
        batch's graph on the card, unless the engine was built with
        ``cuda_graphs=False``."""
        if self.captured is not None:
            return self.captured(batch)
        with torch.inference_mode():
            return self._forward(self._to_device(batch)).float().cpu().numpy()

    def predict(self, dialogues: List[dict]) -> List[dict]:
        """dialogues: sample dicts (text/audio/visual [L, D], speakers).

        Returns per-dialogue {'pred': [L], 'probs': [L, C], 'labels': [...]}.
        """
        results = []
        for s in range(0, len(dialogues), self.batch_size):
            chunk = dialogues[s : s + self.batch_size]
            for d in chunk:
                d.setdefault("label", np.zeros(len(d["text"]), np.int64))
            logits = self.logits(self.batcher(chunk))
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs = probs / probs.sum(-1, keepdims=True)
            for i, d in enumerate(chunk):
                ln = len(d["text"])
                pred = logits[i, :ln].argmax(-1)
                out = {"pred": pred.tolist(), "probs": probs[i, :ln].tolist()}
                if self.class_names:
                    out["labels"] = [self.class_names[int(c)] for c in pred]
                results.append(out)
        return results

    def benchmark_latency(self, n: int = 100, L: int = 48) -> Dict[str, float]:
        """Single-dialogue predict latency (ms): p50/p95/p99 over n requests
        (predict copies logits to the host, so each timing ends on the device)."""
        p = self.params
        dialogues = synthetic_erc(
            "custom", p.n_classes, "train", n_train=n, min_len=max(L - 16, 4),
            max_len=L, text_dim=p.hidden_text, audio_dim=p.hidden_audio,
            visual_dim=p.hidden_visual,
        )
        # warm up every length bucket that the timed requests reach (on the
        # card, the first batch of a bucket is captured)
        seen = {}
        for d in dialogues:
            seen.setdefault(bucket_length(len(d["text"]), self.batcher.bucket, self.batcher.max_len), d)
        for d in seen.values():
            self.predict([d])
        lat = []
        for d in dialogues:
            t0 = time.perf_counter()
            self.predict([d])
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        return {
            "p50_ms": lat[len(lat) // 2],
            "p95_ms": lat[int(len(lat) * 0.95)],
            "p99_ms": lat[min(int(len(lat) * 0.99), len(lat) - 1)],
            "mean_ms": sum(lat) / len(lat),
        }


def make_http_server(engine: InferenceEngine, host: str, port: int) -> HTTPServer:
    """An HTTP server answering POST {'dialogues': [...]} with
    {'results': [...]}; port 0 picks a free port (``server_address[1]``)."""

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                dialogues = [
                    {k: np.asarray(v, np.float32) if k in ("text", "audio", "visual") else v
                     for k, v in d.items()}
                    for d in payload["dialogues"]
                ]
                body = json.dumps({"results": engine.predict(dialogues)}).encode()
                self.send_response(200)
            except Exception as e:  # noqa: BLE001 — a bad request must not stop the server
                body = json.dumps({"error": repr(e)}).encode()
                self.send_response(400)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    return HTTPServer((host, port), Handler)


def _serve_http(engine: InferenceEngine, host: str, port: int):
    srv = make_http_server(engine, host, port)
    print(f"serving on http://{host}:{srv.server_address[1]}  (POST {{'dialogues': [...]}})")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


def main(argv: Optional[list] = None):
    from erc_tpu_torch.core.params import BaseParams

    p = BaseParams()
    p.module = "cogmen"
    p.checkpoint = None
    p.dataset = "synthetic-cogmen-6"
    p.host = "127.0.0.1"
    p.port = 8400
    p.batch_size = 8
    p.finalize(argv)
    serve_keys = ("module", "checkpoint", "dataset", "host", "port", "batch_size")
    overrides = {k: v for k, v in p.items() if k not in serve_keys}
    engine = InferenceEngine.from_module(
        p.module, p.get("checkpoint"), dataset=p.dataset, batch_size=int(p.batch_size), **overrides
    )
    _serve_http(engine, p.host, int(p.port))


if __name__ == "__main__":
    main()
