"""MMIN's building blocks.

Port of ``erc_tpu.models.mmin_models``:

- ``TextCNN``: one ``Conv1d`` per width 3/4/5 over the words (VALID) →
  ReLU → max over the words → concatenation → dropout 0.5 → ``embd`` →
  ReLU.  The convolutions are one matrix product
  (``ops.conv.conv1d_gemm``), as in ``models.dgcnv2.CNNFeatureExtractor``.
- ``LSTMEncoder``: a one-direction LSTM over every step of the zero-padded
  sequence (no packing: the JAX module runs a mask of ones), then the
  ``maxpool``, ``last`` or ``attention`` readout.  The ``attention`` readout
  is the JAX module's: ``softmax(h @ u)`` over an axis of size 1, so every
  weight is 1 and the readout is the sum over time.
- ``Classifier``: ReLU layers with dropout after each → ``fc_out``; returns
  ``(logits, penultimate)``.
- ``ResidualAE``: blocks of encoder (Linear + LeakyReLU(0.01), the last
  layer bare) and decoder (the widths reversed, then the input width, ReLU
  between), each block's input adding the previous block's output; the
  latents concatenated; the transition ``trans1(relu(trans0(x_in + x_out)))``.
- ``MMINBaseModule`` (``encode`` and the classifier), ``MMINMissModule``
  (two ``ResidualAE`` over the fused encoding, the classifier on the
  latents) and ``MMINMiss2Module`` (twin base nets ``net`` and ``netB``).

Weights as flax initialises them: Dense and Conv lecun-normal with zero
bias, the LSTM U(±1/√H), ``attention_vector_weight`` N(0, 1).  Dropout
draws from the trainer's generator (``ops.dropout``).  The widths of the
hidden layers are the JAX modules' (128, the AE's 256/128/64 × 5 blocks);
the input widths are arguments (flax infers them).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from erc_tpu_torch.ops.attention import Linear
from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.ops.init import lecun_normal_, normal_
from erc_tpu_torch.ops.conv import conv1d_gemm
from erc_tpu_torch.ops.rnn import BiRNN

MODALITIES = (("netA", "audio_feature"), ("netV", "visual_feature"), ("netL", "text_feature"))


class TextCNN(nn.Module):
    """[B, W, D] word embeddings → [B, embd_size]; ``conv{K}.weight`` is
    [C, D, K] (flax's kernel is [K, D, C])."""

    def __init__(self, input_dim: int, embd_size: int = 128, out_channels: int = 128,
                 kernel_heights: Sequence[int] = (3, 4, 5), dropout: float = 0.5, *, generator=None, device=None):
        super().__init__()
        self.kernel_heights = tuple(kernel_heights)
        for k in self.kernel_heights:
            conv = nn.Conv1d(input_dim, out_channels, k, device=device)
            with torch.no_grad():
                lecun_normal_(conv.weight, fan_in=k * input_dim, generator=generator)
                conv.bias.zero_()
            self.add_module(f"conv{k}", conv)
        self.dropout = Dropout(dropout)
        self.embd = Linear(len(self.kernel_heights) * out_channels, embd_size, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [getattr(self, f"conv{k}") for k in self.kernel_heights]
        outs = [torch.relu(h).amax(1) for h in conv1d_gemm(x, convs)]  # each [B, W - k + 1, C] -> [B, C]
        return torch.relu(self.embd(self.dropout(torch.cat(outs, -1))))


class LSTMEncoder(nn.Module):
    """[B, T, D] → [B, H]: a one-layer, one-direction LSTM over all T steps
    and a readout."""

    def __init__(self, input_size: int, hidden_size: int, embd_method: str = "maxpool", *, generator=None,
                 device=None):
        super().__init__()
        if embd_method not in ("maxpool", "last", "attention"):
            raise ValueError(f"unknown embd_method {embd_method!r}")
        self.embd_method = embd_method
        self.rnn = BiRNN(input_size, hidden_size, num_layers=1, cell="lstm", bidirectional=False,
                         generator=generator, device=device)
        if embd_method == "attention":
            self.attention_vector_weight = nn.Parameter(torch.empty(hidden_size, 1, device=device))
            with torch.no_grad():
                normal_(self.attention_vector_weight, 1.0, generator=generator)
            self.attention_layer = Linear(hidden_size, hidden_size, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.rnn(x)
        if self.embd_method == "maxpool":
            return out.amax(1)
        if self.embd_method == "last":
            return out[:, -1]
        h = torch.tanh(self.attention_layer(out))
        w = torch.softmax(h @ self.attention_vector_weight, -1)  # over an axis of size 1, as the reference
        return (out * w).sum(1)


class Classifier(nn.Module):
    """ReLU layers of ``layers`` widths, dropout after each, then ``fc_out``."""

    def __init__(self, input_dim: int, layers: Sequence[int], output_dim: int, dropout: float = 0.3, *,
                 generator=None, device=None):
        super().__init__()
        self.n_layers = len(layers)
        d = input_dim
        for i, width in enumerate(layers):
            self.add_module(f"fc{i}", Linear(d, width, generator=generator, device=device))
            d = width
        self.fc_out = Linear(d, output_dim, generator=generator, device=device)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor):
        for i in range(self.n_layers):
            x = self.dropout(torch.relu(getattr(self, f"fc{i}")(x)))
        return self.fc_out(x), x


class ResidualAE(nn.Module):
    """``n_blocks`` encoder/decoder pairs with residual inputs; returns the
    transition's output [B, input_dim] and the latents [B, n_blocks · layers[-1]]."""

    def __init__(self, layers: Sequence[int], n_blocks: int, input_dim: int, dropout: float = 0.0, *,
                 generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.layers, self.n_blocks = tuple(layers), n_blocks
        self.dec_widths = list(self.layers)[::-1][1:] + [input_dim]
        for b in range(n_blocks):
            d = input_dim
            for i, width in enumerate(self.layers):
                self.add_module(f"enc{b}_{i}", Linear(d, width, **kw))
                d = width
            for i, width in enumerate(self.dec_widths):
                self.add_module(f"dec{b}_{i}", Linear(d, width, **kw))
                d = width
        self.trans0 = Linear(input_dim, input_dim, **kw)
        self.trans1 = Linear(input_dim, input_dim, **kw)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor):
        x_in, x_out = x, torch.zeros_like(x)
        latents = []
        for b in range(self.n_blocks):
            x_in = x_in + x_out
            h = x_in
            for i in range(len(self.layers)):
                h = getattr(self, f"enc{b}_{i}")(h)
                if i < len(self.layers) - 1:
                    h = self.dropout(F.leaky_relu(h, 0.01))
            latents.append(h)
            for i in range(len(self.dec_widths)):
                h = getattr(self, f"dec{b}_{i}")(h)
                if i < len(self.dec_widths) - 1:
                    h = self.dropout(torch.relu(h))
            x_out = h
        t = self.trans1(torch.relu(self.trans0(x_in + x_out)))
        return t, torch.cat(latents, -1)


def _encoders(module: nn.Module, audio_dim: int, visual_dim: int, text_dim: int, kw) -> None:
    module.netL = TextCNN(text_dim, 128, **kw)
    module.netA = LSTMEncoder(audio_dim, 128, "maxpool", **kw)
    module.netV = LSTMEncoder(visual_dim, 128, "maxpool", **kw)


def _encode(module: nn.Module, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[A, V, L] encodings concatenated: [B, 384]."""
    return torch.cat([getattr(module, net)(batch[key]) for net, key in MODALITIES], -1)


class MMINBaseModule(nn.Module):
    """Tri-encoder + classifier: ``(logits, fusion)``, fusion the
    classifier's penultimate feature."""

    def __init__(self, n_classes: int = 4, audio_dim: int = 130, visual_dim: int = 342, text_dim: int = 1024, *,
                 generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        _encoders(self, audio_dim, visual_dim, text_dim, kw)
        self.netC = Classifier(3 * 128, (128, 128), n_classes, dropout=0.3, **kw)

    def encode(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return _encode(self, batch)

    def forward(self, batch: Dict[str, torch.Tensor]):
        return self.netC(self.encode(batch))


class MMINMissModule(nn.Module):
    """The imagination AE over the fused encoding: ``(logits, fusion,
    fusion_cycle, features)``."""

    def __init__(self, n_classes: int = 4, audio_dim: int = 130, visual_dim: int = 342, text_dim: int = 1024,
                 ae_layers: Sequence[int] = (256, 128, 64), n_blocks: int = 5, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        _encoders(self, audio_dim, visual_dim, text_dim, kw)
        self.netAE = ResidualAE(ae_layers, n_blocks, 3 * 128, dropout=0.0, **kw)
        self.netAE_cycle = ResidualAE(ae_layers, n_blocks, 3 * 128, dropout=0.0, **kw)
        self.netC = Classifier(n_blocks * ae_layers[-1], (128, 128), n_classes, dropout=0.3, **kw)

    def forward(self, batch: Dict[str, torch.Tensor]):
        features = _encode(self, batch)
        fusion, latent = self.netAE(features)
        fusion_cycle, _ = self.netAE_cycle(features)
        logits, _ = self.netC(latent)
        return logits, fusion, fusion_cycle, features


class MMINMiss2Module(nn.Module):
    """Twin base nets: ``net`` on the Missing-masked features and, with
    ``with_reverse``, ``netB`` on the complementary ``*_reverse`` ones:
    ``(logits, fusion[, rlogits, rfeat])``."""

    def __init__(self, n_classes: int = 4, audio_dim: int = 130, visual_dim: int = 342, text_dim: int = 1024, *,
                 generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.net = MMINBaseModule(n_classes, audio_dim, visual_dim, text_dim, **kw)
        self.netB = MMINBaseModule(n_classes, audio_dim, visual_dim, text_dim, **kw)

    def forward(self, batch: Dict[str, torch.Tensor], with_reverse: bool = False):
        logits, fusion = self.net(batch)
        if not with_reverse:
            return logits, fusion
        rlogits, rfeat = self.netB({key: batch[f"{key}_reverse"] for _, key in MODALITIES})
        return logits, fusion, rlogits, rfeat
