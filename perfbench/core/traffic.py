"""The one traffic generator: every mix is a JSON file of parameters under
``perfbench/traffic/`` that this module reads.

Dialogues follow ``synthetic_erc``'s arithmetic (class prototypes plus
Gaussian noise, so the labels stay learnable), at the geometry a mix names.
The set of dialogue lengths is fixed by the mix alone (``length_seed``): a
run's ``--seed`` only decides which dialogue gets which length, the speakers,
labels and features, and the order of requests.  So every seed does the same
amount of work, in another order.

A ``train`` mix is a corpus that the trainer's loader iterates epoch after
epoch.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

def _rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator of (seed, stream...): any whole number of up to 64 bits."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def lengths(spec: Dict) -> np.ndarray:
    """The corpus's dialogue lengths, fixed by the mix: ``count`` draws from a
    log-normal of shape ``sigma``, scaled to the corpus's mean, clipped to
    [``min_len``, ``max_len``], the longest set to ``max_len``, then moved
    one utterance at a time until they sum to ``utterances`` exactly."""
    n, total = int(spec["count"]), int(spec["utterances"])
    lo, hi = int(spec["min_len"]), int(spec["max_len"])
    if not n * lo <= total <= n * hi or total < hi:
        raise ValueError(f"{n} dialogues of {lo}..{hi} utterances cannot hold {total}")
    rng = _rng(int(spec["length_seed"]))
    x = rng.lognormal(0.0, float(spec["sigma"]), n)
    out = np.clip(np.rint(x * total / x.sum()), lo, hi).astype(np.int64)
    out[int(np.argmax(out))] = hi
    top = int(np.argmax(out))
    order = rng.permutation(n)
    i = 0
    while out.sum() != total:
        j = int(order[i % n])
        i += 1
        if j == top:
            continue
        step = 1 if out.sum() < total else -1
        if lo <= out[j] + step <= hi:
            out[j] += step
    return out


def dialogues(spec: Dict, seed: int, stream: int = 0) -> List[dict]:
    """The dialogues of ``spec`` (a mix's ``corpus``) for ``seed``,
    as the port's batcher takes them: ``speakers`` one-hot rows, ``label``,
    and one float32 array per modality."""
    lens = lengths(spec)
    rng = _rng(seed, 1, stream)
    proto_rng = _rng(seed, 2)  # the classes' prototypes: one set a seed, shared by every stream
    dims = {k: int(v) for k, v in spec["features"].items()}
    n_classes, n_speakers, noise = int(spec["classes"]), int(spec["speakers"]), float(spec["noise"])
    protos = {m: proto_rng.normal(size=(n_classes, d)).astype(np.float32) for m, d in dims.items()}
    eye = np.eye(n_speakers, dtype=np.int64)
    out = []
    for L in lens[rng.permutation(len(lens))]:
        L = int(L)
        label = rng.integers(0, n_classes, L)
        spk = rng.integers(0, n_speakers, L)
        d = {"speakers": eye[spk].tolist(), "label": label.astype(np.int64)}
        for m, D in dims.items():
            d[m] = (protos[m][label] + noise * rng.normal(size=(L, D))).astype(np.float32)
        out.append(d)
    return out


def speaker_ids(dialogue: dict) -> np.ndarray:
    """A dialogue's speaker of each utterance, from its one-hot rows."""
    return np.asarray(dialogue["speakers"]).argmax(-1)

