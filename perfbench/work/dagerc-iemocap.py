"""DAG-ERC's model FLOPs for one dialogue: the products and the attention
that the published model needs, over the dialogue's real utterances.
Multiply-adds count two; elementwise work and recomputation count nothing.

Per utterance: fc1 (E → D); per layer the GRU input and hidden products of
the node and proxy cells (four 3D × D), the two relation transforms Wr0, Wr1
(D × D), the query and key (D each); per predecessor edge of a layer one
weighted sum of width D; then the MLP on the concatenation of width
F = D·(layers + 1) + E.  Training counts the forward and twice it.
"""

import numpy as np


def edges(speakers: np.ndarray, windowp: int) -> int:
    """Predecessor edges of one dialogue: utterance i reaches back to, and
    including, the ``windowp``-th earlier turn of its speaker (to the first
    utterance where there are fewer)."""
    speakers = np.asarray(speakers)
    turns = {}
    total = 0
    for i, s in enumerate(speakers.tolist()):
        seen = turns.setdefault(s, [])
        first = seen[-windowp] if len(seen) >= windowp else 0
        total += i - first
        seen.append(i)
    return total


def forward_terms(speakers: np.ndarray, m: dict) -> dict:
    L = len(speakers)
    E, D, C, layers = int(m["input_width"]), int(m["hidden_dim"]), int(m["n_classes"]), int(m["gnn_layers"])
    F = D * (layers + 1) + E
    dense = 2 * L * E * D + layers * L * (28 * D * D + 4 * D) + 2 * L * (F * D + D * D + D * C)
    graph = layers * 2 * D * edges(speakers, int(m["windowp"]))
    return {"dense": dense, "graph": graph}


def forward_flops(speakers: np.ndarray, m: dict) -> int:
    t = forward_terms(speakers, m)
    return t["dense"] + t["graph"]
