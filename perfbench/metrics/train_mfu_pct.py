"""The model FLOPs of the window's steps over the window's time at the
card's float32 peak (67 TFLOP/s: the trainer runs every product in IEEE
float32), in %.  Model FLOPs are the configuration's formula
(``perfbench/work/<config>.py``) over each batch's real utterances: the
forward, and twice it for the backward; recomputation is not counted."""

from perfbench.work import peaks


def read(r):
    w = r.window
    flops = sum(3 * r.forward_flops(i) * int(n) for i, n in enumerate(w["trained"]) if n)
    return 100.0 * flops / ((w["end"] - w["start"]) * peaks.F32_FLOP_PER_S)
