"""A run on the CPU with the harness's look for a card skipped and the timed
path broken underneath: ``correct`` has to come out false, once for each
fault that a cell can have; and true when nothing is broken.  The control,
the reference in the precision below float32 in the program's place (TF32,
whose rounding the CPU stands in for by rounding each product's operands to
10 bits of mantissa), has to come out not correct too."""

import numpy as np
import pytest
import torch

from perfbench.core import check, harness, manifest
from perfbench.tests import tiny


def test_a_sound_run_is_correct():
    result, _ = tiny.run(tiny.TRAIN)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    result, _ = tiny.run(tiny.TRAIN)
    assert not result["correct"]
    assert result["checks"]["change_worst"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(monkeypatch):
    from erc_tpu_torch.train import trainer

    full = trainer.masked_cross_entropy

    def half(logits, labels, mask, class_weights=None):
        keep = torch.zeros_like(mask)
        keep[: mask.shape[0] // 2] = 1
        return full(logits, labels, mask * keep, class_weights)

    monkeypatch.setattr(trainer, "masked_cross_entropy", half)
    result, _ = tiny.run(tiny.TRAIN)
    assert not result["correct"]


def _control(r):
    """The run's readings replaced by the reference's with TF32 products."""
    ref = manifest.reference(r.cell["config"])
    plain = ref.plain
    w = r.extra["weights"]
    params = {n: w[n] for n in ref.param_specs(r.model)}
    batches = [plain.batch([r.data[i] for i in ids], r.model["modality"], "cpu") for ids in r.readings["batches"]]
    fwd = lambda *a, **k: ref.forward(*a, m=r.model, **k)  # noqa: E731
    got = plain.train_readings(fwd, params, {}, batches, r.cfg["train"]["optim"], plain.tf32_mm)
    r.readings.update({k: got[k] for k in ("losses", "grad_norms", "change")})
    numbers = harness.compare(r)
    limits = r.cfg["limits"][r.mix["kind"]]
    return check.verdict({k: numbers[k] for k in limits}, limits), numbers


def test_the_control_is_not_correct():
    result, r = tiny.run(tiny.TRAIN)
    assert result["correct"]
    ok, numbers = _control(r)
    assert not ok, numbers


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, 3.0])
    r = manifest.reference("dagerc-iemocap").plain.round_tf32(x)
    assert r.tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, 3.0]
    assert np.isfinite(r.numpy()).all()
