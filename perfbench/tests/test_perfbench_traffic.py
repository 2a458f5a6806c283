"""The traffic generator: deterministic from the seed, a mix's totals met,
the same work for every seed."""

import numpy as np
import pytest

from perfbench.core import manifest, traffic

MIXES = ["lognormal-120"]


def _spec(mix):
    return manifest.mix(mix)["corpus"]


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_meet_the_corpus_totals(mix):
    spec = _spec(mix)
    lens = traffic.lengths(spec)
    assert len(lens) == spec["count"]
    assert lens.sum() == spec["utterances"]
    assert lens.max() == spec["max_len"] and lens.min() >= spec["min_len"]


def test_iemocap_train_split_totals():
    lens = traffic.lengths(_spec("lognormal-120"))
    assert (len(lens), int(lens.sum()), int(lens.max())) == (120, 5810, 110)
    assert abs(lens.mean() - 48.4) < 0.05


def test_dialogues_are_deterministic_from_the_seed():
    spec = dict(_spec("lognormal-120"), count=10, utterances=300, max_len=60)
    a, b = traffic.dialogues(spec, 2**31 + 11), traffic.dialogues(spec, 2**31 + 11)
    c = traffic.dialogues(spec, 2**31 + 12)
    for x, y in zip(a, b):
        assert np.array_equal(x["text"], y["text"]) and x["speakers"] == y["speakers"]
        assert np.array_equal(x["label"], y["label"])
    assert any(not np.array_equal(x["text"], y["text"]) for x, y in zip(a, c))
    # another seed: the same lengths, in another order
    assert sorted(len(d["label"]) for d in a) == sorted(len(d["label"]) for d in c)
    d = a[0]
    assert d["audio"].shape[1] == 100 and d["text"].shape[1] == 100 and d["visual"].shape[1] == 512
    assert d["text"].dtype == np.float32

