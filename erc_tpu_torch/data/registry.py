"""Dataset names → samples.

Port of the synthetic half of ``erc_tpu.data.registry``: ``synthetic-*``
names generate dialogues in memory with the geometry of the corpus they
name (``synthetic-iemocap-6`` and ``synthetic-cogmen-6``: IEMOCAP-COGMEN,
``synthetic-meld-7``: MELD-MMGCN).  The readers of the real feature dumps
come in a later slice.
"""

from __future__ import annotations

from erc_tpu_torch.data.synthetic import synthetic_erc


def n_classes_of(dataset_name: str) -> int:
    return round(float(dataset_name.split("-")[-1]))


def _synthetic_loader(name: str):
    n_cls = n_classes_of(name)
    if "daily" in name or "mmin" in name or "mosei" in name:
        raise NotImplementedError(f"synthetic dataset {name!r}: its generator is not ported yet")
    # the corpus token picks the generated dims, which must agree with the
    # params grammar's (models/base.py)
    if "meld" in name:
        prefix = "meld-mmgcn"
    elif "cogmen" in name or "iemocap" in name:
        prefix = "iemocap-cogmen"
    else:
        raise ValueError(
            f"unrecognized synthetic dataset {name!r}: use synthetic-cogmen-N, "
            "synthetic-iemocap-N or synthetic-meld-N"
        )
    return lambda root, split="train", **kw: synthetic_erc(prefix, n_cls, split)


# corpora whose readers expose a real validation split; IEMOCAP/MELD alias
# val → test, so a val stage there would select on the test set
_VAL_CORPORA = frozenset({"mosei", "mosi", "dailydialog"})
# feature sets with their own val folds regardless of corpus (MMIN h5 dumps)
_VAL_FEATURE_SETS = frozenset({"mmin"})


def dataset_has_val(dataset_name: str) -> bool:
    """Does this dataset have a real validation split?  Parsed from the name
    grammar (corpus and feature-set tokens), not a substring match."""
    toks = dataset_name.split("-")
    corpus = toks[1] if toks[0] == "synthetic" and len(toks) > 1 else toks[0]
    return corpus in _VAL_CORPORA or bool(_VAL_FEATURE_SETS.intersection(toks))


def pick_datas(root, dataset_name: str, split: str = "train", **kw):
    """Resolve a dataset name to its list of sample dicts."""
    if dataset_name.startswith("synthetic-"):
        return _synthetic_loader(dataset_name)(root, split=split, **kw)
    raise NotImplementedError(
        f"dataset {dataset_name!r}: the readers of real feature dumps are not ported yet; "
        "use a synthetic-* name"
    )
