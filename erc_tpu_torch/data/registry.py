"""Dataset names → samples.

Port of ``erc_tpu.data.registry``: ``synthetic-*`` names generate dialogues
in memory with the geometry of the corpus they name (``synthetic-iemocap-6``
and ``synthetic-cogmen-6``: IEMOCAP-COGMEN, ``synthetic-meld-7``:
MELD-MMGCN, ``synthetic-mosei-N``: MOSEI with its multitask labels,
``synthetic-daily-token-7``: DailyDialog token dialogues, with
``vocab_size`` and ``n_train`` keywords, ``synthetic-mmin-N``: MMIN's
utterances); the ``iemocap-cogmen-*`` names read
the COGMEN feature dump, ``meld-mmgcn-7`` / ``meld-mmgcn-sbert-7`` the MMGCN
MELD dump, ``mosei-cim-2`` the CIM npz dumps, the ``mosei-*-sbert*`` names
the adapted MOSEI pickle, ``dailydialog-token-7`` the DailyDialog text and
``iemocap-mmin-4`` the MMIN2021 h5 dump (with ``h5py``)
under the dataset's root (``get_root``: ``ERC_TPU_DATA_ROOT``, else
``data_root`` in ``.erc_tpurc.json``, else ``~/erc_data``; then
``iemocap/``, ``meld/``, ``mosei/`` or ``dailydialog/``).  The raw-corpus
names (``iemocap-{audio,text,ta}-*``) walk an ``IEMOCAP_full_release`` tree
at the IEMOCAP root (``data/iemocap_raw.py``), and the extraction views
(``iemocap-cogmen-{text,video}-*``, ``meld-mmgcn-text-7``,
``mosei-{text,interval}-any-7``, in ``extraction_views``) return the maps
that the feature re-extraction reads (``python -m erc_tpu_torch.preprocess``).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, Dict, Optional

from erc_tpu_torch.core.machine import cfg_get
from erc_tpu_torch.data import dailydialog, iemocap_raw, mmin, readers
from erc_tpu_torch.data.synthetic import synthetic_daily, synthetic_erc, synthetic_mosei


def default_roots() -> Dict[str, str]:
    """Dataset roots under the data root (``ERC_TPU_DATA_ROOT`` or ``.erc_tpurc.json``)."""
    base = cfg_get("data_root", env="ERC_TPU_DATA_ROOT", default=os.path.expanduser("~/erc_data"))
    return {
        "iemocap": os.path.join(base, "iemocap"),
        "meld": os.path.join(base, "meld"),
        "mosi": os.path.join(base, "mosi"),
        "mosei": os.path.join(base, "mosei"),
        "dailydialog": os.path.join(base, "dailydialog"),
        "synthetic": base,
    }


def get_root(dataset_name: str) -> str:
    return default_roots()[dataset_name.split("-")[0]]


def _cogmen_names(n_class: int) -> Dict[str, Callable]:
    """The ``iemocap-cogmen-*-{n_class}`` names of the JAX registry."""
    fn = readers.iemocap_cogmen_6 if n_class == 6 else readers.iemocap_cogmen_4
    swaps = [("", ""), ("sbert", ""), ("robert", ""), ("", "tsn"), ("", "tsn+"), ("sbert", "tsn"),
             ("robert", "tsn"), ("sbert", "tsn+"), ("robert", "tsn+")]
    if n_class == 4:
        swaps += [("", "tsnss"), ("", "tsnss+"), ("sbert", "tsnss"), ("robert", "tsnss"), ("sbert", "tsnss+"),
                  ("robert", "tsnss+")]
    names = {}
    for text, visual in swaps:
        toks = ["iemocap", "cogmen", text, visual.replace("+", "-v+"), str(n_class)]
        names["-".join(t for t in toks if t)] = partial(fn, **{k: v for k, v in
                                                               (("text", text), ("visual", visual)) if v})
    return names


regist_data: Dict[str, Callable] = {
    # raw-corpus utterance views (reference datas/__init__.py:18-31)
    "iemocap-audio-raw-9": iemocap_raw.iemocap_audio,
    "iemocap-audio-4": iemocap_raw.iemocap_audio_subset("4"),
    "iemocap-audio-v1-4": iemocap_raw.iemocap_audio_subset("4.1"),
    "iemocap-audio-6": iemocap_raw.iemocap_audio_subset("6"),
    "iemocap-text-4": iemocap_raw.iemocap_text_subset("4"),
    "iemocap-text-v1-4": iemocap_raw.iemocap_text_subset("4.1"),
    "iemocap-text-6": iemocap_raw.iemocap_text_subset("6"),
    "iemocap-ta-4": iemocap_raw.iemocap_text_audio_subset("4"),
    "iemocap-ta-v1-4": iemocap_raw.iemocap_text_audio_subset("4.1"),
    "iemocap-ta-6": iemocap_raw.iemocap_text_audio_subset("6"),
    **_cogmen_names(6),
    **_cogmen_names(4),
    "meld-mmgcn-7": partial(readers.meld_mmgcn_7, text=None),
    "meld-mmgcn-sbert-7": partial(readers.meld_mmgcn_7, text="sbert"),
    "dailydialog-token-7": dailydialog.dailydialog_token,
    "iemocap-mmin-4": lambda root, split="train", **kw: mmin.iemocap_mmin_4(root, split),
    "mosei-cim-2": readers.mosei_cim,
    "mosei-emo-sbert-6": partial(readers.mosei_adapted, text="sbert"),
    "mosei-sent-sbert-7": partial(readers.mosei_adapted, text="sbert", label_type="sent_7"),
    "mosei-sent-sbert-2": partial(readers.mosei_adapted, text="sbert", label_type="sent_2"),
    "mosei-multi-sbert-fbank-6": partial(readers.mosei_adapted, text="sbert", audio="fbank", label_type="multi"),
    "mosei-emo-sbert-fbank-6": partial(readers.mosei_adapted, text="sbert", audio="fbank", label_type="emo"),
    "mosei-emo-sbert-fbank-blc-6": partial(readers.mosei_adapted, text="sbert", audio="fbank", label_type="emo",
                                           balance=True),
    "mosei-sent-sbert-fbank-7": partial(readers.mosei_adapted, text="sbert", audio="fbank", label_type="sent_7"),
    "mosei-sent-sbert-fbank-2": partial(readers.mosei_adapted, text="sbert", audio="fbank", label_type="sent_2"),
    "mosei-sent-sbert-fbank-+-2": partial(readers.mosei_adapted, text="sbert", audio="fbank", label_type="sent_2+"),
    "mosei-emo-sbert-is10-6": partial(readers.mosei_adapted, text="sbert", audio="is10", label_type="emo"),
    "mosei-sent-sbert-is10-7": partial(readers.mosei_adapted, text="sbert", audio="is10", label_type="sent_7"),
    "mosei-sent-sbert-is10-2": partial(readers.mosei_adapted, text="sbert", audio="is10", label_type="sent_2"),
    "mosei-sent-sbert-is10-+-2": partial(readers.mosei_adapted, text="sbert", audio="is10", label_type="sent_2+"),
}


# extraction views (reference datas/__init__.py:73-86): sentence maps for the text
# extraction, transcript ↔ avi tables for the video extraction, MOSEI's raw maps.
# They return maps, not sample lists, so they stand apart from the names above.
extraction_views: Dict[str, Callable] = {
    "iemocap-cogmen-text-4": partial(readers.text_cogmen, n_class=4),
    "iemocap-cogmen-text-6": partial(readers.text_cogmen, n_class=6),
    "meld-mmgcn-text-7": readers.meld_mmgcn_text,
    "iemocap-cogmen-video-4": partial(readers.video_cogmen, n_class=4),
    "iemocap-cogmen-video-6": partial(readers.video_cogmen, n_class=6),
    "mosei-text-any-7": readers.mosei_text,
    "mosei-interval-any-7": readers.mosei_interval,
}


def n_classes_of(dataset_name: str) -> int:
    return round(float(dataset_name.split("-")[-1]))


def _synthetic_loader(name: str):
    n_cls = n_classes_of(name)
    if "daily" in name:
        return lambda root, split="train", vocab_size=400, n_train=24, **kw: synthetic_daily(
            n_cls, split, vocab=int(vocab_size), n_train=int(n_train))
    if "mmin" in name:
        return lambda root, split="train", **kw: mmin.synthetic_mmin(n_cls, split)
    if "mosei" in name:
        return lambda root, split="train", **kw: synthetic_mosei(n_cls, split)
    # the corpus token picks the generated dims, which must agree with the
    # params grammar's (models/base.py)
    if "meld" in name:
        prefix = "meld-mmgcn"
    elif "cogmen" in name or "iemocap" in name:
        prefix = "iemocap-cogmen"
    else:
        raise ValueError(
            f"unrecognized synthetic dataset {name!r}: use synthetic-cogmen-N, "
            "synthetic-iemocap-N, synthetic-meld-N, synthetic-mosei-N, synthetic-mmin-N or synthetic-daily-token-N"
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
    """Resolve a dataset name to its list of sample dicts (an extraction
    view: to its map)."""
    if dataset_name.startswith("synthetic-"):
        return _synthetic_loader(dataset_name)(root, split=split, **kw)
    fn = regist_data.get(dataset_name) or extraction_views.get(dataset_name)
    if fn is None:
        raise ValueError(f"unknown dataset {dataset_name!r}")
    return fn(root, split=split, **kw)
