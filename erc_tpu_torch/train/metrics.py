"""Evaluation metrics with sklearn's numbers, in numpy.

Port of ``erc_tpu.train.metrics.classification_summary``, which calls
sklearn; the port computes the same numbers from the confusion matrix
(sklearn is not a dependency of the port).  Per-class arrays run over
``labels=range(n_classes)``, so a class absent from the eval set keeps its
slot; zero divisions give 0; the weighted averages weigh by support; the
macro F1 averages over the classes that occur in the targets or the
predictions, as sklearn does without ``labels``; balanced accuracy averages
the recall of the classes that occur in the targets.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (sklearn's zero_division=0)."""
    out = np.zeros(num.shape, np.float64)
    np.divide(num, den, out=out, where=den != 0)
    return out


def classification_summary(true: Sequence[int], pred: Sequence[int], n_classes: int) -> Dict:
    true = np.asarray(true, np.int64)
    pred = np.asarray(pred, np.int64)
    inside = (true >= 0) & (true < n_classes) & (pred >= 0) & (pred < n_classes)
    cm = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(cm, (true[inside], pred[inside]), 1)
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(1).astype(np.float64)
    predicted = cm.sum(0).astype(np.float64)
    cls_pre = _divide(tp, predicted)
    cls_rec = _divide(tp, support)
    cls_f1 = _divide(2.0 * tp, support + predicted)
    occurs = (support + predicted) > 0
    weighted = lambda x: float(np.average(x[occurs], weights=support[occurs]))  # noqa: E731
    return {
        "cm": cm,
        "cls_pre": cls_pre,
        "cls_rec": cls_rec,
        "cls_f1": cls_f1,
        "acc": float(np.mean(true == pred)),
        "wa": float(np.mean(cls_rec[support > 0])),
        "pre": weighted(cls_pre),
        "rec": weighted(cls_rec),
        "f1": weighted(cls_f1),
        "mif1": float(_divide(np.array(2.0 * tp.sum()), np.array(support.sum() + predicted.sum()))),
        "maf1": float(np.mean(cls_f1[occurs])),
    }
