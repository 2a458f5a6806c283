"""Evaluation metrics with sklearn's numbers, in numpy.

Port of ``erc_tpu.train.metrics``: ``classification_summary`` and
``mosei_multilabel_summary`` call sklearn there; the port computes the same
numbers from the confusion matrix (sklearn is not a dependency of the
port), and ``weighted_accuracy`` is the reference's MOSEI formula.  Per-class arrays run over
``labels=range(n_classes)``, so a class absent from the eval set keeps its
slot; zero divisions give 0; the weighted averages weigh by support; the
macro F1 averages over the classes that occur in the targets or the
predictions, as sklearn does without ``labels``; balanced accuracy averages
the recall of the classes that occur in the targets.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

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


def weighted_accuracy(y_true: Sequence[int], y_pred: Sequence[int]) -> Tuple:
    """Binary weighted accuracy (the reference's mmbase.py:231-251):
    (TP · N / P + TN) / 2N, with TP, TN, FP, FN, P and N after it; 0 where
    the ground truth has a single class (the formula would divide by 0)."""
    t = np.asarray(y_true)
    hit = t == np.asarray(y_pred)
    pos, zero = t == 1, t == 0
    TP, TN = int((pos & hit).sum()), int((zero & hit).sum())
    FN, FP = int((pos & ~hit).sum()), int((zero & ~hit).sum())
    P = int(pos.sum())
    N = t.size - P  # every label that is not 1, as the reference counts it
    if P == 0 or N == 0:
        return 0.0, TP, TN, FP, FN, P, N
    return (1.0 * TP * (N / (1.0 * P)) + TN) / (2.0 * N), TP, TN, FP, FN, P, N


def _weighted_f1(true: np.ndarray, pred: np.ndarray) -> float:
    """sklearn's ``precision_recall_fscore_support(average="weighted",
    zero_division=0)[2]`` over the labels that occur in either array."""
    labels = np.union1d(true, pred)
    f1, support = [], []
    for c in labels:
        tp = float(((true == c) & (pred == c)).sum())
        n_true, n_pred = float((true == c).sum()), float((pred == c).sum())
        f1.append(2.0 * tp / (n_true + n_pred) if n_true + n_pred else 0.0)
        support.append(n_true)
    total = sum(support)
    return float(np.dot(f1, support) / total) if total else 0.0


def mosei_multilabel_summary(true_multi: np.ndarray, pred_multi: np.ndarray, thresh: float = 0.5) -> Dict:
    """Per emotion column of 7: accuracy, weighted F1 and weighted accuracy of
    ``pred > thresh`` against the multi-hot truth (mmbase.py:277-296); and
    their means."""
    true_multi, pred_multi = np.asarray(true_multi), np.asarray(pred_multi)
    accs, f1s, waccs = [], [], []
    for i in range(7):
        true = true_multi[:, i]
        column = (pred_multi[:, i] > thresh).astype(int)
        accs.append(float(np.mean(true == column)))
        f1s.append(_weighted_f1(true, column))
        waccs.append(weighted_accuracy(true, column)[0])
    return {
        "cls_acc": accs,
        "cls_f1": f1s,
        "cls_wa": waccs,
        "emo_acc": float(np.mean(accs)),
        "emo_f1": float(np.mean(f1s)),
        "emo_wa": float(np.mean(waccs)),
    }
