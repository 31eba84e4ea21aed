"""Classification metrics (numpy, CPU) — evaluation oracles (a copy of
``gwkit/train/metrics.py``).

Covers the reference's metric surface: ROC/AUC with bootstrap bands
(Signal_vs_Noise/src/evaluation.py:105-170), F1, accuracy, confusion matrix
and per-class report (Glitch_classification/src/train.py:122-129).
Implemented directly (no sklearn dependency on the serving path).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def roc_curve(labels: np.ndarray, scores: np.ndarray):
    """Returns (fpr, tpr, thresholds) sorted by descending threshold."""
    labels = np.asarray(labels).astype(bool).ravel()
    scores = np.asarray(scores).ravel()
    order = np.argsort(-scores)
    labels = labels[order]
    scores = scores[order]
    distinct = np.where(np.diff(scores))[0]
    idx = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels)[idx]
    fps = 1 + idx - tps
    n_pos = labels.sum()
    n_neg = labels.size - n_pos
    tpr = np.r_[0.0, tps / max(n_pos, 1)]
    fpr = np.r_[0.0, fps / max(n_neg, 1)]
    thresholds = np.r_[np.inf, scores[idx]]
    return fpr, tpr, thresholds


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(labels, scores)
    return float(np.trapezoid(tpr, fpr))


def bootstrap_roc(
    labels: np.ndarray,
    scores: np.ndarray,
    n_resamples: int = 1000,
    fpr_grid: np.ndarray | None = None,
    seed: int = 0,
):
    """Bootstrap ROC bands on a log-spaced FPR grid
    (Signal_vs_Noise/src/evaluation.py:110-122 semantics).

    Returns (fpr_grid, tpr_mean, tpr_lo, tpr_hi, auc_samples).
    """
    labels = np.asarray(labels).ravel()
    scores = np.asarray(scores).ravel()
    if fpr_grid is None:
        fpr_grid = np.logspace(-4, 0, 100)
    rng = np.random.default_rng(seed)
    n = labels.size
    tprs, aucs = [], []
    for _ in range(n_resamples):
        idx = rng.integers(0, n, n)
        if labels[idx].min() == labels[idx].max():
            continue  # resample lost one class
        fpr, tpr, _ = roc_curve(labels[idx], scores[idx])
        tprs.append(np.interp(fpr_grid, fpr, tpr))
        aucs.append(np.trapezoid(tpr, fpr))
    tprs = np.stack(tprs)
    return (
        fpr_grid,
        tprs.mean(axis=0),
        np.percentile(tprs, 2.5, axis=0),
        np.percentile(tprs, 97.5, axis=0),
        np.asarray(aucs),
    )


def confusion_matrix(labels: np.ndarray, preds: np.ndarray, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(labels).ravel(), np.asarray(preds).ravel()), 1)
    return cm


def f1_scores(cm: np.ndarray) -> Dict[str, np.ndarray | float]:
    """Per-class precision/recall/F1 + macro/weighted averages from a confusion matrix."""
    tp = np.diag(cm).astype(float)
    support = cm.sum(axis=1).astype(float)
    pred_pos = cm.sum(axis=0).astype(float)
    precision = np.divide(tp, pred_pos, out=np.zeros_like(tp), where=pred_pos > 0)
    recall = np.divide(tp, support, out=np.zeros_like(tp), where=support > 0)
    denom = precision + recall
    f1 = np.divide(2 * precision * recall, denom, out=np.zeros_like(tp), where=denom > 0)
    total = support.sum()
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "support": support.astype(int),
        "accuracy": float(tp.sum() / max(total, 1)),
        "macro_f1": float(f1.mean()),
        "weighted_f1": float((f1 * support).sum() / max(total, 1)),
    }


def binary_f1(labels: np.ndarray, preds: np.ndarray) -> float:
    cm = confusion_matrix(np.asarray(labels).astype(int), np.asarray(preds).astype(int), 2)
    return float(f1_scores(cm)["f1"][1])


def classification_report(labels, preds, class_names: Sequence[str]) -> str:
    """Text report in the sklearn layout the reference checks in
    (Glitch_classification/results/.../multi_class_model_test_classification_report.txt)."""
    cm = confusion_matrix(labels, preds, len(class_names))
    stats = f1_scores(cm)
    lines = [f"{'':<22}{'precision':>10}{'recall':>10}{'f1-score':>10}{'support':>10}", ""]
    for i, name in enumerate(class_names):
        lines.append(
            f"{name:<22}{stats['precision'][i]:>10.2f}{stats['recall'][i]:>10.2f}"
            f"{stats['f1'][i]:>10.2f}{stats['support'][i]:>10d}"
        )
    total = int(stats["support"].sum())
    lines.append("")
    lines.append(f"{'accuracy':<22}{'':>20}{stats['accuracy']:>10.2f}{total:>10d}")
    lines.append(
        f"{'macro avg':<22}{stats['precision'].mean():>10.2f}{stats['recall'].mean():>10.2f}"
        f"{stats['macro_f1']:>10.2f}{total:>10d}"
    )
    w = stats["support"] / max(total, 1)
    lines.append(
        f"{'weighted avg':<22}{(stats['precision']*w).sum():>10.2f}{(stats['recall']*w).sum():>10.2f}"
        f"{stats['weighted_f1']:>10.2f}{total:>10d}"
    )
    return "\n".join(lines)
