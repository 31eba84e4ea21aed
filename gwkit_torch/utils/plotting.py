"""Plot artifacts of the classifier CLIs (counterpart of
``gwkit/utils/plotting.py``: ``plot_roc`` and ``plot_confusion_matrix``).
Each writes a PNG and returns its path; matplotlib is imported lazily
(Agg backend), so a machine without it runs everything else."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_roc(labels, scores, out_png: str, bootstrap: bool = True) -> str:
    plt = _plt()
    from gwkit_torch.train.metrics import bootstrap_roc, roc_auc, roc_curve

    fpr, tpr, _ = roc_curve(labels, scores)
    auc = roc_auc(labels, scores)
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot(fpr, tpr, label=f"AUC = {auc:.4f}")
    if bootstrap:
        grid, _, lo, hi, _ = bootstrap_roc(labels, scores, n_resamples=200)
        ax.fill_between(grid, lo, hi, alpha=0.25, label="95% bootstrap band")
    ax.plot([0, 1], [0, 1], "k--", alpha=0.4)
    ax.set_xscale("log")
    ax.set_xlim(1e-4, 1)
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("true positive rate")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_confusion_matrix(cm: np.ndarray, class_names: Sequence[str], out_png: str) -> str:
    plt = _plt()
    cmn = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(cmn, cmap="Blues", vmin=0, vmax=1)
    ax.set_xticks(range(len(class_names)), class_names, rotation=45, ha="right")
    ax.set_yticks(range(len(class_names)), class_names)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{cm[i, j]}", ha="center", va="center",
                    color="white" if cmn[i, j] > 0.5 else "black", fontsize=8)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png
