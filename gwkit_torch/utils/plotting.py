"""Plot artifacts (counterpart of ``gwkit/utils/plotting.py``): loss curves,
ROC with a bootstrap band, confusion matrices, efficiency against SNR and
against epoch, sensitive distance against FAR, and Q-scan spectrograms.
Each writes a PNG and returns its path; matplotlib is imported lazily
(Agg backend), so a machine without it runs everything else."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_losses(losses_txt: str, out_png: str, metrics: Optional[dict] = None) -> str:
    """Train and validation loss against epoch from ``losses.txt``;
    ``metrics`` is accepted and ignored, as gwkit does."""
    plt = _plt()
    data = np.loadtxt(losses_txt).reshape(-1, 3)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(data[:, 0], data[:, 1], label="train")
    ax.plot(data[:, 0], data[:, 2], label="validation")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


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


def plot_efficiency_curves(snrs, faps, efficiencies: np.ndarray, out_png: str) -> str:
    """TAP vs SNR, one curve per FAP (plot_efficiency_SNR.py surface)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    for j, fap in enumerate(faps):
        ax.plot(snrs, efficiencies[:, j], marker="o", label=f"FAP = {fap:g}")
    ax.set_xlabel("optimal SNR")
    ax.set_ylabel("true-alarm probability")
    ax.set_ylim(0, 1.02)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_efficiency_vs_epoch(
    epochs: Sequence[int], efficiencies: np.ndarray, snrs: Sequence[float],
    fap: float, out_png: str,
) -> str:
    """Efficiency-vs-epoch grid at one FAP (plot_efficiencies*.py surface):
    one curve per SNR across training epochs. ``efficiencies``: (n_epochs, n_snrs)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    for j, snr in enumerate(snrs):
        ax.plot(epochs, efficiencies[:, j], marker=".", label=f"SNR {snr:g}")
    ax.set_xlabel("epoch")
    ax.set_ylabel(f"true-alarm probability @ FAP {fap:g}")
    ax.set_ylim(0, 1.02)
    ax.legend(ncol=2, fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_sensitivity_vs_far(far: np.ndarray, sensitive_distance: np.ndarray, out_png: str) -> str:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    order = np.argsort(far)
    ax.semilogx(np.maximum(far[order], 1e-12) * 86400 * 30, sensitive_distance[order])
    ax.set_xlabel("false alarms per month")
    ax.set_ylabel("sensitive distance [Mpc]")
    ax.grid(alpha=0.3, which="both")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_qscan(spectrogram: np.ndarray, out_png: str, duration: float = 1.0) -> str:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(spectrogram, origin="lower", aspect="auto", cmap="viridis",
                   extent=[0, duration, 0, spectrogram.shape[0]])
    ax.set_xlabel("time [s]")
    ax.set_ylabel("frequency row")
    fig.colorbar(im, label="normalized energy")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png
