"""Classifier evaluation CLI on the port (counterpart of
``gwkit/cli/evaluate_classifier.py``). Two modes (``--task``):

* ``signal`` (default): an InjectionDataset file, each ``--snrs`` value in
  turn -> per-SNR ROC AUC with a bootstrap band, F1 at 0.5,
  ``evaluation.txt`` and ``roc_snr*.png`` (the PNGs only where matplotlib
  is installed; otherwise one logged line says they were skipped);
* ``glitch``: a flat ``strain``/``labels`` corpus, the multi-class head ->
  accuracy, ``evaluation.txt`` with the per-class report, and
  ``confusion_matrix.txt``, on the leading ``--valid-fraction`` that the
  glitch trainer held out (0: the whole file).

    python -m gwkit_torch.cli.evaluate_classifier -d test.hdf --checkpoint OUT/best.npz \\
        -o EVALDIR [--task glitch] [--n-frames 3000] [--pretrained-encoder encoder.npz]

The checkpoint is a trainer's ``best.npz`` (either package's). On the CUDA
card the encoder runs in bf16 on the hand-written kernels; ``--cpu`` runs
f32 and plain PyTorch.
"""
from __future__ import annotations

import importlib.util
import logging
import os
from argparse import ArgumentParser

import numpy as np

from gwkit_torch.cli.common import (add_adapter_args, add_common_args, configure_logging, dump_config, load_task,
                                    parse_with_config)


def parse_args(argv=None):
    p = ArgumentParser(description="Evaluate a trained signal-vs-noise classifier (ROC/AUC/F1 + bootstrap).")
    add_common_args(p)
    add_adapter_args(p)
    p.add_argument("-d", "--dataset", type=str, required=True,
                   help="HDF5 InjectionDataset file with a 'validation' (or 'training') "
                        "group (signal task), or flat 'strain'/'labels' (glitch task).")
    p.add_argument("--checkpoint", type=str, required=True, help="Trainable checkpoint (.npz; e.g. best.npz).")
    p.add_argument("-o", "--output-dir", type=str, required=True)
    p.add_argument("--task", choices=("signal", "glitch"), default="signal",
                   help="signal: per-SNR ROC on an InjectionDataset; glitch: "
                        "confusion matrix + per-class report on a labeled corpus.")
    p.add_argument("--num-classes", type=int, default=11, help="Glitch classes (glitch task).")
    p.add_argument("--valid-fraction", type=float, default=0.1,
                   help="Glitch task: evaluate the leading fraction the glitch trainer "
                        "held out (0 = the whole file).")
    p.add_argument("--snrs", type=float, nargs="+", default=[6, 8, 10, 12, 15, 20],
                   help="Fixed SNRs to evaluate at.")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--bootstrap", type=int, default=1000, help="Bootstrap resamples for ROC bands.")
    p.add_argument("--n-frames", type=int, default=3000)
    p.add_argument("--input-sample-rate", type=int, default=2048)
    return parse_with_config(p, argv)


def main(argv=None):
    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    dump_config(args, args.output_dir)
    import h5py
    import torch

    from gwkit_torch.data.datasets import InjectionDataset
    from gwkit_torch.device import resolve_device
    from gwkit_torch.train.metrics import binary_f1, bootstrap_roc, roc_auc
    from gwkit_torch.train.tasks import build_signal_vs_noise

    device = resolve_device("cpu" if args.cpu else None)
    if args.task == "glitch":
        return _evaluate_glitch(args, device)

    with h5py.File(args.dataset, "r") as f:
        group = "validation" if "validation" in f else "training"
        ds = InjectionDataset.load(f, group, device=device)
    task = load_task(args, build_signal_vs_noise, device, args.checkpoint)
    plots = importlib.util.find_spec("matplotlib") is not None
    if not plots:
        logging.warning("matplotlib is not installed: the roc_snr*.png plots are skipped")

    os.makedirs(args.output_dir, exist_ok=True)
    report_lines = []
    for snr in args.snrs:
        ds.snrs((snr, snr))
        scores, labels = [], []
        gen = torch.Generator().manual_seed(args.seed)
        for x, y, _ in ds.batches(gen, args.batch_size, shuffle=False, drop_remainder=False):
            scores.append(torch.sigmoid(task.forward(x).reshape(-1)).cpu().numpy())
            labels.append(y[:, 0].cpu().numpy())
        scores = np.concatenate(scores)
        labels = np.concatenate(labels)
        auc = roc_auc(labels, scores)
        f1 = binary_f1(labels, scores > 0.5)
        _, _, _, _, auc_samples = bootstrap_roc(labels, scores, n_resamples=args.bootstrap)
        lo, hi = np.percentile(auc_samples, [2.5, 97.5])
        line = f"SNR {snr:g}: AUC {auc:.4f} [{lo:.4f}, {hi:.4f}] F1 {f1:.4f}"
        print(line)
        report_lines.append(line)
        if plots:
            from gwkit_torch.utils.plotting import plot_roc

            plot_roc(labels, scores, os.path.join(args.output_dir, f"roc_snr{snr:g}.png"))
    with open(os.path.join(args.output_dir, "evaluation.txt"), "w") as f:
        f.write("\n".join(report_lines) + "\n")


def _evaluate_glitch(args, device):
    """Accuracy, the confusion matrix and the per-class report on the
    held-out split of a 'strain'/'labels' corpus."""
    import h5py
    import torch

    from gwkit_torch.data.glitch import GLITCH_CLASSES
    from gwkit_torch.train.metrics import classification_report, confusion_matrix
    from gwkit_torch.train.tasks import build_glitch

    with h5py.File(args.dataset, "r") as f:
        strain, labels = f["strain"][()], f["labels"][()]
    n_valid = int(len(labels) * args.valid_fraction)
    if n_valid:
        strain, labels = strain[:n_valid], labels[:n_valid]
    task = load_task(args, build_glitch, device, args.checkpoint, num_classes=args.num_classes)
    preds = np.concatenate([
        task.forward(torch.from_numpy(np.asarray(strain[i:i + args.batch_size], np.float32)).to(device))
        .argmax(dim=-1).cpu().numpy()
        for i in range(0, len(strain), args.batch_size)])

    names = list(GLITCH_CLASSES[:args.num_classes])
    cm = confusion_matrix(labels, preds, args.num_classes)
    acc = float((preds == labels).mean())
    report = f"accuracy {acc:.4f} on {len(labels)} samples\n\n" + classification_report(labels, preds, names)
    print(report)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "evaluation.txt"), "w") as f:
        f.write(report + "\n")
    np.savetxt(os.path.join(args.output_dir, "confusion_matrix.txt"), cm, fmt="%d")


if __name__ == "__main__":
    main()
