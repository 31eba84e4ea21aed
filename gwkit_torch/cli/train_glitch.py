"""Glitch-classification training CLI on the port (counterpart of
``gwkit/cli/train_glitch.py``): the 11-way classifier with DoRA or full
fine-tuning, AdamW at 1e-5 without clipping; the best epoch's
``classification_report.txt`` and ``confusion_matrix.txt`` (and its PNG
where matplotlib is installed).

    python -m gwkit_torch.cli.train_glitch -d corpus.hdf -o OUTDIR \\
        [--full-finetune] [--augment] [--n-frames 3000] [--valid-fraction 0.2]

The HDF5 file holds ``strain`` (N, T) and integer ``labels`` (N,); the
leading ``--valid-fraction`` of it is the validation split. On the CUDA
card the encoder runs in bf16 with tanh GELU and every layer on the
hand-written kernels; ``--cpu`` runs f32, erf GELU and plain PyTorch.
"""
from __future__ import annotations

import importlib.util
import logging
import os
from argparse import ArgumentParser

import numpy as np

from gwkit_torch.cli.common import (add_adapter_args, add_common_args, add_mesh_arg, build_mesh,
                                    configure_logging, dump_config, load_task, parse_with_config)


def parse_args(argv=None):
    p = ArgumentParser(description="Train the multi-class glitch classifier.")
    add_common_args(p)
    add_adapter_args(p)
    add_mesh_arg(p)
    p.add_argument("-d", "--dataset", type=str, required=True,
                   help="HDF5 with 'strain' [N,T] and integer 'labels' [N].")
    p.add_argument("-o", "--output", type=str, required=True)
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--early-stop-patience", type=int, default=60)
    p.add_argument("--num-classes", type=int, default=11)
    p.add_argument("--n-frames", type=int, default=3000)
    p.add_argument("--input-sample-rate", type=int, default=2048)
    p.add_argument("--full-finetune", action="store_true", help="Train the whole encoder.")
    p.add_argument("--valid-fraction", type=float, default=0.2)
    p.add_argument("--augment", action="store_true",
                   help="On-device augmentation (time shift, sign flip, amplitude jitter).")
    return parse_with_config(p, argv)


def main(argv=None):
    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    # first: under torchrun this sets the rank's card before anything is placed on one
    mesh = build_mesh(args)
    dump_config(args, args.output)
    import h5py

    from gwkit_torch.data.glitch import GLITCH_CLASSES, LabeledDataset
    from gwkit_torch.device import resolve_device
    from gwkit_torch.train.metrics import classification_report, confusion_matrix, f1_scores
    from gwkit_torch.train.tasks import build_glitch
    from gwkit_torch.train.trainer import TrainConfig, Trainer

    device = mesh.device if mesh is not None else resolve_device("cpu" if args.cpu else None)
    with h5py.File(args.dataset, "r") as f:
        strain, labels = f["strain"][()], f["labels"][()]
    n_valid = int(len(labels) * args.valid_fraction)
    train_ds = LabeledDataset(strain[n_valid:], labels[n_valid:], augment=args.augment, device=device)
    valid_ds = LabeledDataset(strain[:n_valid], labels[:n_valid], device=device)

    task = load_task(args, build_glitch, device, num_classes=args.num_classes, full_finetune=args.full_finetune)
    trainer = Trainer(
        task.loss_fn, task.trainable, task.frozen,
        TrainConfig(learning_rate=args.learning_rate, epochs=args.epochs, batch_size=args.batch_size,
                    early_stop_patience=args.early_stop_patience, optimizer="adamw", clip_norm=0.0,
                    seed=args.seed),
        export_components=task.export_components, mesh=mesh)

    best_f1 = [-1.0]
    plots = importlib.util.find_spec("matplotlib") is not None
    if not plots:
        logging.warning("matplotlib is not installed: confusion_matrix.png is skipped")

    def eval_metrics(epoch, trainable, val_aux):
        logits = np.concatenate([a["logits"] for a in val_aux])
        labels = np.concatenate([a["labels"] for a in val_aux])
        preds = logits.argmax(-1)
        cm = confusion_matrix(labels, preds, args.num_classes)
        stats = f1_scores(cm)
        print(f"epoch {epoch:04d}: acc {stats['accuracy']:.4f} macroF1 {stats['macro_f1']:.4f}")
        if stats["macro_f1"] > best_f1[0]:  # the reports follow the best epoch, not the last
            best_f1[0] = stats["macro_f1"]
            names = GLITCH_CLASSES[:args.num_classes]
            with open(os.path.join(args.output, "classification_report.txt"), "w") as f:
                f.write(f"best epoch {epoch:04d}\n\n" + classification_report(labels, preds, names))
            np.savetxt(os.path.join(args.output, "confusion_matrix.txt"), cm, fmt="%d")
            if plots:
                from gwkit_torch.utils.plotting import plot_confusion_matrix

                plot_confusion_matrix(cm, names, os.path.join(args.output, "confusion_matrix.png"))
        return {"val_accuracy": stats["accuracy"], "val_macro_f1": stats["macro_f1"]}

    os.makedirs(args.output, exist_ok=True)
    trainer.fit(lambda g: train_ds.batches(g, args.batch_size),
                lambda g: valid_ds.batches(g, args.batch_size, shuffle=False, drop_remainder=False),
                outdir=args.output, force=args.force, eval_callback=eval_metrics)


if __name__ == "__main__":
    main()
