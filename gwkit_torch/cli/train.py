"""Signal_vs_Noise training CLI on the port (counterpart of
``gwkit/cli/train.py``): two-detector (or one-detector) binary
classification on the Whisper log-mel front end with DoRA/LoRA, AdamW at
1e-5 without clipping, validation AUC and F1 after every epoch.

    python -m gwkit_torch.cli.train -d DATASET -o OUTDIR [--detectors 1|2] \\
        [--n-frames 3000] [--snr 5 15] [--pretrained-encoder encoder.npz] [--resume]

DATASET is an HDF5 file (or a directory of them) with ``training`` and
``validation`` groups (``waveforms``, ``noises``), as gwkit writes them. On
the CUDA card the encoder runs in bf16 with tanh GELU and every layer on
the hand-written kernels; ``--cpu`` runs f32, erf GELU and plain PyTorch.
"""
from __future__ import annotations

import glob
import os
from argparse import ArgumentParser

import numpy as np

from gwkit_torch.cli.common import (add_adapter_args, add_common_args, add_mesh_arg, build_mesh,
                                    configure_logging, dump_config, load_task, parse_with_config)


def parse_args(argv=None):
    p = ArgumentParser(description="Train the two-detector signal-vs-noise classifier.")
    add_common_args(p)
    add_adapter_args(p)
    add_mesh_arg(p)
    p.add_argument("-d", "--dataset", type=str, required=True,
                   help="HDF5 dataset file/dir with training/validation groups (InjectionDataset layout).")
    p.add_argument("-o", "--output", type=str, required=True, help="Output directory.")
    p.add_argument("--snr", type=float, nargs=2, default=(5.0, 15.0))
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--early-stop-patience", type=int, default=15)
    p.add_argument("--n-frames", type=int, default=3000,
                   help="Mel context length (3000 = Whisper/reference parity).")
    p.add_argument("--input-sample-rate", type=int, default=2048)
    p.add_argument("--detectors", type=int, default=2, choices=[1, 2],
                   help="2 = two-channel H1/L1; 1 = single-detector.")
    p.add_argument("--resume", nargs="?", const="latest", default=None, choices=["latest", "best"])
    return parse_with_config(p, argv)


def main(argv=None):
    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    # first: under torchrun this sets the rank's card before anything is placed on one
    mesh = build_mesh(args)
    dump_config(args, args.output)
    from gwkit_torch.data.datasets import load_concat_datasets
    from gwkit_torch.device import resolve_device
    from gwkit_torch.train.metrics import binary_f1, roc_auc
    from gwkit_torch.train.tasks import build_signal_vs_noise
    from gwkit_torch.train.trainer import TrainConfig, Trainer

    device = mesh.device if mesh is not None else resolve_device("cpu" if args.cpu else None)
    paths = sorted(glob.glob(os.path.join(args.dataset, "*"))) if os.path.isdir(args.dataset) else [args.dataset]
    train_ds, valid_ds = load_concat_datasets(paths, snr_range=tuple(args.snr), device=device)
    task = load_task(args, build_signal_vs_noise, device, n_detectors=args.detectors)
    trainer = Trainer(
        task.loss_fn, task.trainable, task.frozen,
        TrainConfig(learning_rate=args.learning_rate, epochs=args.epochs, batch_size=args.batch_size,
                    early_stop_patience=args.early_stop_patience, optimizer="adamw", clip_norm=0.0,
                    seed=args.seed),
        export_components=task.export_components, mesh=mesh)

    def eval_metrics(epoch, trainable, val_aux):
        scores = np.concatenate([a["scores"] for a in val_aux])
        labels = np.concatenate([a["labels"] for a in val_aux])
        auc = roc_auc(labels, scores)
        f1 = binary_f1(labels, scores > 0.5)
        print(f"epoch {epoch:04d}: val AUC {auc:.4f} F1 {f1:.4f}")
        return {"val_auc": auc, "val_f1": f1}

    trainer.fit(lambda g: train_ds.batches(g, args.batch_size),
                lambda g: valid_ds.batches(g, max(32, args.batch_size), shuffle=False, drop_remainder=False),
                outdir=args.output, resume=args.resume, force=args.force, eval_callback=eval_metrics)


if __name__ == "__main__":
    main()
