"""Efficiency-test training CLI on the port (counterpart of
``gwkit/cli/train_efficiency.py``): Signal_vs_Noise training on a ladder
of SNR ranges stepped down by a curriculum scheduler, optionally resetting
the optimizer at each step, with every epoch's checkpoint under
``run_{i:04d}`` (the efficiency sweep reads them).

    python -m gwkit_torch.cli.train_efficiency -d DATASET -o OUTDIR [--i-run 0] \\
        [--scheduler plateau|threshold|epoch|none] [--snr-ladder 50 40 ... 5] \\
        [--reset-optimizer] [--n-frames 3000] [--pretrained-encoder encoder.npz]

DATASET is an HDF5 file with ``training`` and ``validation`` groups
(``waveforms``, ``noises``). Each rung of the ladder is ``(hi - 5, hi)``.
AdamW at 1e-5 without clipping, as gwkit. On the CUDA card the encoder runs
in bf16 with tanh GELU and every layer on the hand-written kernels;
``--cpu`` runs f32, erf GELU and plain PyTorch.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

from gwkit_torch.cli.common import (add_adapter_args, add_common_args, configure_logging, dump_config, load_task,
                                    parse_with_config)


def parse_args(argv=None):
    p = ArgumentParser(description="Curriculum-scheduled efficiency-test training.")
    add_common_args(p)
    add_adapter_args(p)
    p.add_argument("-d", "--dataset", type=str, required=True,
                   help="HDF5 InjectionDataset file (training/validation groups).")
    p.add_argument("-o", "--output", type=str, required=True)
    p.add_argument("--i-run", type=int, default=0, help="Run index (outputs under run_{i:04d}).")
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--scheduler", type=str, default="plateau", choices=["plateau", "threshold", "epoch", "none"])
    p.add_argument("--snr-ladder", type=float, nargs="+", default=[50, 40, 30, 25, 20, 15, 12, 10, 8, 7, 6, 5],
                   help="Upper SNR bounds of the curriculum (lower = upper - 5).")
    p.add_argument("--scheduler-patience", type=int, default=4)
    p.add_argument("--scheduler-threshold", type=float, default=1e-4)
    p.add_argument("--reset-optimizer", action="store_true",
                   help="Reset the optimizer state on each curriculum step.")
    p.add_argument("--n-frames", type=int, default=3000)
    p.add_argument("--input-sample-rate", type=int, default=2048)
    return parse_with_config(p, argv)


def train(args, train_ds, valid_ds, device):
    """The CLI's recipe on two datasets already on ``device``; returns the
    trainer after ``fit``."""
    from gwkit_torch.train.curriculum import EpochCLScheduler, PlateauCLScheduler, ThresholdCLScheduler
    from gwkit_torch.train.tasks import build_signal_vs_noise
    from gwkit_torch.train.trainer import TrainConfig, Trainer

    ladder = [(hi - 5.0, hi) for hi in args.snr_ladder]
    task = load_task(args, build_signal_vs_noise, device)
    trainer = Trainer(
        task.loss_fn, task.trainable, task.frozen,
        TrainConfig(learning_rate=args.learning_rate, epochs=args.epochs, batch_size=args.batch_size,
                    early_stop_patience=10 ** 9, optimizer="adamw", clip_norm=0.0, seed=args.seed),
        export_components=task.export_components)

    def on_step():
        for ds in (train_ds, valid_ds):
            ds.snrs(scheduler.current)
        if args.reset_optimizer:
            trainer.reset_optimizer()

    # construct first, then attach on_step (the base __init__ advances once)
    if args.scheduler == "plateau":
        scheduler = PlateauCLScheduler(ladder, patience=args.scheduler_patience, threshold=args.scheduler_threshold,
                                       allow_interrupt=True)
    elif args.scheduler == "threshold":
        scheduler = ThresholdCLScheduler(ladder, threshold=args.scheduler_threshold)
    elif args.scheduler == "epoch":
        scheduler = EpochCLScheduler(ladder, patience=args.scheduler_patience)
    else:
        scheduler = None
    if scheduler is not None:
        scheduler.on_step = on_step
        on_step()

    trainer.fit(lambda g: train_ds.batches(g, args.batch_size),
                lambda g: valid_ds.batches(g, args.batch_size, shuffle=False, drop_remainder=False),
                outdir=os.path.join(args.output, f"run_{args.i_run:04d}"), force=args.force, scheduler=scheduler)
    return trainer


def main(argv=None):
    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    dump_config(args, args.output)
    import h5py

    from gwkit_torch.data.datasets import InjectionDataset
    from gwkit_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    with h5py.File(args.dataset, "r") as f:
        train_ds = InjectionDataset.load(f, "training", device=device)
        valid_ds = InjectionDataset.load(f, "validation", device=device)
    train(args, train_ds, valid_ds, device)


if __name__ == "__main__":
    main()
