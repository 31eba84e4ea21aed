"""MLGWSC-1 training CLI on the port (counterpart of
``gwkit/cli/train_mlgwsc.py``): Q-adapter + Whisper encoder + DoRA, with
optional InfoNCE contrastive pretraining.

    python -m gwkit_torch.cli.train_mlgwsc -d DATASET_DIR -o OUTDIR \\
        --pretrained-encoder encoder.npz --target-shape 80 512 \\
        --batch-size 64 --learning-rate 3e-4

DATASET_DIR holds HDF5 files with ``training`` and ``validation`` groups
(``waveforms``, ``noises``), as gwkit writes them. On the CUDA card the
encoder runs in bf16 with tanh GELU and every layer on the hand-written
kernels (forward chain, attention backward); ``--cpu`` runs f32, erf GELU
and plain PyTorch.
"""
from __future__ import annotations

import glob
import os
from argparse import ArgumentParser

from gwkit_torch.cli.common import (add_adapter_args, add_common_args, add_mesh_arg, build_adapter_config,
                                    build_encoder_config, build_mesh, configure_logging, dump_config,
                                    load_encoder_params, parse_with_config)


def parse_args(argv=None):
    p = ArgumentParser(description="GW-Whisper (Q-Scan) training")
    add_common_args(p)
    add_adapter_args(p)
    add_mesh_arg(p)
    p.add_argument("-d", "--dataset-dir", type=str, required=True)
    p.add_argument("-o", "--output-training", type=str, required=True)
    p.add_argument("--n-detectors", type=int, default=2)
    p.add_argument("--sample-rate", type=int, default=2048)
    p.add_argument("--spectrogram-shape", type=int, nargs=2, default=[128, 128])
    p.add_argument("--target-shape", type=int, nargs=2, default=[80, 3000])
    p.add_argument("--q-range", type=float, nargs=2, default=[4.0, 128.0])
    p.add_argument("--kernel-length", type=float, default=1.0)
    p.add_argument("--snr", type=float, nargs=2, default=(5.0, 15.0))
    p.add_argument("--learning-rate", type=float, default=5e-5)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--clip-norm", type=float, default=100.0)
    p.add_argument("--early-stop-patience", type=int, default=10)
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--resume", nargs="?", const="latest", default=None, choices=["latest", "best"])
    p.add_argument("--pretrain-steps", type=int, default=0, help="InfoNCE steps (0 to skip).")
    p.add_argument("--pretrain-lr", type=float, default=1e-4)
    p.add_argument("--pretrain-temp", type=float, default=0.1)
    p.add_argument("--noise-only-prob", type=float, default=0.25)
    return parse_with_config(p, argv)


def main(argv=None):
    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    # first: under torchrun this sets the rank's card before anything is placed on one
    mesh = build_mesh(args)
    dump_config(args, args.output_training)
    from gwkit_torch.data.datasets import load_concat_datasets
    from gwkit_torch.device import resolve_device
    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.train.pretrain import ContrastivePretrainer
    from gwkit_torch.train.tasks import build_mlgwsc
    from gwkit_torch.train.trainer import TrainConfig, Trainer

    device = mesh.device if mesh is not None else resolve_device("cpu" if args.cpu else None)
    paths = sorted(p for p in glob.glob(os.path.join(args.dataset_dir, "*")) if os.path.isfile(p))
    train_ds, valid_ds = load_concat_datasets(paths, snr_range=tuple(args.snr), device=device)
    qcfg = QAdapterConfig(kernel_length=args.kernel_length, sample_rate=args.sample_rate,
                          q_range=tuple(args.q_range), spectrogram_shape=tuple(args.spectrogram_shape),
                          target_shape=tuple(args.target_shape), n_detectors=args.n_detectors)
    enc_cfg = build_encoder_config(args, args.target_shape[1])
    encoder = load_encoder_params(args, enc_cfg)
    task = build_mlgwsc(enc_cfg, qcfg, {"encoder": encoder} if encoder is not None else None,
                        usr=False, num_classes=args.num_classes, device=device,
                        acfg=build_adapter_config(args), seed=args.seed)

    if args.pretrain_steps > 0:
        pre = ContrastivePretrainer(task, lr=args.pretrain_lr, temperature=args.pretrain_temp, seed=args.seed)
        pre.train(train_ds.noises, train_ds.waveforms, steps=args.pretrain_steps,
                  batch_size=min(128, args.batch_size), snr_range=tuple(args.snr),
                  noise_only_prob=args.noise_only_prob, outdir=args.output_training, seed=args.seed)

    trainer = Trainer(
        task.loss_fn, task.trainable, task.frozen,
        TrainConfig(learning_rate=args.learning_rate, clip_norm=args.clip_norm, epochs=args.epochs,
                    batch_size=args.batch_size, early_stop_patience=args.early_stop_patience,
                    optimizer="adam", seed=args.seed),
        export_components=task.export_components, mesh=mesh)
    trainer.fit(lambda g: train_ds.batches(g, args.batch_size),
                lambda g: valid_ds.batches(g, max(32, args.batch_size), shuffle=False, drop_remainder=False),
                outdir=args.output_training, resume=args.resume, force=args.force)


if __name__ == "__main__":
    main()
