"""Efficiency-sweep CLI on the port (counterpart of
``gwkit/cli/calculate_efficiencies.py``): each training checkpoint scores
the dataset's pure noise (one threshold per FAP) and its injections at
each fixed SNR, with the raw logit as the ranking score (USR mode), and
writes ``out_efficiencies_<checkpoint>.txt`` (true-alarm probability
against SNR at each FAP).

    python -m gwkit_torch.cli.calculate_efficiencies -d DATASET --checkpoint-dir RUN -o OUTDIR \\
        [--epochs best|all|3,7] [--snrs 5 7 ... 23] [--faps 1e-1 ... 1e-4] [--n-frames 3000]

DATASET is an HDF5 file with a ``validation`` (else ``training``) group;
RUN a training run's directory (``state_e_*.npz``, ``best.npz``). On the
CUDA card the encoder runs in bf16 on the hand-written kernels; ``--cpu``
runs f32 and plain PyTorch.
"""
from __future__ import annotations

import glob
import os
from argparse import ArgumentParser
from typing import Dict

import numpy as np

from gwkit_torch.cli.common import (add_adapter_args, add_common_args, configure_logging, dump_config, load_checkpoint,
                                    load_task, parse_with_config)


def parse_args(argv=None):
    p = ArgumentParser(description="Compute detection efficiencies (TAP vs SNR at fixed FAPs).")
    add_common_args(p)
    add_adapter_args(p)
    p.add_argument("-d", "--dataset", type=str, required=True,
                   help="HDF5 InjectionDataset file (training/validation groups).")
    p.add_argument("--checkpoint-dir", type=str, required=True,
                   help="Training output dir (state_e_*.npz / best.npz).")
    p.add_argument("-o", "--output-dir", type=str, required=True)
    p.add_argument("--snrs", type=float, nargs="+", default=[5, 7, 9, 11, 13, 15, 17, 19, 21, 23])
    p.add_argument("--faps", type=float, nargs="+", default=[1e-1, 1e-2, 1e-3, 1e-4])
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=str, default="best",
                   help="'best', 'all', or comma-separated epoch numbers.")
    p.add_argument("--n-frames", type=int, default=3000)
    p.add_argument("--input-sample-rate", type=int, default=2048)
    return parse_with_config(p, argv)


def split_dataset(ds, device):
    """(injection set, noise set): the first ``n_waveforms`` noises with the
    waveforms, and the other noises with none."""
    from gwkit_torch.data.datasets import InjectionDataset

    m = ds.n_waveforms
    empty = ds.noises.new_zeros((0,) + ds.noises.shape[1:])
    return (InjectionDataset(noises=ds.noises[:m], waveforms=ds.waveforms, device=device),
            InjectionDataset(noises=ds.noises[m:], waveforms=empty, device=device))


def sweep(args, ds, device) -> Dict[str, np.ndarray]:
    """The CLI's recipe on an InjectionDataset already on ``device``: one
    table a checkpoint, written and returned as {checkpoint name:
    efficiencies (snrs, faps)}."""
    from gwkit_torch.evaluation.efficiency import EfficiencyEstimator, write_efficiency_table
    from gwkit_torch.train.tasks import build_signal_vs_noise

    wave_ds, noise_ds = split_dataset(ds, device)
    task = load_task(args, build_signal_vs_noise, device)

    if args.epochs == "best":
        paths = [os.path.join(args.checkpoint_dir, "best.npz")]
    elif args.epochs == "all":
        paths = sorted(glob.glob(os.path.join(args.checkpoint_dir, "state_e_*.npz")))
    else:
        paths = [os.path.join(args.checkpoint_dir, f"state_e_{int(e):04d}.npz") for e in args.epochs.split(",")]

    os.makedirs(args.output_dir, exist_ok=True)
    estimator = EfficiencyEstimator(wave_ds, noise_ds, args.snrs, args.batch_size, args.faps)
    tables = {}
    for path in paths:
        load_checkpoint(task, path)
        eff = estimator(lambda x: task.forward(x).reshape(-1), seed=args.seed)  # USR: the raw logit ranks
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.output_dir, f"out_efficiencies_{name}.txt")
        write_efficiency_table(out, args.snrs, args.faps, eff)
        print(f"wrote {out}")
        tables[name] = eff
    return tables


def main(argv=None):
    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    dump_config(args, args.output_dir)
    import h5py

    from gwkit_torch.data.datasets import InjectionDataset
    from gwkit_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    with h5py.File(args.dataset, "r") as f:
        ds = InjectionDataset.load(f, "validation" if "validation" in f else "training", device=device)
    sweep(args, ds, device)


if __name__ == "__main__":
    main()
