"""Real-events CLI on the port (counterpart of ``gwkit/cli/real_events.py``):
score catalog-event strain with the two-channel classifier and write each
event's sigmoid score series.

    python -m gwkit_torch.cli.real_events -d EVENTS.hdf --checkpoint best.npz -o scores.hdf \\
        [--whiten] [--window 2048] [--step 204] [--batch-size 64] [--n-frames 3000]

EVENTS.hdf holds one (2, N) strain dataset per event, already whitened;
``--whiten`` whitens it first (on the task's device). On the CUDA card the
encoder runs in bf16 on the hand-written kernels; ``--cpu`` runs f32 and
plain PyTorch.
"""
from __future__ import annotations

from argparse import ArgumentParser

from gwkit_torch.cli.common import (add_adapter_args, add_common_args, configure_logging, dump_config, load_task,
                                    parse_with_config)


def parse_args(argv=None):
    p = ArgumentParser(description="Score real-event strain segments with the two-channel model.")
    add_common_args(p)
    add_adapter_args(p)
    p.add_argument("-d", "--events-file", type=str, required=True,
                   help="HDF5 with one (2, N) whitened-strain dataset per event.")
    p.add_argument("--checkpoint", type=str, required=True, help="Trainable checkpoint (.npz).")
    p.add_argument("-o", "--output", type=str, required=True, help="Output HDF5 of per-event sigmoid score series.")
    p.add_argument("--window", type=int, default=2048)
    p.add_argument("--step", type=int, default=204)
    p.add_argument("--sample-rate", type=float, default=2048.0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--n-frames", type=int, default=3000)
    p.add_argument("--whiten", action="store_true", help="Whiten the event strain first.")
    return parse_with_config(p, argv)


def main(argv=None):
    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    dump_config(args, args.output)
    import h5py

    from gwkit_torch.device import resolve_device
    from gwkit_torch.search.realevents import score_event_segments, write_event_scores
    from gwkit_torch.train.tasks import build_signal_vs_noise

    device = resolve_device("cpu" if args.cpu else None)
    with h5py.File(args.events_file, "r") as f:
        events = {name: f[name][()] for name in f.keys()}
    task = load_task(args, build_signal_vs_noise, device, args.checkpoint, input_sample_rate=int(args.sample_rate))
    scores = score_event_segments(task, events, sample_rate=args.sample_rate, window=args.window, step=args.step,
                                  batch_size=args.batch_size, white=not args.whiten)  # --whiten: not yet white
    write_event_scores(args.output, scores)
    for name, vals in scores.items():
        print(f"{name}: {len(vals)} windows, max score {vals.max() if len(vals) else float('nan'):.4f}")


if __name__ == "__main__":
    main()
