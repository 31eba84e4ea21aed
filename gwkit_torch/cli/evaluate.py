"""MLGWSC-1 evaluation CLI on the port (counterpart of
``gwkit/cli/evaluate.py``): FAR and sensitive distance from foreground and
background event files.

    python -m gwkit_torch.cli.evaluate --injection-file inj.hdf \\
        --foreground-events fg_out.hdf --foreground-files fg.hdf \\
        --background-events bg_out.hdf --output-file stats.hdf

Host code (numpy and h5py): it needs no card.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np

from gwkit_torch.cli.common import (add_common_args, check_file_existence, configure_logging,
                                    dump_config, parse_with_config)
from gwkit_torch.evaluation.mlgwsc import find_injection_times, get_stats, read_events


def parse_args(argv=None):
    p = ArgumentParser(description="Calculate FAR and sensitive distance of a search (MLGWSC-1 protocol).")
    add_common_args(p)
    p.add_argument("--injection-file", type=str, required=True)
    p.add_argument("--foreground-events", type=str, nargs="+", required=True)
    p.add_argument("--foreground-files", type=str, nargs="+", required=True)
    p.add_argument("--background-events", type=str, nargs="+", required=True)
    p.add_argument("--output-file", type=str, required=True)
    return parse_with_config(p, argv)


def main(argv=None):
    import h5py

    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    dump_config(args, args.output_file)
    if os.path.splitext(args.output_file)[1] != ".hdf":
        raise ValueError("The output file must have the extension `.hdf`.")
    check_file_existence(args.output_file, args.force)

    padding_start, padding_end = 30, 30
    dur, idxs = find_injection_times(args.foreground_files, args.injection_file,
                                     padding_start=padding_start, padding_end=padding_end)
    if np.sum(idxs) == 0:
        raise RuntimeError(
            "The foreground data contains no injections! Generate at least "
            f"{padding_start + padding_end + 24} seconds of data.")

    injparams = {}
    with h5py.File(args.injection_file, "r") as fp:
        for key in ("tc", "distance", "mass1", "mass2"):
            injparams[key] = fp[key][()][idxs]
        use_chirp_distance = "chirp_distance" in fp.keys()

    stats = get_stats(read_events(args.foreground_events), read_events(args.background_events), injparams,
                      duration=dur, chirp_distance=use_chirp_distance)
    with h5py.File(args.output_file, "w" if args.force else "x") as fp:
        for key, val in stats.items():
            fp.create_dataset(key, data=np.array(val))
    print(f"Wrote {args.output_file}")


if __name__ == "__main__":
    main()
