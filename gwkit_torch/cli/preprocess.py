"""Offline preprocessing CLI on the port (counterpart of
``gwkit/cli/preprocess.py``). Two modes:

* ``resample``: every dataset of an HDF5 file (groups walked) resampled
  from ``--original-rate`` to ``--target-rate`` through the FFT
  (``ops/resample.py::resample_fourier``), ``--chunk`` rows at a time, on
  the CUDA card (``--cpu``: the CPU);
* ``events``: each (D, N) event strain cut into overlapping windows
  (``--window``, ``--step``), on the host.

    python -m gwkit_torch.cli.preprocess resample in.hdf out.hdf [--target-rate 16000] [--chunk 1000]
    python -m gwkit_torch.cli.preprocess events events.hdf windows.hdf [--window 2048] [--step 204]

The training and inference paths resample on the device themselves; this
tool writes corpora for pipelines that expect resampled or windowed files.
"""
from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

from gwkit_torch.cli.common import add_common_args, configure_logging, dump_config, parse_with_config


def parse_args(argv=None):
    p = ArgumentParser(description="Offline resampling / windowing of strain corpora.")
    add_common_args(p)
    sub = p.add_subparsers(dest="mode", required=True)

    rs = sub.add_parser("resample", help="Resample every dataset in an HDF5 file.")
    rs.add_argument("input", type=str)
    rs.add_argument("output", type=str)
    rs.add_argument("--original-rate", type=int, default=2048)
    rs.add_argument("--target-rate", type=int, default=16000)
    rs.add_argument("--chunk", type=int, default=1000, help="Rows per processing chunk.")

    ev = sub.add_parser("events", help="Cut event strain into overlapping windows.")
    ev.add_argument("input", type=str, help="HDF5 with one (D, N) dataset per event.")
    ev.add_argument("output", type=str)
    ev.add_argument("--window", type=int, default=2048)
    ev.add_argument("--step", type=int, default=204)
    return parse_with_config(p, argv)


def _walk_datasets(h5group, prefix=""):
    import h5py

    for key, item in h5group.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(item, h5py.Group):
            yield from _walk_datasets(item, path)
        else:
            yield path, item


def main(argv=None):
    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    dump_config(args, args.output)
    import h5py
    import torch

    from gwkit_torch.device import resolve_device
    from gwkit_torch.ops.resample import resample_fourier

    if args.mode == "resample":
        device = resolve_device("cpu" if args.cpu else None)
        with h5py.File(args.input, "r") as fin, h5py.File(args.output, "w") as fout:
            for path, ds in _walk_datasets(fin):
                data = ds[()]
                if data.ndim == 1:
                    data = data[None]
                n_out = data.shape[-1] * args.target_rate // args.original_rate
                rows = []
                for s in range(0, len(data), args.chunk):
                    chunk = torch.from_numpy(np.asarray(data[s:s + args.chunk], np.float32)).to(device)
                    rows.append(resample_fourier(chunk, n_out).cpu().numpy())
                out = np.concatenate(rows)
                fout.create_dataset(path, data=out.squeeze())
                print(f"{path}: {data.shape} -> {out.shape}")
    else:
        with h5py.File(args.input, "r") as fin, h5py.File(args.output, "w") as fout:
            for path, ds in _walk_datasets(fin):
                strain = ds[()]
                if strain.ndim == 1:
                    strain = strain[None]
                n = strain.shape[-1]
                starts = np.arange(0, n - args.window + 1, args.step)
                windows = np.stack([strain[:, s:s + args.window] for s in starts])
                fout.create_dataset(path, data=windows.astype(np.float32))
                print(f"{path}: {len(starts)} windows of {args.window}")


if __name__ == "__main__":
    main()
