"""Data-generation CLI (counterpart of ``gwkit/cli/generate_data.py``;
reference: MLGWSC-1/generate_data.py + gen.py): challenge
foreground/background/injection files, training corpora and glitch corpora,
generated on the CUDA card, or with ``--cpu`` on the CPU.

    python -m gwkit_torch.cli.generate_data challenge -d 3 -f fg.hdf -b bg.hdf -i inj.hdf --duration 3600
    python -m gwkit_torch.cli.generate_data training -o train.hdf --n-train 1000
    python -m gwkit_torch.cli.generate_data glitch -o glitch.hdf --realistic
"""
from __future__ import annotations

from argparse import ArgumentParser

from gwkit_torch.cli.common import (add_common_args, check_file_existence, configure_logging, dump_config,
                                    parse_with_config)


def parse_args(argv=None):
    p = ArgumentParser(description="Generate MLGWSC-style challenge data or training sets.")
    add_common_args(p)
    sub = p.add_subparsers(dest="mode", required=True)

    ch = sub.add_parser("challenge", help="Foreground/background/injection files (generate_data.py).")
    ch.add_argument("-d", "--dataset", type=int, default=1, choices=[1, 2, 3, 4],
                    help="Challenge dataset. 1: design-PSD Gaussian noise, "
                         "non-spinning sources. 2: per-detector PSD variant fixed "
                         "for the run, aligned spins U(-0.99,0.99). 3: fresh PSD "
                         "variant per segment, isotropic spins. 4: real noise from "
                         "--real-noise-file with inter-detector time slides, "
                         "isotropic spins. (--psd-file overrides PSD selection "
                         "with measured files for any of 1-3.)")
    ch.add_argument("--psd-file", type=str, action="append", default=None,
                    metavar="DET=PATH", help="Per-detector ASD/PSD file, e.g. H1=/path/psd.txt (repeatable).")
    ch.add_argument("--real-noise-file", type=str, default=None,
                    help="Dataset 4: local noise file in the challenge layout "
                         "({det}/{start} datasets; see gwkit_torch.data.generate."
                         "write_real_noise_file).")
    ch.add_argument("--download-real-noise", action="store_true",
                    help="Dataset 4: download the challenge real-noise file "
                         "to --real-noise-file (default real_noise_file.hdf) "
                         "with resumable byte-range requests, re-downloading "
                         "if the result is unreadable (generate_data.py:49-91).")
    ch.add_argument("--real-noise-url", type=str, default=None,
                    help="override the real-noise download URL (default: the "
                         "published AEI challenge server)")
    ch.add_argument("--population", type=str, default=None,
                    help="custom injection population: a pycbc_create_injections"
                         "-style .ini (ds{N}.ini field names: [static_params] "
                         "approximant/f_lower, [prior-mass1] min-mass1/..., "
                         "[prior-chirp_distance], aligned spin1z/spin2z or "
                         "isotropic spin1_a+solid-angle sections) or a .json of "
                         "SourceDistribution fields. Overrides the dataset's "
                         "built-in population (generate_data.py:772-790).")
    ch.add_argument("-f", "--output-foreground-file", type=str, required=True)
    ch.add_argument("-b", "--output-background-file", type=str, required=True)
    ch.add_argument("-i", "--output-injection-file", type=str, required=True)
    ch.add_argument("--duration", type=float, default=86400.0)
    ch.add_argument("--sample-rate", type=float, default=2048.0)
    ch.add_argument("--approximant", type=str, default=None,
                    choices=["imrphenomd", "imrphenomhm", "imrphenomp",
                             "imrphenomxphm", "imrphenomxphm-twospin"],
                    help="override the per-dataset approximant split "
                         "(default: imrphenomd for ds1/2, imrphenomxphm for "
                         "ds3/4; 'imrphenomxphm-twospin' injects with the "
                         "two-spin precession-ODE Euler angles)")

    tr = sub.add_parser("training", help="Training/validation corpus (gen.py).")
    tr.add_argument("-o", "--output", type=str, required=True)
    tr.add_argument("--n-train", type=int, default=1000)
    tr.add_argument("--n-valid", type=int, default=200)
    tr.add_argument("--window-duration", type=float, default=1.0)
    tr.add_argument("--sample-rate", type=float, default=2048.0)
    tr.add_argument("--approximant", type=str, default="imrphenomd",
                    choices=["taylorf2", "imrphenomd", "imrphenomhm",
                             "imrphenomp", "imrphenomxphm",
                             "imrphenomp-twospin", "imrphenomxphm-twospin"],
                    help="waveform model for the injection population "
                         "(gen.py's apx choice; precessing models sample "
                         "isotropic spin vectors; '-twospin' variants "
                         "integrate the orbit-averaged two-spin precession "
                         "ODE for the Euler angles instead of the "
                         "leading-order chi_p twist)")
    tr.add_argument("--spin-max", type=float, default=0.0,
                    help="max spin magnitude (0 = non-spinning)")
    tr.add_argument("--population", type=str, default=None,
                    help="custom source population (.ini/.json; see the "
                         "challenge subcommand) — overrides --approximant/"
                         "--spin-max")

    gl = sub.add_parser("glitch", help="Gravity Spy-style glitch corpus (synthetic, or fetched from open data).")
    gl.add_argument("-o", "--output", type=str, required=True)
    gl.add_argument("--n-per-class", type=int, default=100)
    gl.add_argument("--gravityspy-csv", type=str, nargs="+", default=None,
                    help="Gravity Spy trigger CSVs: fetch real open-data strain "
                         "via gwpy (network required) instead of synthesizing.")
    gl.add_argument("--max-rows-per-file", type=int, default=None)
    gl.add_argument("--realistic", action="store_true",
                    help="embed the morphologies in PSD-colored noise at "
                         "Gravity-Spy-like per-class SNRs and run the real "
                         "reference's whiten/highpass/asymmetric-crop pipeline "
                         "(generate_glitch_dataset.py:31-72 semantics) instead "
                         "of adding white noise in the whitened domain")
    return parse_with_config(p, argv)


def main(argv=None):
    from gwkit_torch.device import resolve_device

    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    device = resolve_device("cpu" if args.cpu else None)
    dump_config(args, getattr(args, "output", None) or args.output_foreground_file)
    if args.mode == "challenge":
        from gwkit_torch.data.generate import generate_challenge_data

        for path in (args.output_foreground_file, args.output_background_file, args.output_injection_file):
            check_file_existence(path, args.force)
        psd_names = None
        if args.psd_file:
            psd_names = dict(spec.split("=", 1) for spec in args.psd_file)
        if args.dataset == 4 and args.download_real_noise:
            from gwkit_torch.data.fetch import REAL_NOISE_URL, download_real_noise

            args.real_noise_file = download_real_noise(
                args.real_noise_file or "real_noise_file.hdf",
                url=args.real_noise_url or REAL_NOISE_URL)
        if args.dataset == 4 and not args.real_noise_file:
            raise SystemExit(
                "dataset 4 needs --real-noise-file (or --download-real-noise)")
        distribution = None
        if args.population:
            from gwkit_torch.data.population import load_population

            distribution = load_population(args.population)
        if args.approximant:
            import dataclasses

            from gwkit_torch.data.generate import challenge_distribution

            distribution = dataclasses.replace(
                distribution or challenge_distribution(args.dataset),
                approximant=args.approximant)
        generate_challenge_data(
            args.output_foreground_file, args.output_background_file, args.output_injection_file,
            duration=args.duration, sample_rate=args.sample_rate, seed=args.seed,
            psd_names=psd_names, dataset=args.dataset,
            real_noise_path=args.real_noise_file,
            distribution=distribution, device=device,
        )
        print("challenge data written")
    elif args.mode == "training":
        from gwkit_torch.data.generate import generate_training_set
        from gwkit_torch.data.waveforms import SourceDistribution

        check_file_existence(args.output, args.force)
        if args.population:
            from gwkit_torch.data.population import load_population

            dist = load_population(args.population)
        else:
            precessing = args.approximant.split("-")[0] in (
                "imrphenomp", "imrphenomxphm")
            dist = SourceDistribution(
                spin_max=args.spin_max or (0.99 if precessing else 0.0),
                isotropic_spins=precessing, approximant=args.approximant)
        generate_training_set(
            args.output, n_train=args.n_train, n_valid=args.n_valid,
            window_duration=args.window_duration, sample_rate=args.sample_rate, seed=args.seed,
            distribution=dist, device=device,
        )
        print(f"training set written to {args.output}")
    elif getattr(args, "gravityspy_csv", None):
        from gwkit_torch.data.fetch import build_gravityspy_corpus

        n = build_gravityspy_corpus(args.gravityspy_csv, args.output,
                                    max_rows_per_file=args.max_rows_per_file, device=device)
        print(f"glitch corpus fetched to {args.output} ({n} samples)")
    else:
        import h5py

        from gwkit_torch.data.glitch import realistic_glitch_dataset, synthetic_glitch_dataset

        if getattr(args, "realistic", False):
            x, y = realistic_glitch_dataset(args.n_per_class, seed=args.seed, device=device)
        else:
            x, y = synthetic_glitch_dataset(args.n_per_class, seed=args.seed)
        with h5py.File(args.output, "w") as f:
            f.create_dataset("strain", data=x)
            f.create_dataset("labels", data=y)
        print(f"glitch corpus written to {args.output} ({len(y)} samples)")


if __name__ == "__main__":
    main()
