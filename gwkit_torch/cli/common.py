"""CLI plumbing shared by the port's entry points: common flags, logging,
``--config`` files (defaults < file < explicit flags, as gwkit's
``gwkit/utils/config.py``) and the resolved-config dump beside the outputs."""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, Optional

# dest -> section of the dumped config tree (anything else lands in "run")
SECTIONS: Dict[str, str] = {
    "inputfile": "data",
    "encoder": "model", "hf_checkpoint": "model", "target_shape": "model",
    "pretrained_encoder": "model", "lora_weights": "model", "dense_weights": "model",
    "adapter_weights": "model",
    "batch_size": "search", "step_size": "search", "trigger_threshold": "search",
    "white": "search", "cluster_threshold": "search", "softmax": "search", "stream": "search",
}
_RUN_ONLY = {"config", "help"}


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--verbose", action="store_true", help="Print info logs.")
    parser.add_argument("--debug", action="store_true", help="Enable debug logs.")
    parser.add_argument("--force", action="store_true", help="Overwrite existing outputs.")
    parser.add_argument("--seed", type=int, default=42, help="Random seed.")
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU (plain PyTorch paths) instead of the CUDA card.")
    parser.add_argument("--debug-nans", action="store_true",
                        help="Raise if any window score is NaN or infinite.")
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config (flat or sectioned); explicit flags take precedence.")


def configure_logging(verbose: bool = False, debug: bool = False) -> None:
    level = logging.DEBUG if debug else (logging.INFO if verbose else logging.WARNING)
    logging.basicConfig(format="%(levelname)s | %(asctime)s: %(message)s", level=level,
                        datefmt="%d-%m-%Y %H:%M:%S", handlers=[logging.StreamHandler(sys.stdout)])


def _explicit_dests(parser: argparse.ArgumentParser, argv) -> set:
    saved = [(a, a.default) for a in parser._actions]
    try:
        for a, _ in saved:
            a.default = argparse.SUPPRESS
        ns, _ = parser.parse_known_args(argv)
        return set(vars(ns))
    finally:
        for a, d in saved:
            a.default = d


def parse_with_config(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """parse_args with ``--config`` support (the file may be flat or grouped
    by section; unknown keys are rejected)."""
    args = parser.parse_args(argv)
    if args.config:
        explicit = _explicit_dests(parser, argv)
        with open(args.config) as f:
            tree = json.load(f)
        flat = {}
        for key, val in tree.items():
            if isinstance(val, dict) and key in set(SECTIONS.values()) | {"run"}:
                flat.update(val)
            else:
                flat[key] = val
        unknown = sorted(k for k in flat if k not in vars(args))
        if unknown:
            raise SystemExit(f"--config {args.config}: keys not accepted by this entry point: {unknown}")
        for dest, val in flat.items():
            if dest not in explicit and dest not in _RUN_ONLY:
                setattr(args, dest, val)
    return args


def dump_config(args: argparse.Namespace, output_file: Optional[str]) -> Optional[str]:
    """Write the resolved config as ``<output_file>.config.json`` beside the output."""
    if not output_file:
        return None
    tree: Dict[str, dict] = {}
    for dest, val in sorted(vars(args).items()):
        if dest not in _RUN_ONLY:
            tree.setdefault(SECTIONS.get(dest, "run"), {})[dest] = val
    outdir = os.path.dirname(os.path.abspath(output_file))
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, os.path.basename(output_file) + ".config.json")
    with open(path, "w") as f:
        json.dump(tree, f, indent=2, sort_keys=True, default=str)
    logging.info("resolved config written to %s", path)
    return path


def check_file_existence(path: Optional[str], force: bool) -> None:
    """Refuse to overwrite an existing output unless --force."""
    if path is not None and os.path.isfile(path) and not force:
        raise IOError(f"The file {path} already exists. Set the flag `--force` to overwrite it.")
