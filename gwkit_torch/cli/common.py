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

# gwkit's dest -> section registry (``gwkit/utils/config.py``), so a
# config.json of either package loads in the other; any dest not listed
# lands in "run".
SECTIONS: Dict[str, str] = {
    # data
    "dataset": "data", "dataset_dir": "data", "data_dir": "data",
    "input": "data", "inputfile": "data", "input_sample_rate": "data",
    "sample_rate": "data", "n_detectors": "data", "snr": "data",
    "snrs": "data", "n_frames": "data", "duration": "data",
    "real_noise_path": "data", "n_train": "data", "n_valid": "data",
    "waveform_fraction": "data", "approximant": "data", "chunk_size": "data",
    "window": "data", "step": "data", "window_duration": "data",
    "wave_duration": "data",
    # model
    "encoder": "model", "method": "model", "lora_rank": "model",
    "lora_alpha": "model", "target_modules": "model", "hf_checkpoint": "model",
    "spectrogram_shape": "model", "target_shape": "model", "q_range": "model",
    "kernel_length": "model", "num_classes": "model", "head": "model",
    "full_finetune": "model",
    # train
    "learning_rate": "train", "epochs": "train", "batch_size": "train",
    "clip_norm": "train", "early_stop_patience": "train", "optimizer": "train",
    "resume": "train", "pretrain_steps": "train", "pretrain_lr": "train",
    "pretrain_temp": "train", "noise_only_prob": "train", "scheduler": "train",
    "run_index": "train", "valid_fraction": "train",
    # search
    "step_size": "search", "trigger_threshold": "search", "white": "search",
    "cluster_threshold": "search", "low_frequency_cutoff": "search",
    "whitened_file": "search", "raw_triggers_file": "search",
    "softmax": "search", "stream": "search", "shard_dir": "search",
    # eval
    "injection_file": "eval", "foreground_events": "eval",
    "background_events": "eval", "foreground_files": "eval",
    "chirp_distance": "eval", "faps": "eval", "padding_start": "eval",
    "padding_end": "eval",
}
# not part of a run's configuration: never read from nor written to a config file
_RUN_ONLY = {"config", "help", "trace_dir"}


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--verbose", action="store_true", help="Print info logs.")
    parser.add_argument("--debug", action="store_true", help="Enable debug logs.")
    parser.add_argument("--force", action="store_true", help="Overwrite existing outputs.")
    parser.add_argument("--seed", type=int, default=42, help="Random seed.")
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU (plain PyTorch paths) instead of the CUDA card.")
    parser.add_argument("--debug-nans", action="store_true",
                        help="Raise if any window score is NaN or infinite.")
    add_config_arg(parser)


def add_config_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config (flat or sectioned); explicit flags take precedence.")


def configure_logging(verbose: bool = False, debug: bool = False) -> None:
    level = logging.DEBUG if debug else (logging.INFO if verbose else logging.WARNING)
    logging.basicConfig(format="%(levelname)s | %(asctime)s: %(message)s", level=level,
                        datefmt="%d-%m-%Y %H:%M:%S", handlers=[logging.StreamHandler(sys.stdout)])


def _all_actions(parser: argparse.ArgumentParser):
    """Every action of the parser and of its subparsers, recursively."""
    for a in parser._actions:
        yield a
        if isinstance(a, argparse._SubParsersAction):
            for sub in a.choices.values():
                yield from _all_actions(sub)


def _explicit_dests(parser: argparse.ArgumentParser, argv) -> set:
    """The dests passed on the command line: a re-parse with every default,
    the subcommands' included, suppressed."""
    saved = [(a, a.default) for a in _all_actions(parser)]
    try:
        for a, _ in saved:
            a.default = argparse.SUPPRESS
        ns, _ = parser.parse_known_args(argv)
        return set(vars(ns))
    finally:
        for a, d in saved:
            a.default = d


def _flatten(tree: dict) -> dict:
    """A config tree grouped by section, flat, or mixed -> flat."""
    flat = {}
    section_names = set(SECTIONS.values()) | {"run"}
    for key, val in tree.items():
        if key in section_names and isinstance(val, dict):
            flat.update(val)
        else:
            flat[key] = val
    return flat


def parse_with_config(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """parse_args with ``--config`` support (the file may be flat or grouped
    by section; unknown keys are rejected)."""
    args = parser.parse_args(argv)
    if args.config:
        explicit = _explicit_dests(parser, argv)
        with open(args.config) as f:
            flat = _flatten(json.load(f))
        unknown = sorted(k for k in flat if k not in vars(args))
        if unknown:
            raise SystemExit(f"--config {args.config}: keys not accepted by this entry point: {unknown}")
        for dest, val in flat.items():
            if dest not in explicit and dest not in _RUN_ONLY:
                setattr(args, dest, val)
    return args


def config_tree(args: argparse.Namespace) -> dict:
    """The resolved namespace grouped into gwkit's section tree."""
    tree: Dict[str, dict] = {}
    for dest, val in sorted(vars(args).items()):
        if dest not in _RUN_ONLY:
            tree.setdefault(SECTIONS.get(dest, "run"), {})[dest] = val
    return tree


def dump_config(args: argparse.Namespace, output: Optional[str]) -> Optional[str]:
    """Write the resolved config beside the run's outputs: for an output
    file ``<file>.config.json`` next to it, for an output directory
    ``config.json`` inside it (as gwkit's ``dump_config``)."""
    if not output:
        return None
    if os.path.splitext(output)[1]:
        outdir, name = os.path.dirname(os.path.abspath(output)), os.path.basename(output) + ".config.json"
    else:
        outdir, name = output, "config.json"
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, name)
    with open(path, "w") as f:
        json.dump(config_tree(args), f, indent=2, sort_keys=True, default=str)
    logging.info("resolved config written to %s", path)
    return path


def add_adapter_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--encoder", type=str, default="tiny",
                        choices=["tiny", "base", "small", "medium", "large"], help="Whisper encoder size.")
    parser.add_argument("--method", type=str, default="DoRA", choices=["DoRA", "LoRA"],
                        help="Adapter variant.")
    parser.add_argument("--lora-rank", type=int, default=8, help="LoRA rank.")
    parser.add_argument("--lora-alpha", type=int, default=32, help="LoRA alpha.")
    parser.add_argument("--target-modules", type=str, default="qkvo",
                        help="Adapter targets: qkvo|qkv|kv|qv or comma list.")
    parser.add_argument("--hf-checkpoint", type=str, default=None,
                        help="Path to HF whisper weights (safetensors/torch) for the base encoder.")
    parser.add_argument("--pretrained-encoder", type=str, default=None,
                        help="gwkit encoder pytree (.npz), e.g. the InfoNCE-pretrained encoder.")


def add_mesh_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model-parallel", type=int, default=0,
                        help="Train over a ('data', 'model') mesh of every rank of the process "
                             "group with this tensor-parallel degree (0 = one device; 1 = pure "
                             "data parallel). Several ranks: start the CLI under torchrun.")


def build_mesh(args):
    """The mesh for ``Trainer(mesh=)`` when ``--model-parallel`` is set, else
    None. Under ``torchrun`` (``WORLD_SIZE`` set) the process group is
    initialized from its environment first, on the CPU with ``--cpu``."""
    if not getattr(args, "model_parallel", 0):
        return None
    from gwkit_torch.parallel.distributed import initialize
    from gwkit_torch.parallel.mesh import make_mesh

    device = "cpu" if args.cpu else None
    if "WORLD_SIZE" in os.environ:
        initialize(device=device)
    return make_mesh(n_model=args.model_parallel, device=device)


def build_adapter_config(args):
    from gwkit_torch.models.adapters import AdapterConfig

    return AdapterConfig(r=args.lora_rank, alpha=args.lora_alpha, use_dora=(args.method == "DoRA"),
                         targets=args.target_modules)


def build_encoder_config(args, n_frames: Optional[int] = None):
    """The training CLIs' encoder config: on the card bf16, every layer on the
    kernel chain and tanh GELU (gwkit's accelerator setting); with ``--cpu``
    f32, the unfused layer and erf GELU."""
    import torch

    from gwkit_torch.models.whisper import config_for

    on_card = not args.cpu
    kw = dict(compute_dtype=torch.bfloat16 if on_card else torch.float32, fused_block=on_card,
              gelu_approx=on_card)
    if n_frames:
        kw["max_positions"] = n_frames // 2
    return config_for(args.encoder, **kw)


def load_encoder_params(args, enc_cfg):
    """The base encoder from ``--hf-checkpoint`` or ``--pretrained-encoder``
    as the port's parameters (``pos`` re-pinned to ``enc_cfg``), or None."""
    from gwkit_torch.io import from_gwkit_numpy
    from gwkit_torch.models.whisper import sinusoid_positions

    if args.hf_checkpoint:
        from gwkit_torch.models.hf_io import load_hf_encoder

        _, params = load_hf_encoder(args.hf_checkpoint, size=args.encoder)
        params["pos"] = sinusoid_positions(enc_cfg.max_positions, enc_cfg.d_model)
    elif args.pretrained_encoder:
        from gwkit_torch.cli.inference import _load_gwkit_encoder

        params = _load_gwkit_encoder(args.pretrained_encoder, args.encoder, enc_cfg)
    else:
        return None
    return from_gwkit_numpy(encoder=params)["encoder"]


def load_task(args, build, device, checkpoint: Optional[str] = None, **kw):
    """The mel CLIs' task: ``build`` (``build_signal_vs_noise`` or
    ``build_glitch``) on :func:`build_encoder_config`'s encoder, the base
    encoder of ``--hf-checkpoint``/``--pretrained-encoder`` and the adapter
    flags, at ``args.input_sample_rate`` unless ``kw`` says otherwise; with
    ``checkpoint``'s trainables when given."""
    enc_cfg = build_encoder_config(args, args.n_frames)
    encoder = load_encoder_params(args, enc_cfg)
    if "input_sample_rate" not in kw:
        kw["input_sample_rate"] = args.input_sample_rate
    task = build(enc_cfg, {"encoder": encoder} if encoder is not None else None, acfg=build_adapter_config(args),
                 n_frames=args.n_frames, device=device, seed=args.seed, **kw)
    if checkpoint:
        load_checkpoint(task, checkpoint)
    return task


def load_checkpoint(task, path: str) -> None:
    """Replace the task's trainables with a checkpoint's (gwkit's tree
    layout, either package's ``best.npz`` or ``state_e_*.npz``)."""
    from gwkit_torch.train.checkpoints import from_gwkit_tree, load_pytree, to_gwkit_tree

    loaded, _ = load_pytree(path, to_gwkit_tree(task.trainable))
    task.trainable = from_gwkit_tree(loaded, task.device)


def check_file_existence(path: Optional[str], force: bool) -> None:
    """Refuse to overwrite an existing output unless --force."""
    if path is not None and os.path.isfile(path) and not force:
        raise IOError(f"The file {path} already exists. Set the flag `--force` to overwrite it.")
