"""MLGWSC-1 continuous-search CLI on the port (counterpart of
``gwkit/cli/inference.py``, ``gwkit-infer``): apply a trained two-detector
model over strain segments and write clustered triggers.

    python -m gwkit_torch.cli.inference in.hdf out.hdf --lora-weights DIR \\
        --dense-weights head.npz --adapter-weights qadapter.npz \\
        --pretrained-encoder encoder.npz --target-shape 80 512

It runs on the CUDA card (bf16, tanh GELU, every encoder layer on the
hand-written kernels) unless ``--cpu`` is given (f32, erf GELU, plain
PyTorch), the settings gwkit picks on a TPU and on the CPU. ``--int8`` puts
the encoder's projections on int8 (kernel E) on the card and, as in gwkit,
does nothing on the CPU. ``--qscan-stream`` takes the experimental streaming
Q-scan for long segments. Under ``torchrun`` each process searches a
round-robin share of the segments, the trigger lists merge through
``--shard-dir``, and rank 0 writes the output. ``--trace-dir DIR`` records
the search in a ``torch.profiler`` trace under DIR, with the port's
``gw.*`` layer spans, and prints the port's counters over the search.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from argparse import ArgumentParser
from typing import Optional, Tuple

import numpy as np
import torch

from gwkit_torch.cli.common import (add_common_args, check_file_existence, configure_logging,
                                    dump_config, parse_with_config)
from gwkit_torch.device import DeviceLike, resolve_device
from gwkit_torch.io import from_gwkit_numpy, import_peft_dir, load_pytree_npz, tree_leaves
from gwkit_torch.models.heads import HEAD_WIDTHS, mlp_head_shapes
from gwkit_torch.models.hf_io import load_hf_encoder
from gwkit_torch.models.qadapter import QAdapterConfig
from gwkit_torch.models.qadapter import param_shapes as qadapter_shapes
from gwkit_torch.models.whisper import (WhisperConfig, config_for, init_encoder_params,
                                        param_shapes, sinusoid_positions)
from gwkit_torch.train.tasks import Task, build_mlgwsc
from gwkit_torch.utils.tracing import COUNTERS, trace


def parse_args(argv=None):
    p = ArgumentParser(description="Apply a trained two-detector GW-Whisper model and save triggers.")
    add_common_args(p)
    p.add_argument("inputfile", type=str)
    p.add_argument("outputfile", type=str)
    p.add_argument("--white", action="store_true", help="Input is already whitened.")
    p.add_argument("--softmax", action="store_true", help="Use softmax scores (default USR logits).")
    p.add_argument("--lora-weights", type=str, required=True, help="peft-compatible LoRA dir.")
    p.add_argument("--dense-weights", type=str, required=True, help="Head checkpoint (.npz).")
    p.add_argument("--adapter-weights", type=str, required=True, help="Q-adapter checkpoint (.npz).")
    p.add_argument("--hf-checkpoint", type=str, default=None, help="Base encoder weights.")
    p.add_argument("--pretrained-encoder", type=str, default=None,
                   help="gwkit encoder pytree (.npz), e.g. the InfoNCE-pretrained encoder.")
    p.add_argument("--target-shape", type=int, nargs=2, default=[80, 3000],
                   help="Q-adapter output geometry; (80, 512) is the production "
                        "serving geometry, (80, 3000) reference parity.")
    p.add_argument("--encoder", type=str, default="tiny")
    p.add_argument("-t", "--trigger-threshold", type=float, default=-0.5)
    p.add_argument("--step-size", type=float, default=0.1)
    p.add_argument("--cluster-threshold", type=float, default=0.35)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--debug-triggers-file", type=str, default=None)
    p.add_argument("--debug-whitened-file", type=str, default=None)
    p.add_argument("--shard-dir", type=str, default=None,
                   help="Shared directory for the trigger gather of a search over several "
                        "processes (started with torchrun; gwkit_torch.parallel.distributed).")
    p.add_argument("--stream", type=int, choices=[0, 1], default=None,
                   help="Read segments one ahead while the card scores (1) or all up front (0). "
                        "Default: 1 when every dataset is contiguous, uncompressed f32/f64 and "
                        "the C++ reader builds (read ahead in a C++ thread), else 0.")
    p.add_argument("--int8", action="store_true",
                   help="int8 projections in every encoder layer (the card only; a no-op "
                        "with --cpu).")
    p.add_argument("--qscan-stream", action="store_true",
                   help="Experimental, not for production: streaming Q-scan front end for "
                        "segments longer than a whitening block. Each block of whitened strain "
                        "is Q-transformed once and windows crop their spectrograms from it. Not "
                        "the per-window transform: the two differ near window edges by design. "
                        "Slower than the per-window scan on an H100 (PERF.md section 7).")
    p.add_argument("--trace-dir", type=str, default=None,
                   help="Record the search in a torch.profiler trace under this directory "
                        "(the port's gw.* layer spans beside the device operations) and print the "
                        "port's counters over the search.")
    return parse_with_config(p, argv)


def _load_gwkit_encoder(path: str, size: str, enc_cfg: WhisperConfig) -> dict:
    """Load a gwkit encoder npz stored at any serving geometry and re-pin the
    sinusoidal ``pos`` table to ``enc_cfg.max_positions`` (exact: ``pos`` is
    deterministic). Returns gwkit's numpy tree."""
    template = param_shapes(enc_cfg)
    leaves = tree_leaves(template)
    pos_idx = [i for i, leaf in enumerate(leaves) if tuple(leaf) == (enc_cfg.max_positions, enc_cfg.d_model)]
    candidates = []
    if len(pos_idx) == 1:
        with np.load(path) as data:
            stored_len = int(data[f"leaf_{pos_idx[0]:05d}"].shape[0])
        candidates.append(dataclasses.replace(enc_cfg, max_positions=stored_len))
    params = None
    for cfg in candidates + [enc_cfg, config_for(size)]:
        try:
            params, _ = load_pytree_npz(path, param_shapes(cfg))
            break
        except ValueError:
            continue
    if params is None:
        raise ValueError(f"{path}: stored encoder geometry matches neither its own pos-table "
                         f"length, the serving config, nor the default ({size})")
    params["pos"] = sinusoid_positions(enc_cfg.max_positions, enc_cfg.d_model)
    return params


def load_task_from_components(
    lora_weights: str,
    dense_weights: str,
    adapter_weights: str,
    encoder: str = "tiny",
    hf_checkpoint: Optional[str] = None,
    usr: bool = True,
    seed: int = 42,
    pretrained_encoder: Optional[str] = None,
    target_shape: Tuple[int, int] = (80, 3000),
    quant_int8: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
) -> Task:
    """Assemble the MLGWSC-1 search task from exported component checkpoints.

    ``device=None`` is the CUDA card (raises without one). On CUDA the
    encoder runs in bf16 with tanh GELU and every layer on the kernel chain;
    on the CPU in f32 with erf GELU and the unfused layer math, as gwkit on a
    TPU and on the CPU. ``compute_dtype`` overrides (e.g. f32, to hold the
    bf16 search against it). ``quant_int8`` puts the projections of every
    layer on int8 on the card; on the CPU it does nothing and warns, as
    gwkit's ``quant_int8 and on_tpu``."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    n_frames = int(target_shape[1])
    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if on_card else torch.float32
    if quant_int8 and not on_card:
        logging.warning("int8 projections need the fused layer on the card; the CPU search runs "
                        "without them")
    enc_cfg = config_for(encoder, compute_dtype=compute_dtype, gelu_approx=on_card,
                         fused_block=on_card, quant_int8=quant_int8 and on_card,
                         max_positions=n_frames // 2)
    adapters, _ = import_peft_dir(lora_weights, n_layers=enc_cfg.n_layers)
    qcfg = QAdapterConfig(target_shape=(int(target_shape[0]), n_frames))
    head, _ = load_pytree_npz(dense_weights, mlp_head_shapes(
        enc_cfg.d_model * qcfg.n_detectors, HEAD_WIDTHS["gwwhisper"], 2))
    qadapter, _ = load_pytree_npz(adapter_weights, qadapter_shapes(qcfg))
    encoder_params = None
    if hf_checkpoint:
        _, encoder_params = load_hf_encoder(hf_checkpoint, size=encoder)
        # HF tables are 1500-row
        encoder_params["pos"] = sinusoid_positions(enc_cfg.max_positions, enc_cfg.d_model)
    elif pretrained_encoder:
        encoder_params = _load_gwkit_encoder(pretrained_encoder, encoder, enc_cfg)
    params = from_gwkit_numpy(encoder_params, adapters, head, qadapter)
    if encoder_params is None:
        params["encoder"] = init_encoder_params(enc_cfg, torch.Generator().manual_seed(seed))
    return build_mlgwsc(enc_cfg, qcfg, params, usr=usr, device=dev)


def _finite_scores(score_fn):
    def score(windows):
        s = score_fn(windows)
        if not torch.isfinite(s).all():
            raise FloatingPointError("non-finite window score")
        return s

    return score


def main(argv=None):
    from gwkit_torch.parallel.distributed import initialize, process_index
    from gwkit_torch.search.engine import get_triggers, write_search_output

    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    dump_config(args, args.outputfile)
    for path in (args.outputfile, args.debug_whitened_file, args.debug_triggers_file):
        check_file_existence(path if path else None, args.force)
        if path and args.force and os.path.isfile(path):
            os.remove(path)

    if "WORLD_SIZE" in os.environ:  # under torchrun: one process group over its ranks
        initialize(device="cpu" if args.cpu else None)
    t0 = time.time()
    task = load_task_from_components(
        args.lora_weights, args.dense_weights, args.adapter_weights,
        encoder=args.encoder, hf_checkpoint=args.hf_checkpoint, usr=not args.softmax,
        seed=args.seed, pretrained_encoder=args.pretrained_encoder,
        target_shape=tuple(args.target_shape), quant_int8=args.int8,
        device="cpu" if args.cpu else None,
    )
    if args.debug_nans:
        task.score = _finite_scores(task.score)
        task.score_spec = _finite_scores(task.score_spec)
    counted = dict(COUNTERS)
    with trace(args.trace_dir):
        triggers, all_vals, result = get_triggers(
            task, args.inputfile,
            step_size=args.step_size, trigger_threshold=args.trigger_threshold,
            white=args.white, whitened_file=args.debug_whitened_file,
            batch_size=args.batch_size, verbose=args.verbose,
            stream=None if args.stream is None else bool(args.stream),
            shard_dir=args.shard_dir, qscan_stream=args.qscan_stream,
        )
    if args.trace_dir is not None:
        print("Counters over the search: " + ", ".join(f"{k} {v - counted[k]}" for k, v in COUNTERS.items()))
    if process_index() != 0:  # every rank holds the merged triggers; rank 0 writes them
        return
    print(f"Total slices above threshold {args.trigger_threshold:.3f}: "
          f"{sum(len(v) for v in triggers.values())}")
    write_search_output(args.outputfile, triggers, all_vals,
                        cluster_threshold=args.cluster_threshold,
                        raw_triggers_path=args.debug_triggers_file)
    print(f"Throughput: {result.throughput_x_realtime:.1f}x realtime ({result.n_windows} windows)")
    print(f"Total execution time: {time.time() - t0:.2f} seconds")


if __name__ == "__main__":
    main()
