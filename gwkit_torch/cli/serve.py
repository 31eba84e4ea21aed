"""Resident scoring server CLI on the port (counterpart of
``gwkit/cli/serve.py``, ``gwkit-serve``): load the model once, then score any
number of strain files without paying the model load, the kernel libraries'
load or the encoder's folding again.

Server:  ``python -m gwkit_torch.cli.serve --socket /tmp/gw.sock
          --lora-weights DIR --dense-weights head.npz --adapter-weights qa.npz
          [--int8] [--warmup 272] [--cpu]``
Watch:   the same with ``--watch DIR [--watch-output DIR]`` instead of a socket
Client:  ``python -m gwkit_torch.cli.serve --socket /tmp/gw.sock --score in.hdf out.hdf``
         ``python -m gwkit_torch.cli.serve --socket /tmp/gw.sock --ping`` / ``--shutdown``

Server and watch modes run on the CUDA card unless ``--cpu`` is given
(see :mod:`gwkit_torch.cli.inference`); client mode only sends JSON and
never touches the card. The protocol is in :mod:`gwkit_torch.serve`.
"""
from __future__ import annotations

import json
import sys
from argparse import ArgumentParser

from gwkit_torch.cli.common import add_common_args, configure_logging, parse_with_config


def parse_args(argv=None):
    p = ArgumentParser(description="Resident continuous-search scoring server / client.")
    add_common_args(p)
    p.add_argument("--socket", type=str, default=None,
                   help="Unix socket path (required except in --watch mode).")
    # server mode
    p.add_argument("--lora-weights", type=str, default=None, help="peft-compatible LoRA dir.")
    p.add_argument("--dense-weights", type=str, default=None, help="Head checkpoint (.npz).")
    p.add_argument("--adapter-weights", type=str, default=None, help="Q-adapter checkpoint (.npz).")
    p.add_argument("--hf-checkpoint", type=str, default=None, help="Base encoder weights.")
    p.add_argument("--pretrained-encoder", type=str, default=None,
                   help="gwkit encoder pytree (.npz), e.g. InfoNCE-pretrained.")
    p.add_argument("--target-shape", type=int, nargs=2, default=[80, 3000],
                   help="Q-adapter output geometry; (80, 512) is the production "
                        "serving geometry, (80, 3000) reference parity.")
    p.add_argument("--encoder", type=str, default="tiny")
    p.add_argument("--softmax", action="store_true", help="Softmax scores (default USR logits).")
    p.add_argument("--int8", action="store_true",
                   help="int8 projections in every encoder layer (the card only; a no-op "
                        "with --cpu).")
    p.add_argument("--warmup", type=float, default=0.0,
                   help="Run the request path on this many seconds of synthetic strain "
                        "before accepting requests (>256 s also runs the blocked "
                        "whitening, e.g. 272).")
    p.add_argument("--watch", type=str, default=None,
                   help="Online mode: poll this directory and score every new .hdf strain "
                        "file into <stem>_events.hdf (instead of listening on the socket).")
    p.add_argument("--watch-output", type=str, default=None,
                   help="Output directory for --watch (default: the watch dir).")
    p.add_argument("--watch-poll", type=float, default=2.0, help="--watch poll interval in seconds.")
    p.add_argument("-t", "--trigger-threshold", type=float, default=-0.5)
    p.add_argument("--step-size", type=float, default=0.1)
    p.add_argument("--cluster-threshold", type=float, default=0.35)
    p.add_argument("--batch-size", type=int, default=256)
    # client mode
    p.add_argument("--score", nargs=2, metavar=("INPUT", "OUTPUT"), default=None,
                   help="Client: score INPUT into OUTPUT via a running server.")
    p.add_argument("--white", action="store_true", help="Client: input is already whitened.")
    p.add_argument("--ping", action="store_true", help="Client: health-check a running server.")
    p.add_argument("--shutdown", action="store_true", help="Client: stop a running server.")
    return parse_with_config(p, argv)


def main(argv=None):
    from gwkit_torch.serve import ScoringServer, request, watch_directory

    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    if not args.socket and not args.watch:
        raise SystemExit("--socket is required except in --watch mode")
    if args.ping or args.shutdown or args.score:
        if args.ping:
            req = {"cmd": "ping"}
        elif args.shutdown:
            req = {"cmd": "shutdown"}
        else:
            req = {
                "input": args.score[0], "output": args.score[1],
                "trigger_threshold": args.trigger_threshold,
                "step_size": args.step_size,
                "cluster_threshold": args.cluster_threshold,
                "batch_size": args.batch_size,
                "white": args.white, "force": args.force,
            }
        resp = request(args.socket, req)
        print(json.dumps(resp))
        sys.exit(0 if resp.get("ok") else 1)

    for flag in ("lora_weights", "dense_weights", "adapter_weights"):
        if not getattr(args, flag):
            raise SystemExit(f"server mode requires --{flag.replace('_', '-')}")
    from gwkit_torch.cli.inference import load_task_from_components

    task = load_task_from_components(
        args.lora_weights, args.dense_weights, args.adapter_weights,
        encoder=args.encoder, hf_checkpoint=args.hf_checkpoint,
        usr=not args.softmax, seed=args.seed,
        pretrained_encoder=args.pretrained_encoder,
        target_shape=tuple(args.target_shape), quant_int8=args.int8,
        device="cpu" if args.cpu else None,
    )
    server = ScoringServer(
        task, args.socket,
        trigger_threshold=args.trigger_threshold, step_size=args.step_size,
        cluster_threshold=args.cluster_threshold, batch_size=args.batch_size,
    )
    if args.warmup > 0:
        print(f"warmup: {server.warmup(args.warmup):.1f}s", flush=True)
    if args.watch:
        print(f"watching {args.watch}", flush=True)
        watch_directory(server, args.watch, output_dir=args.watch_output, poll_seconds=args.watch_poll)
        return
    server.bind()
    print(f"serving on {args.socket}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
