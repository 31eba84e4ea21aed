"""Several processes on ``torch.distributed``: initialization and the
cross-process trigger gather (counterpart of ``gwkit/parallel/distributed.py``).

* training: :func:`initialize`, then one ``("data", "model")`` mesh over
  every rank (``gwkit_torch.parallel.mesh``); the trainer's collectives are
  explicit calls on the mesh's groups.
* search: segments are sharded across processes at the key level
  (:func:`host_key_filter`, before any dataset is read); each process scores
  its share and :func:`gather_trigger_lists` merges the per-segment trigger
  lists through a shared directory, in gwkit's ``triggers_{pid}.npz``
  layout, so either package merges the other's shards.

Backends: NCCL for the CUDA card, gloo for ``device="cpu"``. Nothing of this
module initializes anything at import.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gwkit_torch.device import DeviceLike, resolve_device


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: DeviceLike = None) -> None:
    """``torch.distributed.init_process_group`` for this process.

    Like every entry point of the port it raises without a card unless
    ``device="cpu"``. Then it does nothing for one process with no
    coordinator, as gwkit's. With no arguments under ``torchrun`` the world
    size, rank and address come from ``WORLD_SIZE``, ``RANK`` and
    ``MASTER_ADDR``/``MASTER_PORT``.
    ``coordinator_address`` is ``host:port``. ``device=None`` is the CUDA
    card (NCCL; this rank's card is ``LOCAL_RANK``'s, set before the group
    starts, so the ranks of one host do not all land on card 0); ``"cpu"``
    is gloo."""
    dev = resolve_device(device)
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes in (None, 1) and coordinator_address is None:
        logging.info("single-process run: skipping torch.distributed.init_process_group")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize: give coordinator_address, num_processes and process_id "
                         "(or start under torchrun)")
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", dev.index or 0)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    logging.info("distributed: process %d/%d (%s)", dist.get_rank(), dist.get_world_size(), backend)


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_key_filter(process_id: int, num_processes: int):
    """(index, key) -> bool round-robin predicate for sharding the segments
    at the key level: passed to ``read_segments``/``stream_segments`` so each
    process opens only its share (the longest-first order keeps the shares
    balanced)."""
    return lambda i, key: i % num_processes == process_id


def shard_segments_across_hosts(segments: Sequence, process_id: int, num_processes: int) -> List:
    """Round-robin share of an already read segment list (prefer
    :func:`host_key_filter` for a file, which shards before any read)."""
    keep = host_key_filter(process_id, num_processes)
    return [seg for i, seg in enumerate(segments) if keep(i, getattr(seg, "key", None))]


def write_trigger_shard(local_triggers: Dict[str, list], shard_dir: str, process_id: int) -> str:
    """One process's per-segment trigger lists as (time, stat) float64 rows
    in ``shard_dir/triggers_{process_id}.npz``."""
    os.makedirs(shard_dir, exist_ok=True)
    path = os.path.join(shard_dir, f"triggers_{process_id}.npz")
    np.savez(path, **{key: np.asarray(v, dtype=np.float64).reshape(-1, 2)
                      for key, v in local_triggers.items()})
    return path


def merge_trigger_shards(shard_dir: str, num_processes: int) -> Dict[str, list]:
    """Every process's shard merged into one segment -> list dict, sorted by
    key (the keys are disjoint across processes, so this is a union)."""
    merged: Dict[str, list] = {}
    for p in range(num_processes):
        with np.load(os.path.join(shard_dir, f"triggers_{p}.npz")) as data:
            for key in data.files:
                merged[key] = data[key].tolist()
    return dict(sorted(merged.items()))


def gather_trigger_lists(local_triggers: Dict[str, list],
                         shard_dir: Optional[str] = None) -> Dict[str, list]:
    """Merge the per-segment trigger lists of every process: each writes its
    shard to ``shard_dir`` (a shared filesystem path), a barrier syncs, and
    every process reads all shards back. One process: the identity."""
    if process_count() == 1:
        return local_triggers
    if shard_dir is None:
        raise ValueError("gather_trigger_lists: a search over several processes needs a shared shard_dir")
    write_trigger_shard(local_triggers, shard_dir, process_index())
    dist.barrier()
    return merge_trigger_shards(shard_dir, process_count())
