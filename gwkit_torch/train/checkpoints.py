"""Checkpoints in gwkit's format (counterpart of ``gwkit/train/checkpoints.py``).

A checkpoint is gwkit's flattened-pytree npz: ``leaf_%05d`` arrays in jax's
flattening order (dict keys sorted, lists in order) and a ``__meta__`` JSON
entry. The port writes its parameters as gwkit's trees
(:func:`gwkit_torch.io.to_gwkit_numpy`: stacked layers and adapters), and
the optimizer state as optax lays out ``chain(clip_by_global_norm,
adam|adamw)``: the Adam count, then mu, then nu (each shaped like the
trainable tree), then the schedule's count when the learning rate is a
schedule. So gwkit's ``CheckpointManager.resume`` loads a port checkpoint
and the port loads gwkit's.

Every epoch writes ``last.ckpt`` ({"opt_state", "trainable"}) and
``state_e_%04d.npz``; a new best writes ``best.npz`` and the exported
components. Resume 'latest' restores parameters and optimizer state, 'best'
the parameters only.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from gwkit_torch.io import from_gwkit_numpy, load_pytree_npz, to_gwkit_numpy, tree_leaves, tree_to


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Write ``tree`` (tensors or arrays) as gwkit's flattened npz, atomically."""
    arrays = {f"leaf_{i:05d}": _array(leaf) for i, leaf in enumerate(tree_leaves(tree))}
    if meta:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_pytree(path: str, like: Any) -> Tuple[Any, dict]:
    """Load into the structure of ``like`` (shapes checked): (numpy tree, meta)."""
    return load_pytree_npz(path, like)


def to_gwkit_tree(trainable: dict) -> dict:
    """A port trainable tree as gwkit's (numpy)."""
    return to_gwkit_numpy(**trainable)


def from_gwkit_tree(tree: dict, device: torch.device) -> dict:
    """gwkit's (numpy) trainable tree as the port's, on ``device``."""
    return tree_to(from_gwkit_numpy(**tree), device)


class CheckpointManager:
    """last/best/per-epoch checkpoints, component export and resume.

    ``optimizer`` converts its state to and from optax's layout
    (:class:`gwkit_torch.train.trainer.Adam`)."""

    def __init__(self, outdir: str, optimizer, export_components: Optional[Callable] = None):
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.optimizer = optimizer
        self.export_components = export_components  # callable(outdir, trainable)

    def path(self, name: str) -> str:
        return os.path.join(self.outdir, name)

    def save_epoch(self, epoch: int, best_val: float, trainable: dict, opt_state, is_best: bool) -> None:
        meta = {"epoch": epoch, "best_val_loss": float(best_val)}
        gw = to_gwkit_tree(trainable)
        save_pytree(self.path("last.ckpt"),
                    {"trainable": gw, "opt_state": self.optimizer.state_to_gwkit(opt_state, trainable)}, meta)
        save_pytree(self.path(f"state_e_{epoch:04d}.npz"), gw, meta)
        if is_best:
            save_pytree(self.path("best.npz"), gw, meta)
            if self.export_components is not None:
                self.export_components(self.outdir, trainable)

    def resume(self, which: str, trainable: dict, opt_state):
        """'latest' restores trainable and optimizer; 'best' the trainable
        only. Returns (start_epoch, best_val, trainable, opt_state)."""
        device = tree_leaves(trainable)[0].device
        if which == "best":
            path = self.path("best.npz")
            if not os.path.isfile(path):
                return 1, float("inf"), trainable, opt_state
            loaded, _ = load_pytree(path, to_gwkit_tree(trainable))
            return 1, float("inf"), from_gwkit_tree(loaded, device), opt_state
        path = self.path("last.ckpt")
        if not os.path.isfile(path):
            return 1, float("inf"), trainable, opt_state
        like = {"trainable": to_gwkit_tree(trainable),
                "opt_state": self.optimizer.state_to_gwkit(opt_state, trainable)}
        loaded, meta = load_pytree(path, like)
        trainable = from_gwkit_tree(loaded["trainable"], device)
        return (int(meta.get("epoch", 0)) + 1, float(meta.get("best_val_loss", float("inf"))),
                trainable, self.optimizer.state_from_gwkit(loaded["opt_state"], trainable))
