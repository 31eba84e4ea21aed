"""Supervised training harness (counterpart of ``gwkit/train/trainer.py``).

Lifecycle as gwkit's: only the trainable tree (adapters, head, Q-adapter)
is optimized, the frozen one (the encoder) never is; Adam or AdamW behind
global-norm clipping (clip 100); per-epoch train and validation loss in
``losses.txt`` as ``"%04d\\t%.6f\\t%.6f"``; ``train_config.json``;
last/best/per-epoch checkpoints in gwkit's format, resume latest|best;
early stopping; a wall-clock budget; the curriculum scheduler hook and
the optimizer reset a curriculum step may ask for; an
``eval_callback`` on each epoch's validation outputs and a
``metrics_callback`` for each epoch's metrics.

The optimizer is optax's arithmetic, not torch's: clipping scales by
max_norm / ||g|| only when ||g|| >= max_norm (torch's ``clip_grad_norm_``
adds 1e-6 to the norm and scales always); Adam with eps 1e-8 and eps_root
0 and optax's bias correction; AdamW's weight decay is added to the Adam
direction before the learning rate (decoupled); the cosine schedule is
optax's ``warmup_cosine_decay_schedule`` as gwkit's ``make_optimizer``
builds it. The state converts to optax's layout for the checkpoints.

Steps run eagerly; the losses of an epoch stay on the device until it ends
(one synchronization per epoch, as gwkit's ``run_epoch``).

With a mesh (``gwkit_torch.parallel.mesh``) the trainable and frozen trees
are laid out as gwkit lays them out (Megatron encoder, adapters following
their base projections, the rest replicated) as this rank's local slices;
each step takes this rank's rows of the global batch over "data", runs the
loss inside ``active(mesh)``, and averages the loss and every gradient over
"data" in one flattened all_reduce. The global-norm clip sums the squared
norms of model-sharded leaves over "model" and counts replicated leaves
once. Checkpoints and exports hold full leaves (:func:`gather_tree`),
written by rank 0 while the others wait at a barrier.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Callable, Iterable, List, Optional, Union

import numpy as np
import torch

from gwkit_torch.io import tree_leaves, tree_unflatten
from gwkit_torch.parallel.mesh import (MODEL_AXIS, Mesh, active, batch_sharding, data_mean_, gather_rows,
                                       gather_tree, model_sum_, shard_task_tree, shard_tree, spec_leaves,
                                       task_shardings)
from gwkit_torch.train.checkpoints import CheckpointManager, from_gwkit_tree, to_gwkit_tree
from gwkit_torch.train.curriculum import CurriculumScheduler


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 5e-5
    clip_norm: float = 100.0
    epochs: int = 100
    batch_size: int = 128
    early_stop_patience: int = 10
    seed: int = 42
    optimizer: str = "adam"  # "adam" (MLGWSC-1) | "adamw" (Signal_vs_Noise)
    weight_decay: float = 0.01
    lr_schedule: str = "constant"  # or "cosine": linear warmup, cosine decay to lr/30
    warmup_steps: int = 500
    total_steps: int = 0  # required when lr_schedule != "constant"
    time_budget_s: float = 0.0  # stop after the first epoch past this wall clock (0: none)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float) -> Callable[[int], np.float32]:
    """optax's schedule of the same name (exponent 1), in float32 as optax
    evaluates it: linear from init to peak over ``warmup_steps``, then a
    cosine from peak to ``end_value`` over the remaining steps."""
    f = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def linear(count):
        frac = f(1) - f(min(max(count, 0), warmup_steps)) / f(warmup_steps)
        return f(init_value - peak_value) * frac + f(peak_value)

    def cosine(count):
        count = min(f(count), f(decay_steps - warmup_steps))
        decay = f(0.5) * (f(1) + np.cos(f(np.pi) * count / f(decay_steps - warmup_steps)))
        return f(peak_value) * (f(1 - alpha) * decay + f(alpha))

    def schedule(count: int) -> np.float32:
        if warmup_steps <= 0:
            return cosine(count)
        return linear(count) if count < warmup_steps else cosine(count - warmup_steps)

    return schedule


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    schedule_count: Optional[int] = None  # optax's ScaleByScheduleState (a schedule only)


class Adam:
    """``optax.chain(clip_by_global_norm(clip_norm), adam|adamw(lr))`` with
    optax's arithmetic on a flat list of parameters, updated in place.
    ``weight_decay=None`` is Adam; a float is AdamW. ``learning_rate`` is a
    float or a schedule (step count -> rate)."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax's defaults, as gwkit uses them

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 weight_decay: Optional[float] = None, clip_norm: float = 0.0):
        self.lr, self.weight_decay, self.clip_norm = learning_rate, weight_decay, clip_norm

    def init(self, params: List[torch.Tensor]) -> AdamState:
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in params]
        return AdamState(0, zeros(), zeros(), 0 if callable(self.lr) else None)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: AdamState,
               g_norm: Optional[torch.Tensor] = None) -> AdamState:
        """One step in place; no host synchronization (the clip decision
        stays on the device). ``g_norm``: the gradients' global norm where
        the caller computes it (a model mesh), else computed here."""
        if self.clip_norm and self.clip_norm > 0:
            if g_norm is None:
                g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.clip_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.clip_norm) for g in grads]
        count = state.count + 1
        dev = params[0].device
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = (1 - f32(self.b1) ** count).to(dev)
        bc2 = (1 - f32(self.b2) ** count).to(dev)
        if callable(self.lr):
            step = f32(-float(self.lr(state.schedule_count))).to(dev)
            schedule_count = state.schedule_count + 1
        else:
            step, schedule_count = f32(-self.lr).to(dev), None
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m.mul_(self.b1).add_((1 - self.b1) * g)  # (1 - b1) g + b1 m, as optax
            v.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay is not None:
                u = u + self.weight_decay * p
            p.add_(step * u)
        return AdamState(count, state.mu, state.nu, schedule_count)

    # -- optax's layout of the state, for gwkit's checkpoints ----------------
    def state_to_gwkit(self, state: AdamState, trainable: dict) -> list:
        tree = [np.int32(state.count), to_gwkit_tree(tree_unflatten(trainable, state.mu)),
                to_gwkit_tree(tree_unflatten(trainable, state.nu))]
        return tree + ([np.int32(state.schedule_count)] if state.schedule_count is not None else [])

    def state_from_gwkit(self, tree: list, trainable: dict) -> AdamState:
        device = tree_leaves(trainable)[0].device
        leaves = lambda t: tree_leaves(from_gwkit_tree(t, device))
        return AdamState(int(tree[0]), leaves(tree[1]), leaves(tree[2]),
                         int(tree[3]) if len(tree) > 3 else None)


def make_optimizer(cfg: TrainConfig) -> Adam:
    """gwkit's ``make_optimizer``: Adam or AdamW at a constant rate or on
    the warmup-cosine schedule, behind clipping when ``clip_norm`` > 0."""
    if cfg.lr_schedule == "constant":
        lr: Union[float, Callable] = cfg.learning_rate
    elif cfg.lr_schedule == "cosine":
        if cfg.total_steps <= 0:
            raise ValueError("cosine lr_schedule needs cfg.total_steps > 0")
        lr = warmup_cosine_decay_schedule(
            init_value=cfg.learning_rate / 25.0, peak_value=cfg.learning_rate,
            warmup_steps=min(cfg.warmup_steps, max(cfg.total_steps // 10, 1)),
            decay_steps=cfg.total_steps, end_value=cfg.learning_rate / 30.0)
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    return Adam(lr, weight_decay=cfg.weight_decay if cfg.optimizer == "adamw" else None,
                clip_norm=cfg.clip_norm if cfg.clip_norm and cfg.clip_norm > 0 else 0.0)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def _gather_aux(tree, mesh: Mesh):
    if isinstance(tree, dict):
        return {k: _gather_aux(v, mesh) for k, v in tree.items()}
    return gather_rows(tree, mesh) if isinstance(tree, torch.Tensor) and tree.dim() else tree


def _child(generator: torch.Generator) -> torch.Generator:
    """A new generator seeded from ``generator`` (the counterpart of a key split)."""
    return torch.Generator().manual_seed(int(torch.randint(0, 2 ** 62, (1,), generator=generator)))


class Trainer:
    """Generic supervised trainer.

    ``loss_fn(trainable, frozen, batch, generator) -> (loss, aux)`` defines
    the workload (``generator=None``: evaluation, no dropout); ``batch`` is
    whatever the dataset yields, already on the device."""

    def __init__(self, loss_fn: Callable, trainable: dict, frozen: dict,
                 cfg: TrainConfig = TrainConfig(), export_components: Optional[Callable] = None,
                 metrics_callback: Optional[Callable[[int, dict], None]] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.mesh = mesh
        if mesh is not None:
            self._specs = task_shardings(trainable)
            devices = {t.device for t in tree_leaves([trainable, frozen])}
            if devices != {mesh.device}:
                raise ValueError(f"Trainer: the mesh holds its buffers on {mesh.device}, the "
                                 f"parameters lie on {sorted(map(str, devices))}")
            trainable, frozen = shard_task_tree(mesh, trainable), shard_task_tree(mesh, frozen)
            # leaves whose squared norms sum over "model" in the global-norm clip
            self._model_split = [MODEL_AXIS in spec and mesh.n_model > 1 for spec in spec_leaves(self._specs)]
        self.frozen = frozen
        self.optimizer = make_optimizer(cfg)
        self._set_trainable(trainable)
        self.opt_state = self.optimizer.init(self.params)
        self.export_components = export_components
        self.metrics_callback = metrics_callback  # (epoch, {"train_loss": ..., ...}) -> None

    def _set_trainable(self, trainable: dict) -> None:
        self.trainable = trainable
        self.params = tree_leaves(trainable)
        for p in self.params:
            p.requires_grad_(True)

    def _local(self, batch):
        """This rank's rows of a global batch (the batch itself without a mesh)."""
        if self.mesh is None:
            return batch
        return shard_tree(self.mesh, batch, batch_sharding(batch))

    def _gradients(self, batch, generator: Optional[torch.Generator] = None):
        """(loss, aux, gradients, global norm or None) of one step: with a
        mesh the loss and gradients averaged over "data" and the norm over
        the whole tree (None: the optimizer computes it)."""
        with active(self.mesh):
            loss, aux = self.loss_fn(self.trainable, self.frozen, self._local(batch), generator)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        loss, g_norm = loss.detach(), None
        if self.mesh is not None:
            loss, grads = self._data_mean([loss, *grads])
            g_norm = self._global_norm(grads)
        return loss, aux, grads, g_norm

    def train_step(self, batch, generator: Optional[torch.Generator] = None):
        loss, aux, grads, g_norm = self._gradients(batch, generator)
        self.opt_state = self.optimizer.update(self.params, grads, self.opt_state, g_norm)
        return loss, aux

    @torch.no_grad()
    def eval_step(self, batch):
        with active(self.mesh):
            return self.loss_fn(self.trainable, self.frozen, self._local(batch), None)

    def _data_mean(self, tensors: List[torch.Tensor]):
        """(first, rest) of ``tensors`` averaged over "data" in one flattened all_reduce."""
        flat = data_mean_(torch.cat([t.reshape(-1).float() for t in tensors]), self.mesh)
        out = [chunk.view_as(t).to(t.dtype) for chunk, t in zip(flat.split([t.numel() for t in tensors]), tensors)]
        return out[0], out[1:]

    def _global_norm(self, grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
        """optax's global norm over the whole tree: model-sharded leaves' squared
        norms summed over "model", replicated leaves counted once (None on a
        mesh without model sharding: the optimizer's own computation)."""
        if not any(self._model_split):
            return None
        sq = [torch.sum(g * g) for g in grads]
        split = [i for i, s in enumerate(self._model_split) if s]
        summed = model_sum_(torch.stack([sq[i] for i in split]), self.mesh)
        for i, v in zip(split, summed):
            sq[i] = v
        return torch.sqrt(sum(sq))

    def run_epoch(self, batches: Iterable, generator: Optional[torch.Generator] = None,
                  train: bool = True):
        """(mean loss, list of aux); the losses stay on the device until the
        end. With a mesh the aux rows are gathered over "data" at the end, so
        each aux holds the global batch."""
        losses, auxes = [], []
        for batch in batches:
            loss, aux = self.train_step(batch, generator) if train else self.eval_step(batch)
            losses.append(loss)
            auxes.append(aux)
        if not losses:
            return 0.0, []
        losses = torch.stack(losses)
        if self.mesh is not None:
            if not train:  # a training step's loss is averaged with its gradients
                losses = data_mean_(losses, self.mesh)
            auxes = [_gather_aux(a, self.mesh) for a in auxes]
        total = float(losses.sum())
        return total / len(losses), [_to_host(a) for a in auxes]

    def fit(self, train_batches: Callable[[torch.Generator], Iterable],
            valid_batches: Callable[[torch.Generator], Iterable], outdir: str,
            resume: Optional[str] = None, force: bool = False,
            scheduler: Optional[CurriculumScheduler] = None,
            eval_callback: Optional[Callable[[int, dict, list], Optional[dict]]] = None) -> float:
        """Full training lifecycle. ``train_batches(generator)`` yields one
        epoch of device batches. After each epoch ``eval_callback(epoch,
        trainable, validation aux list)`` may return more metrics; the
        epoch's metrics then go to the ``metrics_callback``. Returns the
        best validation loss."""
        cfg = self.cfg
        writer = self.mesh is None or self.mesh.rank == 0  # the rank that writes files
        os.makedirs(outdir, exist_ok=True)
        losses_path = os.path.join(outdir, "losses.txt")
        if os.path.isfile(losses_path) and not (force or resume):
            raise RuntimeError(f"Output file exists: {losses_path}")
        if self.mesh is not None:
            self.mesh.barrier()  # every rank has looked before rank 0 writes
        if writer:
            with open(os.path.join(outdir, "train_config.json"), "w") as cf:
                json.dump(dataclasses.asdict(cfg), cf, indent=2, default=str)

        ckpt = CheckpointManager(outdir, self.optimizer, export_components=self.export_components)
        start_epoch, best_val = 1, float("inf")
        if resume:
            start_epoch, best_val, trainable, opt_state = ckpt.resume(resume, *self._full_state())
            self._set_state(trainable, opt_state)
            logging.info("Resumed (%s) at epoch %d, best_val=%.6e", resume, start_epoch, best_val)

        gen = torch.Generator().manual_seed(cfg.seed)
        patience = 0
        fit_t0 = time.time()
        with (open(losses_path, "a", buffering=1) if writer else contextlib.nullcontext()) as f:
            for epoch in range(start_epoch, cfg.epochs + 1):
                g_train, g_valid = _child(gen), _child(gen)
                t0 = time.time()
                train_loss, _ = self.run_epoch(train_batches(g_train), g_train, train=True)
                val_loss, val_aux = self.run_epoch(valid_batches(g_valid), g_valid, train=False)
                dt = time.time() - t0
                if writer:
                    f.write(f"{epoch:04d}\t{train_loss:.6f}\t{val_loss:.6f}\n")
                logging.info("epoch %04d train %.6f valid %.6f (%.1fs)", epoch, train_loss, val_loss, dt)
                metrics = {"train_loss": train_loss, "val_loss": val_loss, "epoch_seconds": dt}
                trainable, opt_state = self._full_state()
                if eval_callback is not None:
                    metrics.update(eval_callback(epoch, trainable, val_aux) or {})
                if self.metrics_callback is not None:
                    self.metrics_callback(epoch, metrics)

                is_best = val_loss < best_val
                if is_best:
                    best_val = val_loss
                    patience = 0
                    logging.info("New best @ epoch %04d — val_loss=%.6e", epoch, val_loss)
                else:
                    patience += 1
                if writer:
                    ckpt.save_epoch(epoch, best_val, trainable, opt_state, is_best)
                if self.mesh is not None:
                    self.mesh.barrier()

                if scheduler is not None:
                    scheduler.step(val_loss)
                    if scheduler.interrupt:
                        logging.info("Curriculum scheduler interrupt at epoch %04d.", epoch)
                        break
                if patience >= cfg.early_stop_patience:
                    logging.info("Early stopping (patience %d) at epoch %04d.", cfg.early_stop_patience, epoch)
                    break
                if cfg.time_budget_s and time.time() - fit_t0 >= cfg.time_budget_s:
                    logging.info("Wall-clock budget %.0fs reached at epoch %04d (%.0fs).",
                                 cfg.time_budget_s, epoch, time.time() - fit_t0)
                    break
        logging.info("Training complete. Best validation loss: %.6f", best_val)
        return best_val

    def _full_state(self):
        """(trainable, optimizer state) with full leaves: gathered over the
        mesh, or the trainer's own without one."""
        if self.mesh is None:
            return self.trainable, self.opt_state
        full = lambda leaves: tree_leaves(gather_tree(self.mesh, tree_unflatten(self.trainable, leaves),
                                                      self._specs))
        st = self.opt_state
        return (gather_tree(self.mesh, self.trainable, self._specs),
                AdamState(st.count, full(st.mu), full(st.nu), st.schedule_count))

    def _set_state(self, trainable: dict, opt_state: AdamState) -> None:
        """Install full-leaved trainables and optimizer state (this rank's
        slices of them on a mesh)."""
        if self.mesh is not None:
            local = lambda leaves: tree_leaves(shard_tree(self.mesh, tree_unflatten(trainable, leaves),
                                                          self._specs))
            opt_state = AdamState(opt_state.count, local(opt_state.mu), local(opt_state.nu),
                                  opt_state.schedule_count)
            trainable = shard_tree(self.mesh, trainable, self._specs)
        self._set_trainable(trainable)
        self.opt_state = opt_state

    def reset_optimizer(self) -> None:
        """A fresh optimizer state for the current trainables (a curriculum
        step's reset): zero moments and step count 0, so Adam's bias
        correction starts again, as optax's ``init``."""
        self.opt_state = self.optimizer.init(self.params)
