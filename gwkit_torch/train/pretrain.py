"""InfoNCE contrastive pretraining of the Q-adapter and the adapters
(counterpart of ``gwkit/train/pretrain.py``).

AdamW over every non-head trainable of the task (Q-adapter, DoRA adapters)
plus a two-layer projection head, a fixed number of steps, temperature
0.1, pairs drawn as the reference's PretrainDataset draws them. The
optimizer is gwkit's ``optax.adamw(lr)``: optax's default weight decay of
1e-4 (not torch's 1e-2) and no clipping. The encoder's base weights stay
frozen unless ``train_full_encoder``. The weights go back into the task at
the end and are saved as ``q_adapter_pretrained.npz`` and
``adapters_pretrained.npz`` (and ``encoder_pretrained.npz``) in gwkit's
format.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from gwkit_torch.io import to_gwkit_numpy, tree_leaves
from gwkit_torch.models.heads import init_mlp_head, mlp_head_apply
from gwkit_torch.train.checkpoints import save_pytree
from gwkit_torch.train.losses import info_nce
from gwkit_torch.train.trainer import Adam
from gwkit_torch.data.datasets import sample_pretrain_pairs

ADAMW_DEFAULT_WEIGHT_DECAY = 1e-4  # optax.adamw's default


class ContrastivePretrainer:
    def __init__(self, task, proj_dim: int = 256, lr: float = 1e-4, temperature: float = 0.1,
                 train_full_encoder: bool = False, seed: int = 0):
        self.task = task
        self.temp = temperature
        d = task.cfg.encoder.d_model * task.cfg.n_detectors
        proj = init_mlp_head(d, (proj_dim,), proj_dim, torch.Generator().manual_seed(seed))
        trainable = {k: v for k, v in task.trainable.items() if k != "head"}
        trainable["proj"] = [{k: t.to(task.device) for k, t in p.items()} for p in proj]
        frozen = dict(task.frozen)
        if train_full_encoder and "encoder" in frozen:
            trainable["encoder"] = frozen.pop("encoder")
        self.trainable, self.frozen = trainable, frozen
        self.optimizer = Adam(lr, weight_decay=ADAMW_DEFAULT_WEIGHT_DECAY)
        self._set_params()

    def _set_params(self) -> None:
        self.params = tree_leaves(self.trainable)
        for p in self.params:
            p.requires_grad_(True)
        self.opt_state = self.optimizer.init(self.params)

    def loss(self, trainable: dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        z1 = mlp_head_apply(trainable["proj"], self.task.embed(trainable, self.frozen, x1))
        z2 = mlp_head_apply(trainable["proj"], self.task.embed(trainable, self.frozen, x2))
        return info_nce(z1, z2, temperature=self.temp)

    def step(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """One AdamW step on a pair batch; returns the loss (on the device)."""
        loss = self.loss(self.trainable, x1, x2)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        self.opt_state = self.optimizer.update(self.params, grads, self.opt_state)
        return loss.detach()

    def train(self, noises, waveforms, steps: int = 60_000, batch_size: int = 128,
              snr_range: Tuple[float, float] = (5.0, 15.0), noise_only_prob: float = 0.25,
              outdir: Optional[str] = None, seed: int = 0, log_every: int = 100) -> None:
        """The fixed-step InfoNCE loop; writes the weights back into the task."""
        dev = self.task.device
        as_dev = lambda a: (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))).float().to(dev)
        noises, waveforms = as_dev(noises), as_dev(waveforms)
        gen = torch.Generator().manual_seed(seed)
        t0 = time.time()
        for it in range(steps):
            idx = torch.randint(0, waveforms.shape[0], (batch_size,), generator=gen)
            x1, x2 = sample_pretrain_pairs(gen, noises, waveforms, idx, snr_range, noise_only_prob)
            loss = self.step(x1, x2)
            if log_every and (it % log_every == 0 or it == steps - 1):
                logging.info("pretrain step %d/%d loss %.4f (%.1fs)", it, steps, float(loss), time.time() - t0)
        for k in self.task.trainable:
            if k in self.trainable:
                self.task.trainable[k] = self.trainable[k]
        if "encoder" in self.trainable:
            self.task.frozen["encoder"] = self.trainable["encoder"]
        if outdir:
            os.makedirs(outdir, exist_ok=True)
            gw = to_gwkit_numpy(**{k: v for k, v in self.trainable.items() if k != "proj"})
            for key, name in (("qadapter", "q_adapter_pretrained.npz"), ("adapters", "adapters_pretrained.npz"),
                              ("encoder", "encoder_pretrained.npz")):
                if key in gw:
                    save_pytree(os.path.join(outdir, name), gw[key])
            logging.info("Saved pretraining weights.")
