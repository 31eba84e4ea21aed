"""Losses (counterpart of ``gwkit/train/losses.py``).

* :func:`reg_bce` — BCE over probabilities mapped to (eps, 1 - eps*dim), so
  log(0) never occurs (the MLGWSC-1 training loss).
* :func:`bce_with_logits` — stable binary cross entropy on logits.
* :func:`cross_entropy` — softmax cross entropy with integer labels.
* :func:`info_nce` — InfoNCE over two views with in-batch negatives, the
  diagonal masked out of the denominators.
All reduce by the mean.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def reg_bce(probs: torch.Tensor, targets: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """Regularized BCE on probabilities; ``targets`` one-hot, same shape."""
    dim = probs.shape[-1]
    x = epsilon + (1.0 - epsilon * dim) * probs
    return -torch.mean(targets * torch.log(x) + (1.0 - targets) * torch.log1p(-x))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits = logits.reshape(targets.shape)
    loss = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return torch.mean(loss)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def info_nce(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """loss = mean_i [-log(pos_i / denom1_i) - log(pos_i / denom2_i)] over
    the similarities of the 2B-stack of normalized views."""
    z1 = z1 / torch.linalg.norm(z1, dim=1, keepdim=True).clamp_min(1e-12)
    z2 = z2 / torch.linalg.norm(z2, dim=1, keepdim=True).clamp_min(1e-12)
    b = z1.shape[0]
    z = torch.cat([z1, z2], dim=0)
    sim = (z @ z.T) / temperature
    mask = 1.0 - torch.eye(2 * b, dtype=sim.dtype, device=sim.device)
    exp_sim = torch.exp(sim) * mask
    pos = torch.exp(torch.sum(z1 * z2, dim=1) / temperature)
    loss = -torch.log(pos / exp_sim[:b].sum(dim=1)) - torch.log(pos / exp_sim[b:].sum(dim=1))
    return torch.mean(loss)
