"""DoRA linear: weight-decomposed low-rank adaptation, without materializing
the effective weight (counterpart of ``gwkit/ops/dora.py``).

  W_eff = m * (W0 + s*A@B) / ||W0 + s*A@B||_col,   s = alpha / r
  y     = x @ W_eff + bias        (bias not rescaled, as in peft)

Layout (right-multiplied): W0 (d_in, d_out), a (d_in, r), b (r, d_out),
m (d_out,). The column norm is a constant under differentiation (detached,
as in the DoRA paper and peft) and accumulates in f32.
"""
from __future__ import annotations

from typing import Optional

import torch


def dora_row_norms(w0: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scaling: float) -> torch.Tensor:
    """Column norms (over d_in) of (w0 + scaling * a @ b), by the factorization
    ||w_j||^2 = ||W0_j||^2 + 2s<(a^T W0)_j, b_j> + s^2 b_j^T (a^T a) b_j."""
    w0, a, b = w0.float(), a.float(), b.float()
    c0 = torch.sum(w0 * w0, dim=0)
    cross = torch.sum((a.T @ w0) * b, dim=0)
    quad = torch.sum(((a.T @ a) @ b) * b, dim=0)
    norm_sq = c0 + 2.0 * scaling * cross + (scaling * scaling) * quad
    return torch.sqrt(torch.clamp(norm_sq, min=1e-12))


def dora_linear(x: torch.Tensor, w0: torch.Tensor, bias: Optional[torch.Tensor], adapter: dict) -> torch.Tensor:
    """y = m/||W0+s*a@b|| * (x @ W0 + s * (x @ a) @ b) + bias.

    ``adapter``: {'a': (d_in, r), 'b': (r, d_out), 'm': (d_out,) or absent
    for plain LoRA, 'scaling': float}."""
    a, b = adapter["a"], adapter["b"]
    scaling = adapter.get("scaling", 1.0)
    y = x @ w0 + scaling * ((x @ a) @ b)
    if "m" in adapter:
        norms = dora_row_norms(w0, a, b, scaling).detach()
        y = y * (adapter["m"].float() / norms).to(y.dtype)
    if bias is not None:
        y = y + bias
    return y
