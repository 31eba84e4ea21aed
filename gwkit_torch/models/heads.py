"""Task heads (counterpart of ``gwkit/models/heads.py``): the ReLU MLP head
used by the MLGWSC-1 search (``gwwhisper`` widths)."""
from __future__ import annotations

from typing import List, Sequence

import torch

from gwkit_torch.io import Leaf

HEAD_WIDTHS = {
    "two_channel": (1024, 512, 256),
    "one_channel": (512, 256, 128, 64),
    "glitch": (512, 256, 128),
    "gwwhisper": (512, 256, 128, 64),
    "baseline": (1024, 512, 256),
}


def mlp_head_shapes(d_in: int, widths: Sequence[int], num_classes: int) -> List[dict]:
    """gwkit's head pytree as :class:`Leaf` shapes (for ``load_pytree_npz``)."""
    dims = [d_in, *widths, num_classes]
    return [{"w": Leaf((a, b)), "b": Leaf((b,))} for a, b in zip(dims[:-1], dims[1:])]


def mlp_head_apply(params: List[dict], x: torch.Tensor, *, softmax: bool = False) -> torch.Tensor:
    """ReLU MLP (inference: no dropout) with an optional final softmax."""
    n = len(params)
    for i, p in enumerate(params):
        x = x @ p["w"] + p["b"]
        if i < n - 1:
            x = torch.relu(x)
    return torch.softmax(x, dim=-1) if softmax else x
