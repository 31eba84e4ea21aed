"""Task heads (counterpart of ``gwkit/models/heads.py``): the ReLU MLP
heads of every task (``HEAD_WIDTHS``), their init and the glitch head's
dropout, and the CNN head over the stacked per-detector embeddings."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gwkit_torch.io import Leaf
from gwkit_torch.utils.tracing import annotate

HEAD_WIDTHS = {
    "two_channel": (1024, 512, 256),
    "one_channel": (512, 256, 128, 64),
    "glitch": (512, 256, 128),
    "gwwhisper": (512, 256, 128, 64),
    "baseline": (1024, 512, 256),
}
HEAD_DROPOUT = {"glitch": 0.3}


def mlp_head_shapes(d_in: int, widths: Sequence[int], num_classes: int) -> List[dict]:
    """gwkit's head pytree as :class:`Leaf` shapes (for ``load_pytree_npz``)."""
    dims = [d_in, *widths, num_classes]
    return [{"w": Leaf((a, b)), "b": Leaf((b,))} for a, b in zip(dims[:-1], dims[1:])]


def linear_init(d_in: int, d_out: int, generator: torch.Generator, bias: bool = True) -> dict:
    """torch nn.Linear's default init, U(+-1/sqrt(d_in)), in gwkit's
    right-multiplied layout, drawn from ``generator``."""
    bound = 1.0 / np.sqrt(d_in)
    u = lambda *shape: (torch.rand(shape, generator=generator) * 2 - 1) * bound
    return {"w": u(d_in, d_out), **({"b": u(d_out)} if bias else {})}


def init_mlp_head(d_in: int, widths: Sequence[int], num_classes: int,
                  generator: torch.Generator) -> List[dict]:
    dims = [d_in, *widths, num_classes]
    return [linear_init(a, b, generator) for a, b in zip(dims[:-1], dims[1:])]


def mlp_head_apply(params: List[dict], x: torch.Tensor, *, dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   softmax: bool = False) -> torch.Tensor:
    """ReLU MLP with optional dropout after each hidden ReLU (the glitch
    head's placement) and an optional final softmax. ``generator=None`` is
    inference mode: no dropout."""
    n = len(params)
    with annotate("gw.head"):
        for i, p in enumerate(params):
            x = x @ p["w"] + p["b"]
            if i < n - 1:
                x = torch.relu(x)
                if dropout_rate > 0.0 and generator is not None:
                    keep = torch.rand(x.shape, generator=generator).to(x.device) < 1.0 - dropout_rate
                    x = torch.where(keep, x / (1.0 - dropout_rate), torch.zeros_like(x))
        return torch.softmax(x, dim=-1) if softmax else x


def init_cnn_head(num_classes: int, generator: torch.Generator, channels=(2, 64, 128, 256)) -> dict:
    """TwoChannelLIGOBinaryClassifierCNN's head: k=3 convolutions in gwkit's
    (3, c_in, c_out) layout, U(+-1/sqrt(3 c_in)), then a linear layer."""
    convs = []
    for c_in, c_out in zip(channels[:-1], channels[1:]):
        bound = 1.0 / np.sqrt(c_in * 3)
        u = lambda *shape: (torch.rand(shape, generator=generator) * 2 - 1) * bound
        convs.append({"w": u(3, c_in, c_out), "b": u(c_out)})
    return {"convs": convs, "out": linear_init(channels[-1], num_classes, generator)}


def cnn_head_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 2, d_model) stacked per-detector embeddings -> (B, num_classes):
    the detectors are the channels and d_model the length of each 'same'
    convolution (ReLU after each), then the mean over the length and the
    linear layer."""
    h = x
    with annotate("gw.head"):
        for p in params["convs"]:
            h = torch.relu(F.conv1d(h, p["w"].permute(2, 1, 0), p["b"], padding=1))
        return h.mean(dim=-1) @ params["out"]["w"] + params["out"]["b"]
