"""Q-transform adapter: Q-scan -> 2D CNN -> adaptive pool -> FiLM
(counterpart of ``gwkit/models/qadapter.py``).

Parameters keep gwkit's layout (conv weights HWIO); the convolutions run in
NCHW with the weights permuted, in full float32 (no TF32) as gwkit's f32
reference does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gwkit_torch.device import no_tf32_convs
from gwkit_torch.io import Leaf
from gwkit_torch.ops.qtransform import make_qplan, qscan


@dataclasses.dataclass(frozen=True)
class QAdapterConfig:
    kernel_length: float = 1.0
    sample_rate: int = 2048
    q_range: Tuple[float, float] = (4.0, 128.0)
    spectrogram_shape: Tuple[int, int] = (128, 128)
    target_shape: Tuple[int, int] = (80, 3000)
    n_detectors: int = 2
    channels: Tuple[int, int, int] = (32, 64, 128)
    qscan_norm: str = "median"
    median_stride: int = 1
    time_decimation: int = 1  # > 1: gwkit's spectral fold of the tile energies (ops.qtransform.qscan)


def param_shapes(cfg: QAdapterConfig) -> dict:
    """gwkit's Q-adapter pytree as :class:`Leaf` shapes (for ``load_pytree_npz``)."""
    c1, c2, c3 = cfg.channels
    conv = lambda k, ci, co: {"w": Leaf((k, k, ci, co)), "b": Leaf((co,))}
    return {
        "conv1": conv(3, 1, c1), "conv2": conv(3, c1, c2), "conv3": conv(3, c2, c3),
        "conv4": conv(1, c3, 1),
        "scale": Leaf((1,)), "bias": Leaf((1,)),
        "film_gamma": Leaf((cfg.n_detectors,)), "film_beta": Leaf((cfg.n_detectors,)),
    }


def init_qadapter(cfg: QAdapterConfig, generator: torch.Generator) -> dict:
    """gwkit's init (conv weights and biases U(+-1/sqrt(fan_in)), unit scale
    and FiLM gain, zero shifts), drawn from ``generator``."""
    def conv(ci, co, k):
        bound = 1.0 / np.sqrt(ci * k * k)
        u = lambda *shape: (torch.rand(shape, generator=generator) * 2 - 1) * bound
        return {"w": u(k, k, ci, co), "b": u(co)}

    c1, c2, c3 = cfg.channels
    return {"conv1": conv(1, c1, 3), "conv2": conv(c1, c2, 3), "conv3": conv(c2, c3, 3),
            "conv4": conv(c3, 1, 1),
            "scale": torch.ones(1), "bias": torch.zeros(1),
            "film_gamma": torch.ones(cfg.n_detectors), "film_beta": torch.zeros(cfg.n_detectors)}


@functools.lru_cache(maxsize=8)
def _adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix implementing torch adaptive_avg_pool1d semantics."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        start = (i * n_in) // n_out
        end = -(-((i + 1) * n_in) // n_out)
        m[i, start:end] = 1.0 / (end - start)
    return m


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    mh = torch.from_numpy(_adaptive_pool_matrix(x.shape[-2], out_hw[0])).to(x.device)
    mw = torch.from_numpy(_adaptive_pool_matrix(x.shape[-1], out_hw[1])).to(x.device)
    return torch.einsum("oh,...hw,pw->...op", mh, x, mw)


def _conv2d(x: torch.Tensor, p: dict, padding: int) -> torch.Tensor:
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=padding)


def qadapter_apply(cfg: QAdapterConfig, params: dict, strain: torch.Tensor) -> torch.Tensor:
    """strain (B, D, T) -> Whisper features (B, D, F*, T*); detectors folded
    into the batch for one Q-scan."""
    B, D, T = strain.shape
    plan = make_qplan(cfg.kernel_length, float(cfg.sample_rate), cfg.q_range, cfg.spectrogram_shape)
    qspec = qscan(strain.reshape(B * D, T), plan, norm=cfg.qscan_norm,
                  median_stride=cfg.median_stride, time_decimation=cfg.time_decimation)
    return qadapter_apply_spec(cfg, params, qspec.reshape(B, D, *qspec.shape[1:]))


def qadapter_apply_spec(cfg: QAdapterConfig, params: dict, qspec: torch.Tensor) -> torch.Tensor:
    """(B, D, F, T) Q spectrograms -> (B, D, F*, T*) features: the
    post-Q-scan half of :func:`qadapter_apply`, which the streaming search
    feeds with cropped spectrograms."""
    B, D = qspec.shape[:2]
    x = qspec.reshape(B * D, 1, *qspec.shape[2:])
    with no_tf32_convs():
        x = F.max_pool2d(torch.relu(_conv2d(x, params["conv1"], 1)), 2)
        x = F.max_pool2d(torch.relu(_conv2d(x, params["conv2"], 1)), 2)
        x = torch.relu(_conv2d(x, params["conv3"], 1))
        x = _conv2d(x, params["conv4"], 0)[:, 0]  # (B*D, F', T')
    x = adaptive_avg_pool2d(x, cfg.target_shape)
    x = params["scale"] * x + params["bias"]
    x = x.reshape(B, D, *cfg.target_shape)
    return x * params["film_gamma"][None, :, None, None] + params["film_beta"][None, :, None, None]
