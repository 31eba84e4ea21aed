"""Q-transform adapter: Q-scan -> 2D CNN -> adaptive pool -> FiLM
(counterpart of ``gwkit/models/qadapter.py``).

Parameters keep gwkit's layout (conv weights HWIO); the convolutions run in
NCHW with the weights permuted, in full float32 (no TF32) as gwkit's f32
reference does.

On the card and without gradients, :func:`qadapter_apply` replays the whole
front end, Q-scan to features, as one CUDA graph per input: the first call
of a (configuration, input, parameters) key runs eagerly and builds what the
capture needs (plan tables, taps, cuFFT plans, cuDNN's algorithms), the
second captures, every later one copies its strain into the graph's input
and replays. A trainer's in-place step keeps the parameters' addresses, so
a replay reads their new values; replaced parameters are a new key. Every
other call (the CPU, gradients on, keys past the cache's size) runs eagerly.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gwkit_torch.device import no_tf32_convs
from gwkit_torch.io import Leaf, tree_leaves
from gwkit_torch.ops.qtransform import make_qplan, qscan
from gwkit_torch.utils.tracing import COUNTERS, annotate


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


def _adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix implementing torch adaptive_avg_pool1d semantics."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        start = (i * n_in) // n_out
        end = -(-((i + 1) * n_in) // n_out)
        m[i, start:end] = 1.0 / (end - start)
    return m


# (n_in, n_out, device) -> the pooling matrix there, copied once: a copy from
# pageable host memory on every call would stop the host until the card
# drained its queue, and cannot be captured in a CUDA graph
_POOL_MATRICES: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _pool_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    key = (n_in, n_out, str(device))
    m = _POOL_MATRICES.get(key)
    if m is None:
        COUNTERS["builds"] += 1
        m = _POOL_MATRICES[key] = torch.from_numpy(_adaptive_pool_matrix(n_in, n_out)).to(device)
    return m


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    mh = _pool_matrix(x.shape[-2], out_hw[0], x.device)
    mw = _pool_matrix(x.shape[-1], out_hw[1], x.device)
    return torch.einsum("oh,...hw,pw->...op", mh, x, mw)


def _conv2d(x: torch.Tensor, p: dict, padding: int) -> torch.Tensor:
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=padding)


def qadapter_apply(cfg: QAdapterConfig, params: dict, strain: torch.Tensor) -> torch.Tensor:
    """strain (B, D, T) -> Whisper features (B, D, F*, T*); detectors folded
    into the batch for one Q-scan. On the card without gradients, a replay
    of the key's CUDA graph once it is captured (the module's docstring)."""
    if strain.is_cuda and not torch.is_grad_enabled():
        return _front_end_on_card(cfg, params, strain)
    return _qadapter_eager(cfg, params, strain)


def _qadapter_eager(cfg: QAdapterConfig, params: dict, strain: torch.Tensor) -> torch.Tensor:
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
    with annotate("gw.qadapter"):
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


class _FrontGraph:
    """The front end captured for one key: its input, the graph and its
    output, all on the card. A call copies the strain in, replays on the
    current stream and returns a clone of the output, so no caller holds
    storage that a later replay overwrites."""

    def __init__(self, cfg: QAdapterConfig, params: dict, strain: torch.Tensor):
        dev = strain.device
        self.strain = torch.empty(strain.shape, dtype=strain.dtype, device=dev)
        self.strain.copy_(strain)
        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(self.stream):
            # warm on the capture stream: libraries set up their per-stream
            # state (cuBLAS's workspace) outside the capture
            _qadapter_eager(cfg, params, self.strain)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=self.stream, capture_error_mode="thread_local"), \
                    no_tf32_convs():
                self.out = _qadapter_eager(cfg, params, self.strain)
        self.last_stream = torch.cuda.current_stream(dev)
        self.last_stream.wait_stream(self.stream)

    def __call__(self, strain: torch.Tensor) -> torch.Tensor:
        with annotate("gw.qfront_graph"):
            cur = torch.cuda.current_stream(strain.device)
            if cur != self.last_stream:  # the last replay may still read the input there
                cur.wait_stream(self.last_stream)
                self.last_stream = cur
            self.strain.copy_(strain)
            self.graph.replay()
            return self.out.clone()


# At most this many captured keys; later keys run eagerly. The search takes
# one (the slicer wrap-pads a block's last batch), an evaluation with a
# short last batch two, a one-card rank of a sharded search one. Each graph
# keeps a memory pool of its own for its intermediates.
_GRAPH_CACHE_SIZE = 4
_GRAPHS: Dict[tuple, _FrontGraph] = {}
_SEEN: "collections.OrderedDict[tuple, None]" = collections.OrderedDict()  # keys run once eagerly
_LOCK = threading.Lock()


def _front_end_on_card(cfg: QAdapterConfig, params: dict, strain: torch.Tensor) -> torch.Tensor:
    # a graph reads its parameters at their addresses: same tensors at the
    # same addresses and layouts, same graph
    key = (cfg, tuple(strain.shape), strain.dtype, strain.device, torch.is_inference_mode_enabled(),
           tuple((id(t), t.data_ptr(), t.dtype, tuple(t.shape), t.stride()) for t in tree_leaves(params)))
    with _LOCK:  # one graph's input and output serve one call at a time
        graph = _GRAPHS.get(key)
        if graph is None and key in _SEEN and len(_GRAPHS) < _GRAPH_CACHE_SIZE:
            del _SEEN[key]
            COUNTERS["builds"] += 1
            COUNTERS["qadapter_graph_captures"] += 1
            graph = _GRAPHS[key] = _FrontGraph(cfg, params, strain)
        if graph is not None:
            COUNTERS["qadapter_graph_replays"] += 1
            return graph(strain)
        if len(_GRAPHS) < _GRAPH_CACHE_SIZE:
            _SEEN[key] = None
            while len(_SEEN) > _GRAPH_CACHE_SIZE:
                _SEEN.popitem(last=False)
        COUNTERS["qadapter_eager_calls"] += 1
    return _qadapter_eager(cfg, params, strain)
