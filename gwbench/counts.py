"""Operations and bytes, counted from shapes. These are the yardstick of
``mfu.*`` and ``*_roofline.*``: a count is of the function a layer computes
(each input byte read once, each output byte written once), never of how a
kernel happens to compute it. DoRA is folded at inference, so a projection
counts as one product with its effective weight.

Whisper encoder layer over T tokens of width d, FFN width F (multiply-add = 2):
  QKV 2*T*d*3d, o 2*T*d*d, attention 2*T*T*d (q k^T) + 2*T*T*d (p v),
  MLP 2*T*d*F + 2*T*F*d   ->   8*T*d^2 + 4*T*d*F + 4*T^2*d.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> Optional[dict]:
    """The card's published peaks, or None for a card the table lacks."""
    with open(PEAKS) as f:
        return json.load(f).get(device_name)


def encoder_layer_flops(T: int, d: int, F: int) -> int:
    return 8 * T * d * d + 4 * T * d * F + 4 * T * T * d


def conv_stem_flops(frames: int, n_mels: int, d: int) -> int:
    """Conv1d(n_mels, d, k=3, s=1, p=1) then Conv1d(d, d, k=3, s=2, p=1)."""
    return 2 * frames * n_mels * 3 * d + 2 * ((frames + 1) // 2) * d * 3 * d


def mlp_flops(dims: Sequence[int]) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def qadapter_flops(spec: Sequence[int], channels: Sequence[int]) -> int:
    """The Q-adapter's convolutions on one (F, T) Q spectrogram: 3x3 to c1,
    pool 2, 3x3 to c2, pool 2, 3x3 to c3, 1x1 to 1."""
    F, T = spec
    c1, c2, c3 = channels
    return (2 * 9 * c1 * F * T + 2 * 9 * c1 * c2 * (F // 2) * (T // 2)
            + 2 * 9 * c2 * c3 * (F // 4) * (T // 4) + 2 * c3 * (F // 4) * (T // 4))


def encoder_flops(cfg: dict, tokens: int) -> int:
    return cfg["encoder_layers"] * encoder_layer_flops(tokens, cfg["d_model"], cfg["encoder_ffn_dim"])


def search_window_flops(cfg: dict) -> int:
    """One search window: per detector the Q-adapter, the conv stem over the
    adapter's frames and the encoder over half as many tokens; then the head
    on both detectors' last tokens."""
    q = cfg["qadapter"]
    frames = q["target_shape"][1]
    per_det = (qadapter_flops(q["spectrogram_shape"], q["channels"])
               + conv_stem_flops(frames, cfg["num_mel_bins"], cfg["d_model"]) + encoder_flops(cfg, frames // 2))
    head = mlp_flops([cfg["d_model"] * 2, *cfg["head"]["widths"], cfg["head"]["num_classes"]])
    return 2 * per_det + head


def classify_sample_flops(cfg: dict) -> int:
    """One classified sample: per detector the conv stem over the mel frames
    and the encoder over half as many tokens; then the head."""
    frames = cfg["n_frames"]
    per_det = conv_stem_flops(frames, cfg["num_mel_bins"], cfg["d_model"]) + encoder_flops(cfg, frames // 2)
    head = mlp_flops([cfg["d_model"] * 2, *cfg["head"]["widths"], cfg["head"]["num_classes"]])
    return 2 * per_det + head


def layer_launches(sequences: int, T: int, d: int, F: int, heads: int,
                   itemsize: int) -> Dict[str, List[Tuple[int, int]]]:
    """(bytes, flops) of each kernel launch of one encoder layer on the
    kernel chain B -> A -> B -> C over ``sequences`` x ``T`` tokens:
    ln_gemm's two launches (LayerNorm + QKV; o-projection + residual),
    attention, fused_mlp (LayerNorm + fc1 + GELU + fc2 + residual). LayerNorm
    parameters and biases are f32 (4 bytes)."""
    M = sequences * T
    qkv = (itemsize * (M * d + d * 3 * d + 2 * d + M * 3 * d) + 4 * 3 * d, 2 * M * 3 * d * d)
    o = (itemsize * (M * d + d * d + 2 * M * d) + 4 * d, 2 * M * d * d)
    att = (itemsize * 4 * M * d, 4 * sequences * heads * T * T * (d // heads))
    mlp = (itemsize * (2 * M * d + 2 * d + 2 * d * F) + 4 * (F + d), 4 * M * d * F)
    return {"ln_gemm": [qkv, o], "attention": [att], "fused_mlp": [mlp]}


def least_seconds(n_bytes: int, flops: int, peak: dict) -> float:
    """The least time a launch can take on the card: the larger of its
    operations at the bf16 peak and its bytes at the memory bandwidth."""
    return max(flops / peak["bf16_flops_per_s"], n_bytes / peak["hbm_bytes_per_s"])
