"""A Whisper encoder drawn from a seed, for a configuration whose weights
the repository does not hold (``weights.from`` "seed"): a state dict in
Hugging Face's layout (the keys and shapes of ``transformers``'
``WhisperEncoder.state_dict()``), drawn on the device in
``WhisperPreTrainedModel._init_weights``' family: linear and convolution
weights N(0, ``init_std``^2), biases 0, LayerNorm weights 1 and biases 0,
the sinusoidal position table. The normal draws come from one
``torch.Generator`` on the device, in one draw."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from gwbench.reference.model import sinusoids


def _shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(key, shape, kind) in draw order; kind "w" (normal), "zero" or "one"."""
    d, F, n_mels = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["num_mel_bins"]
    out = [("conv1.weight", (d, n_mels, 3), "w"), ("conv1.bias", (d,), "zero"),
           ("conv2.weight", (d, d, 3), "w"), ("conv2.bias", (d,), "zero")]
    for i in range(cfg["encoder_layers"]):
        pre = f"layers.{i}"
        out += [(f"{pre}.self_attn.k_proj.weight", (d, d), "w"),
                (f"{pre}.self_attn.v_proj.weight", (d, d), "w"), (f"{pre}.self_attn.v_proj.bias", (d,), "zero"),
                (f"{pre}.self_attn.q_proj.weight", (d, d), "w"), (f"{pre}.self_attn.q_proj.bias", (d,), "zero"),
                (f"{pre}.self_attn.out_proj.weight", (d, d), "w"), (f"{pre}.self_attn.out_proj.bias", (d,), "zero"),
                (f"{pre}.self_attn_layer_norm.weight", (d,), "one"), (f"{pre}.self_attn_layer_norm.bias", (d,), "zero"),
                (f"{pre}.fc1.weight", (F, d), "w"), (f"{pre}.fc1.bias", (F,), "zero"),
                (f"{pre}.fc2.weight", (d, F), "w"), (f"{pre}.fc2.bias", (d,), "zero"),
                (f"{pre}.final_layer_norm.weight", (d,), "one"), (f"{pre}.final_layer_norm.bias", (d,), "zero")]
    return out + [("layer_norm.weight", (d,), "one"), ("layer_norm.bias", (d,), "zero")]


def encoder_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The encoder of configuration ``cfg`` (its published keys and
    ``weights``) as float32 tensors on ``device``; the same seed gives the
    same weights."""
    std = cfg["weights"]["init_std"]
    shapes = _shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s, kind in shapes if kind == "w"), generator=gen, device=device)
    state, at = {}, 0
    for key, shape, kind in shapes:
        if kind == "w":
            n = math.prod(shape)
            state[key] = flat[at: at + n].view(shape).mul_(std)
            at += n
        else:
            state[key] = (torch.ones if kind == "one" else torch.zeros)(shape, device=device)
    state["embed_positions.weight"] = sinusoids(cfg["max_source_positions"], cfg["d_model"]).to(device)
    return state
