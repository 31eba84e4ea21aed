"""HF Whisper checkpoint interop (counterpart of ``gwkit/models/hf_io.py``).

Loads ``openai/whisper-*`` encoder weights from a module with
``state_dict()``, a state-dict mapping, a ``.safetensors`` file (parsed by
:func:`gwkit_torch.io.read_safetensors`, no safetensors package) or a torch
checkpoint file into gwkit's stacked parameter tree of numpy arrays, which
:func:`gwkit_torch.io.from_gwkit_numpy` turns into the port's parameters.
Layout conversions: torch Linear (out, in) -> (in, out); torch Conv1d
(out, in, k) -> (k, in, out).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from gwkit_torch.io import read_safetensors
from gwkit_torch.models.whisper import WhisperConfig, config_for


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def encoder_params_from_state_dict(state: Mapping[str, Any], cfg: WhisperConfig) -> Dict:
    """An HF WhisperEncoder state dict (keys with or without an
    ``encoder.``/``model.encoder.`` prefix) -> gwkit's encoder tree, layers
    stacked along a leading n_layers axis."""
    sd = {k.removeprefix("model.").removeprefix("encoder."): _np(v) for k, v in state.items()}

    def lin(name, bias=True):
        return {"w": sd[f"{name}.weight"].T.copy(), **({"b": sd[f"{name}.bias"].copy()} if bias else {})}

    def ln(name):
        return {"g": sd[f"{name}.weight"].copy(), "b": sd[f"{name}.bias"].copy()}

    layers = []
    for i in range(cfg.n_layers):
        pre = f"layers.{i}"
        layers.append({
            "attn_ln": ln(f"{pre}.self_attn_layer_norm"),
            "q": lin(f"{pre}.self_attn.q_proj"),
            "k": lin(f"{pre}.self_attn.k_proj", bias=False),
            "v": lin(f"{pre}.self_attn.v_proj"),
            "o": lin(f"{pre}.self_attn.out_proj"),
            "mlp_ln": ln(f"{pre}.final_layer_norm"),
            "fc1": lin(f"{pre}.fc1"),
            "fc2": lin(f"{pre}.fc2"),
        })
    stacked = {name: {k: np.stack([layer[name][k] for layer in layers]) for k in layers[0][name]}
               for name in layers[0]}
    if sd["conv1.weight"].shape[1] != cfg.n_mels:
        raise ValueError(f"conv1 reads {sd['conv1.weight'].shape[1]} mel bins, the config {cfg.n_mels} "
                         f"(size 'large-v3' reads 128)")
    return {
        "conv1": {"w": sd["conv1.weight"].transpose(2, 1, 0), "b": sd["conv1.bias"]},
        "conv2": {"w": sd["conv2.weight"].transpose(2, 1, 0), "b": sd["conv2.bias"]},
        "pos": sd["embed_positions.weight"][: cfg.max_positions],
        "layers": stacked,
        "ln_post": ln("layer_norm"),
    }


def load_hf_encoder(path_or_model, size: str = "tiny", **cfg_overrides):
    """Load from a module with ``state_dict()``, a state-dict mapping, or a
    ``.safetensors`` / torch checkpoint file path. Returns (cfg, params)."""
    cfg = config_for(size, **cfg_overrides)
    if hasattr(path_or_model, "state_dict"):
        state = path_or_model.state_dict()
    elif isinstance(path_or_model, Mapping):
        state = path_or_model
    elif str(path_or_model).endswith(".safetensors"):
        state = read_safetensors(str(path_or_model))
    else:
        state = torch.load(path_or_model, map_location="cpu", weights_only=True)
    return cfg, encoder_params_from_state_dict(state, cfg)


def encoder_state_dict_from_params(params: Dict, cfg: WhisperConfig) -> Dict[str, np.ndarray]:
    """The inverse conversion, for HF consumers: the port's encoder
    parameters (``layers`` a per-layer list) -> an HF WhisperEncoder state
    dict of float32 numpy arrays."""
    out = {
        "conv1.weight": _np(params["conv1"]["w"]).transpose(2, 1, 0),
        "conv1.bias": _np(params["conv1"]["b"]),
        "conv2.weight": _np(params["conv2"]["w"]).transpose(2, 1, 0),
        "conv2.bias": _np(params["conv2"]["b"]),
        "embed_positions.weight": _np(params["pos"]),
        "layer_norm.weight": _np(params["ln_post"]["g"]),
        "layer_norm.bias": _np(params["ln_post"]["b"]),
    }
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.out_proj", "fc1": "fc1", "fc2": "fc2"}
    for i in range(cfg.n_layers):
        pre, p = f"layers.{i}", params["layers"][i]
        for ours, theirs in names.items():
            out[f"{pre}.{theirs}.weight"] = _np(p[ours]["w"]).T
            if "b" in p[ours]:
                out[f"{pre}.{theirs}.bias"] = _np(p[ours]["b"])
        out[f"{pre}.self_attn_layer_norm.weight"] = _np(p["attn_ln"]["g"])
        out[f"{pre}.self_attn_layer_norm.bias"] = _np(p["attn_ln"]["b"])
        out[f"{pre}.final_layer_norm.weight"] = _np(p["mlp_ln"]["g"])
        out[f"{pre}.final_layer_norm.bias"] = _np(p["mlp_ln"]["b"])
    return out
