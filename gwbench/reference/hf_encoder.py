"""A Whisper encoder's state dict in Hugging Face's layout
(``transformers``' ``WhisperEncoder.state_dict()``; keys with or without an
``encoder.``/``model.encoder.`` prefix) read into the plain reference's
layout (``reference.model.Encoder``): a linear ``w`` (d_in, d_out), a
conv1d ``w`` (3, C_in, C_out), per-layer dicts. The tensors stay where they
are, as float32 views where the layout allows."""
from __future__ import annotations

from typing import Dict, Mapping

import torch


def encoder(state: Mapping[str, torch.Tensor]) -> Dict:
    sd = {k.removeprefix("model.").removeprefix("encoder."): torch.as_tensor(v).float() for k, v in state.items()}
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("layers."))

    def lin(name, bias=True):
        return {"w": sd[f"{name}.weight"].t(), **({"b": sd[f"{name}.bias"]} if bias else {})}

    def ln(name):
        return {"g": sd[f"{name}.weight"], "b": sd[f"{name}.bias"]}

    layers = []
    for i in range(n_layers):
        pre = f"layers.{i}"
        layers.append({"attn_ln": ln(f"{pre}.self_attn_layer_norm"), "q": lin(f"{pre}.self_attn.q_proj"),
                       "k": lin(f"{pre}.self_attn.k_proj", bias=False), "v": lin(f"{pre}.self_attn.v_proj"),
                       "o": lin(f"{pre}.self_attn.out_proj"), "mlp_ln": ln(f"{pre}.final_layer_norm"),
                       "fc1": lin(f"{pre}.fc1"), "fc2": lin(f"{pre}.fc2")})
    return {"conv1": {"w": sd["conv1.weight"].permute(2, 1, 0), "b": sd["conv1.bias"]},
            "conv2": {"w": sd["conv2.weight"].permute(2, 1, 0), "b": sd["conv2.bias"]},
            "layers": layers, "ln_post": ln("layer_norm")}
