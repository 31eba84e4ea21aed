"""DoRA/LoRA adapters for the Whisper encoder, and their peft export
(counterpart of ``gwkit/models/adapters.py``).

The adapters are a per-layer list of {proj: {'a': (d_in, r), 'b': (r,
d_out), 'm': (d_out,), 'scaling': 0-d}}, the layout of
:func:`gwkit_torch.io.from_gwkit_numpy`; ``scaling`` is a trained leaf, as
in gwkit. The encoder's base weights stay outside (frozen by construction).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List

import torch

from gwkit_torch.io import _HF_PROJ, AdapterConfig, to_gwkit_numpy, write_safetensors
from gwkit_torch.models.whisper import WhisperConfig

__all__ = ["AdapterConfig", "init_adapters", "empty_adapters", "n_trainable", "export_peft_dir"]


def init_adapters(cfg: WhisperConfig, acfg: AdapterConfig, encoder_params: dict,
                  generator: torch.Generator) -> List[dict]:
    """peft's DoRA init: A ~ U(+-1/sqrt(d_in)) (kaiming_uniform(a=sqrt(5))
    on peft's (r, d_in) matrix), B = 0 and m = the column norms of W0, so the
    first forward is exactly the base model. Drawn from ``generator``: the
    same distribution as gwkit, not its values."""
    layers = [{} for _ in range(cfg.n_layers)]
    for proj in acfg.target_keys:
        for layer, p in zip(layers, encoder_params["layers"]):
            w0 = p[proj]["w"].float()
            d_in, d_out = w0.shape
            bound = 1.0 / math.sqrt(d_in)
            a = (torch.rand((d_in, acfg.r), generator=generator) * 2 - 1) * bound
            entry = {"a": a.to(w0.device), "b": torch.zeros((acfg.r, d_out), device=w0.device),
                     "scaling": torch.tensor(acfg.scaling, device=w0.device)}
            if acfg.use_dora:
                entry["m"] = w0.norm(dim=0)
            layer[proj] = entry
    return layers


def empty_adapters(cfg: WhisperConfig, acfg: AdapterConfig, encoder_params: dict) -> List[dict]:
    """Adapters for all four projections, whatever ``acfg.targets`` says,
    initialized as :func:`init_adapters` does (B = 0, so each is the
    identity) from a generator seeded 0: a uniform tree across q/k/v/o.
    Usually init_adapters is what you want."""
    return init_adapters(cfg, dataclasses.replace(acfg, targets="qkvo"), encoder_params,
                         torch.Generator().manual_seed(0))


def n_trainable(adapters: List[dict]) -> int:
    """Adapter parameters, ``scaling`` not counted (as gwkit counts them)."""
    return sum(t.numel() for layer in adapters for entry in layer.values()
               for k, t in entry.items() if k != "scaling")


def _peft_key(layer: int, proj: str, part: str) -> str:
    return f"base_model.model.layers.{layer}.self_attn.{_HF_PROJ[proj]}.{part}"


def export_peft_dir(path: str, adapters: List[dict], acfg: AdapterConfig, n_layers: int) -> None:
    """Write a peft-loadable adapter directory: adapter_config.json and
    adapter_model.safetensors (the port's own writer), as gwkit writes it."""
    os.makedirs(path, exist_ok=True)
    stacked = to_gwkit_numpy(adapters=adapters)["adapters"]
    tensors = {}
    for proj, entry in stacked.items():
        for i in range(n_layers):
            tensors[_peft_key(i, proj, "lora_A") + ".weight"] = entry["a"][i].T.copy()  # (r, d_in)
            tensors[_peft_key(i, proj, "lora_B") + ".weight"] = entry["b"][i].T.copy()  # (d_out, r)
            if "m" in entry:
                tensors[_peft_key(i, proj, "lora_magnitude_vector")] = entry["m"][i].copy()
    write_safetensors(os.path.join(path, "adapter_model.safetensors"), tensors)
    config = {
        "peft_type": "LORA", "r": acfg.r, "lora_alpha": acfg.alpha, "use_dora": acfg.use_dora,
        "lora_dropout": 0.0,
        "target_modules": sorted({f"layers.{i}.self_attn.{_HF_PROJ[p]}" for p in stacked
                                  for i in range(n_layers)}),
        "bias": "none", "task_type": None,
    }
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump(config, f, indent=2)
