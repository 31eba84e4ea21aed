"""Reading the weight files with numpy alone: gwkit's ``leaf_NNNNN`` npz
trees (leaves in jax's flattening order: dict keys sorted, lists in order)
and peft's adapter directories (safetensors parsed directly)."""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, List

import numpy as np

# jax-order leaf names of the three trees the capstone stores
ENCODER_KEYS = ("conv1.b", "conv1.w", "conv2.b", "conv2.w",
                "layers.attn_ln.b", "layers.attn_ln.g", "layers.fc1.b", "layers.fc1.w", "layers.fc2.b",
                "layers.fc2.w", "layers.k.w", "layers.mlp_ln.b", "layers.mlp_ln.g", "layers.o.b", "layers.o.w",
                "layers.q.b", "layers.q.w", "layers.v.b", "layers.v.w", "ln_post.b", "ln_post.g", "pos")
QADAPTER_KEYS = ("bias", "conv1.b", "conv1.w", "conv2.b", "conv2.w", "conv3.b", "conv3.w", "conv4.b", "conv4.w",
                 "film_beta", "film_gamma", "scale")
PEFT_PROJ = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "out_proj": "o"}


def npz_leaves(path: str, keys) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != len(keys):
            raise ValueError(f"{path}: {n} leaves, expected {len(keys)}")
        return {key: np.asarray(data[f"leaf_{i:05d}"], np.float32) for i, key in enumerate(keys)}


def mlp_head(path: str) -> List[Dict[str, np.ndarray]]:
    """A list of {"w": (d_in, d_out), "b": (d_out,)}, leaves b, w per layer."""
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        return [{"b": np.asarray(data[f"leaf_{2 * i:05d}"], np.float32),
                 "w": np.asarray(data[f"leaf_{2 * i + 1:05d}"], np.float32)} for i in range(n // 2)]


def safetensors(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    dtypes = {"F32": "<f4", "F16": "<f2", "F64": "<f8"}
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        a, b = spec["data_offsets"]
        buf = raw[8 + n + a: 8 + n + b]
        if spec["dtype"] == "BF16":
            arr = (np.frombuffer(buf, "<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(buf, dtypes[spec["dtype"]]).astype(np.float32)
        out[name] = arr.reshape(spec["shape"])
    return out


def peft_dora(path: str, n_layers: int) -> List[Dict[str, Dict[str, np.ndarray]]]:
    """Per layer {proj: {"a": (d_in, r), "b": (r, d_out), "m": (d_out,),
    "scaling": alpha / r}} from a peft directory (peft stores A as (r, d_in)
    and B as (d_out, r))."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    scaling = float(cfg["lora_alpha"]) / float(cfg["r"])
    layers: List[Dict[str, Dict[str, np.ndarray]]] = [{} for _ in range(n_layers)]
    for name, arr in safetensors(os.path.join(path, "adapter_model.safetensors")).items():
        parts = name.split(".")
        i = int(parts[parts.index("layers") + 1])
        proj = PEFT_PROJ[parts[parts.index("self_attn") + 1]]
        entry = layers[i].setdefault(proj, {"scaling": scaling})
        if "lora_A" in name:
            entry["a"] = arr.T
        elif "lora_B" in name:
            entry["b"] = arr.T
        elif "magnitude" in name:
            entry["m"] = arr
    return layers


def unstack_layers(flat: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """``layers.<name>`` leaves stacked on a leading layer axis -> one dict per layer."""
    keys = [k for k in flat if k.startswith("layers.")]
    n = flat[keys[0]].shape[0]
    return [{k[len("layers."):]: flat[k][i] for k in keys} for i in range(n)]


def nest(flat: Dict[str, np.ndarray]) -> dict:
    """{"a.b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for key, value in flat.items():
        node = out
        *path, last = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = value
    return out


def encoder(path: str) -> dict:
    """A gwkit encoder npz -> {"conv1", "conv2", "ln_post", "layers": [per layer]}
    (the stored ``pos`` is not used: the reference makes its own table)."""
    flat = npz_leaves(path, ENCODER_KEYS)
    out = nest({k: v for k, v in flat.items() if not k.startswith("layers.") and k != "pos"})
    out["layers"] = [nest(layer) for layer in unstack_layers(flat)]
    return out
