"""Reading gwkit's weight files with numpy alone, and the weight bridge.

Counterparts: ``gwkit/train/checkpoints.py::load_pytree`` (the flattened
``leaf_NNNNN`` npz format), ``gwkit/models/adapters.py::import_peft_dir``
and ``_read_safetensors``. No jax, safetensors or transformers: the npz leaf
order is rebuilt here by jax's flattening rule (dict keys sorted, lists and
tuples in order), and safetensors files are parsed directly (an 8-byte
little-endian header length, a JSON header, then raw little-endian data).

Layouts stay gwkit's (right-multiplied): linear ``w`` (d_in, d_out); conv1d
``w`` (3, C_in, C_out); conv2d ``w`` HWIO; DoRA ``a`` (d_in, r), ``b``
(r, d_out), ``m`` (d_out,). peft's (out, in) matrices are transposed on
import, as gwkit does.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PROJ_KEYS = ("q", "k", "v", "o")
_HF_PROJ = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}


class Leaf(tuple):
    """A template leaf: the expected shape of one stored array."""


# --------------------------------------------------------------------------
# pytree flattening with jax's ordering rule
# --------------------------------------------------------------------------

def _is_leaf(node) -> bool:
    return isinstance(node, Leaf) or hasattr(node, "shape")


def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree.flatten`` order: dict keys sorted, sequences in order."""
    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    if tree is None:
        return []
    raise TypeError(f"unsupported pytree node {type(tree).__name__}")


def tree_unflatten(like, leaves: Sequence[Any]):
    """Rebuild ``like``'s structure from ``leaves`` (the inverse of tree_leaves)."""
    it = iter(leaves)

    def build(node):
        if _is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            out = {k: None for k in node}  # keep the template's key order
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, list):
            return [build(x) for x in node]
        if isinstance(node, tuple):
            return tuple(build(x) for x in node)
        if node is None:
            return None
        raise TypeError(f"unsupported pytree node {type(node).__name__}")

    return build(like)


def tree_to(tree, *args):
    """``tensor.to(*args)`` on every tensor of a tree of dicts and lists
    (a dtype, a device or both); other leaves (e.g. DoRA's float
    ``scaling``) pass through."""
    if isinstance(tree, dict):
        return {k: tree_to(v, *args) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, *args) for v in tree]
    return tree.to(*args) if isinstance(tree, torch.Tensor) else tree


def _leaf_shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, Leaf) else tuple(leaf.shape)


def load_pytree_npz(path: str, like) -> Tuple[Any, dict]:
    """Load a gwkit ``save_pytree`` npz into the structure of ``like``.

    ``like`` holds :class:`Leaf` shapes (or arrays); every stored shape is
    checked. Returns (tree of numpy arrays, meta dict)."""
    with np.load(path) as data:
        meta = {}
        if "__meta__" in data:
            meta = json.loads(bytes(data["__meta__"]).decode())
        template = tree_leaves(like)
        loaded = []
        for i, leaf in enumerate(template):
            name = f"leaf_{i:05d}"
            if name not in data:
                raise ValueError(f"{path}: missing {name} (template has {len(template)} leaves)")
            arr = data[name]
            if tuple(arr.shape) != _leaf_shape(leaf):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != expected {_leaf_shape(leaf)}")
            loaded.append(arr)
        extra = [k for k in data.files if k.startswith("leaf_") and int(k[5:]) >= len(template)]
        if extra:
            raise ValueError(f"{path}: {len(extra)} more leaves than the template")
    return tree_unflatten(like, loaded), meta


# --------------------------------------------------------------------------
# safetensors without the safetensors package
# --------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Parse a .safetensors file into numpy arrays (BF16 widens to float32)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (n_header,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n_header].decode("utf-8"))
    base = 8 + n_header
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        start, end = spec["data_offsets"]
        buf = raw[base + start: base + end]
        shape = tuple(spec["shape"])
        if spec["dtype"] == "BF16":
            bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32).reshape(shape)
        else:
            arr = np.frombuffer(buf, dtype=_ST_DTYPES[spec["dtype"]]).reshape(shape).copy()
        out[name] = arr
    return out


# --------------------------------------------------------------------------
# peft adapter directories
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    r: int = 8
    alpha: int = 32
    use_dora: bool = True
    targets: str = "qkvo"

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def import_peft_dir(path: str, n_layers: int) -> Tuple[Dict[str, Dict[str, np.ndarray]], AdapterConfig]:
    """Load a peft adapter dir into gwkit's stacked layout (numpy):
    {proj: {'a': (L, d_in, r), 'b': (L, r, d_out), 'm': (L, d_out),
    'scaling': (L,)}} with ``scaling = alpha / r``."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    tensors = read_safetensors(os.path.join(path, "adapter_model.safetensors"))
    proj_of = {v: k for k, v in _HF_PROJ.items()}
    found: Dict[str, Dict[str, list]] = {}
    for name, arr in tensors.items():
        parts = name.split(".")
        try:
            layer = int(parts[parts.index("layers") + 1])
            hf_proj = parts[parts.index("self_attn") + 1]
        except (ValueError, IndexError):
            continue
        proj = proj_of[hf_proj]
        slot = found.setdefault(proj, {"a": [None] * n_layers, "b": [None] * n_layers,
                                       "m": [None] * n_layers})
        if "lora_A" in name:
            slot["a"][layer] = arr.T  # (d_in, r)
        elif "lora_B" in name:
            slot["b"][layer] = arr.T  # (r, d_out)
        elif "magnitude" in name:
            slot["m"][layer] = arr
    use_dora = bool(cfg.get("use_dora", False))
    acfg = AdapterConfig(r=cfg["r"], alpha=cfg["lora_alpha"], use_dora=use_dora,
                         targets=",".join(sorted(found)))
    adapters = {}
    for proj, slot in found.items():
        entry = {
            "a": np.stack(slot["a"]).astype(np.float32),
            "b": np.stack(slot["b"]).astype(np.float32),
            "scaling": np.full((n_layers,), acfg.scaling, np.float32),
        }
        if use_dora and slot["m"][0] is not None:
            entry["m"] = np.stack(slot["m"]).astype(np.float32)
        adapters[proj] = entry
    return adapters, acfg


# --------------------------------------------------------------------------
# the weight bridge: gwkit's numpy trees -> the port's parameters
# --------------------------------------------------------------------------

def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return _t(tree)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return _t(np.asarray(tree)[i])


def from_gwkit_numpy(encoder=None, adapters=None, head=None, qadapter=None) -> Dict[str, Any]:
    """gwkit parameter trees (numpy leaves) -> the port's parameters.

    The encoder's stacked ``layers`` (leading n_layers axis, for gwkit's
    ``lax.scan``) become a Python list of per-layer dicts; stacked adapters
    become a per-layer list of {proj: {'a', 'b', 'm', 'scaling'}} with
    ``scaling`` a Python float. Everything is float32 on the CPU;
    ``gwkit_torch.train.tasks.build_mlgwsc`` moves it to its device."""
    out: Dict[str, Any] = {}
    if encoder is not None:
        n_layers = int(np.shape(encoder["layers"]["q"]["w"])[0])
        out["encoder"] = {
            "conv1": _tensors(encoder["conv1"]),
            "conv2": _tensors(encoder["conv2"]),
            "pos": _t(encoder["pos"]),
            "layers": [_unstack(encoder["layers"], i) for i in range(n_layers)],
            "ln_post": _tensors(encoder["ln_post"]),
        }
    if adapters is not None:
        n_layers = int(np.shape(next(iter(adapters.values()))["a"])[0])
        layers = []
        for i in range(n_layers):
            per = {}
            for proj, entry in adapters.items():
                e = {k: _t(np.asarray(v)[i]) for k, v in entry.items() if k != "scaling"}
                e["scaling"] = float(np.asarray(entry.get("scaling", np.ones(n_layers)))[i])
                per[proj] = e
            layers.append(per)
        out["adapters"] = layers
    if head is not None:
        out["head"] = _tensors(head)
    if qadapter is not None:
        out["qadapter"] = _tensors(qadapter)
    return out
