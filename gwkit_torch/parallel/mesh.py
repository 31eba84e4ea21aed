"""The ("data", "model") mesh and gwkit's sharding rules on
``torch.distributed`` (counterpart of ``gwkit/parallel/mesh.py``).

Axes:
  * "data"  -- batch rows (training) and windows (search);
  * "model" -- tensor parallelism of the attention heads and the MLP's
    hidden width (Megatron).

Rules, per leaf of the port's trees (layers are a list of per-layer dicts,
so a leaf has no leading n_layers axis; gwkit's stacked spec is this one
with ``None`` in front): q, k, v and fc1 split d_out over "model" (their
biases with them); o and fc2 split d_in, their biases replicated; DoRA
adapters follow their base projection (q/k/v: ``b`` and ``m`` split on
d_out; o: ``a`` split on d_in); everything else (conv stem, LayerNorms,
positions, heads, Q-adapter) is replicated. A spec is a tuple with one
entry per axis of the leaf: ``None`` or the mesh axis that splits it.

There is no DTensor: :func:`shard_task_tree` returns this rank's local
slices as plain contiguous tensors, and the encoder's collectives are
explicit calls (:func:`copy_to_model`, :func:`reduce_from_model`,
:func:`gather_model`) on the mesh's process groups, made inside
``with active(mesh):``. A world of one with no process group is a 1x1 mesh
whose collectives are identities.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gwkit_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]


class _SpecLeaf(tuple):
    """A spec as a leaf of a spec tree (a plain tuple would read as a node)."""


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in an (n_data, n_model) mesh, model axis innermost
    (rank = data_index * n_model + model_index, as gwkit's reshape).
    ``data_group`` holds the ranks of this rank's model index, ``model_group``
    those of its data index; both None without a process group. ``calls``
    counts the collectives made, by kind and axis ("all_reduce/data", ...)."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None
    calls: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> Tuple[int, int]:
        return self.n_data, self.n_model

    def barrier(self) -> None:
        if dist.is_initialized():
            self.calls["barrier"] += 1
            dist.barrier()


def make_mesh(n_model: int = 1, device: DeviceLike = None) -> Mesh:
    """The mesh over every rank of the process group (one rank without a
    group). ``device`` holds the collectives' buffers: ``None`` is the CUDA
    card (NCCL, raises without one), ``"cpu"`` gloo. Raises as gwkit's when
    the world size does not divide by ``n_model``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} devices not divisible by model parallelism {n_model}")
    n_data = world // n_model
    if not dist.is_initialized():
        return Mesh(n_data, n_model, 0, dev)
    backend = dist.get_backend()
    if (backend == "nccl") != (dev.type == "cuda"):
        raise ValueError(f"make_mesh: a {backend} process group cannot hold {dev} buffers")
    rank = dist.get_rank()
    data_group = model_group = None
    # every rank creates every group, in the same order
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    return Mesh(n_data, n_model, rank, dev, data_group, model_group)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("gwkit_torch_mesh", default=None)


@contextlib.contextmanager
def active(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """The mesh whose model group a model-sharded encoder layer reduces over
    while the block runs (None: no mesh)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def current_mesh() -> Optional[Mesh]:
    return _ACTIVE.get()


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

def _spec(*axes) -> _SpecLeaf:
    return _SpecLeaf(axes)


def layer_sharding(layer: dict) -> dict:
    """One encoder layer's specs (the Megatron layout)."""
    col = {"w": _spec(None, MODEL_AXIS), "b": _spec(MODEL_AXIS)}  # d_out split
    row = {"w": _spec(MODEL_AXIS, None), "b": _spec(None)}  # d_in split
    out = {}
    for name, entry in layer.items():
        if name in ("q", "k", "v", "fc1"):
            out[name] = {k: col[k] for k in entry}
        elif name in ("o", "fc2"):
            out[name] = {k: row[k] for k in entry}
        else:
            out[name] = replicated(entry)
    return out


def encoder_sharding(encoder: dict) -> dict:
    """Spec tree of the port's encoder parameters."""
    return {name: ([layer_sharding(layer) for layer in sub] if name == "layers" else replicated(sub))
            for name, sub in encoder.items()}


def adapter_layer_sharding(adapters: dict) -> dict:
    """One layer's adapters follow their base projection's layout."""
    out = {}
    for proj, entry in adapters.items():
        if proj in ("q", "k", "v"):
            spec = {"a": _spec(None, None), "b": _spec(None, MODEL_AXIS), "m": _spec(MODEL_AXIS)}
        else:  # the out-projection: d_in split
            spec = {"a": _spec(MODEL_AXIS, None), "b": _spec(None, None), "m": _spec(None)}
        spec["scaling"] = _spec()
        out[proj] = {k: spec[k] for k in entry}
    return out


def adapter_sharding(adapters: List[dict]) -> List[dict]:
    return [adapter_layer_sharding(layer) for layer in adapters]


def replicated(tree: Any) -> Any:
    return _map(lambda t: _spec(*([None] * _ndim(t))), tree)


def batch_sharding(tree: Any) -> Any:
    """The leading axis of every leaf over "data"."""
    return _map(lambda t: _spec(DATA_AXIS, *([None] * (_ndim(t) - 1))), tree)


def task_shardings(tree: dict) -> dict:
    """Spec tree of a task's ``trainable`` or ``frozen`` dict: "encoder"
    takes the Megatron layout, "adapters" follow their base projections,
    everything else (head, Q-adapter) is replicated."""
    out = {}
    for name, sub in tree.items():
        if name == "encoder":
            out[name] = encoder_sharding(sub)
        elif name == "adapters":
            out[name] = adapter_sharding(sub)
        else:
            out[name] = replicated(sub)
    return out


# ---------------------------------------------------------------------------
# Local slices and full leaves
# ---------------------------------------------------------------------------

def _ndim(t) -> int:
    return t.dim() if isinstance(t, torch.Tensor) else np.ndim(t)


def _map(fn, tree, *others):
    """``fn(leaf, *other leaves)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree))
    return fn(tree, *others)


def spec_leaves(specs: Any) -> List[Spec]:
    """The specs of a spec tree in the order of ``gwkit_torch.io.tree_leaves``."""
    if isinstance(specs, _SpecLeaf):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for item in specs for s in spec_leaves(item)]


def _split(mesh: Mesh, spec: Spec) -> Optional[Tuple[int, int, int]]:
    """(axis, parts, index) of the leaf's split on this mesh, or None."""
    for axis, name in enumerate(spec):
        parts = {MODEL_AXIS: mesh.n_model, DATA_AXIS: mesh.n_data}.get(name, 1)
        if parts > 1:
            return axis, parts, mesh.model_index if name == MODEL_AXIS else mesh.data_index
    return None


def shard_leaf(mesh: Mesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's slice of ``t`` (``t`` itself where nothing is split)."""
    split = _split(mesh, spec)
    if split is None:
        return t
    axis, parts, index = split
    if t.shape[axis] % parts:
        raise ValueError(f"axis {axis} of size {t.shape[axis]} does not divide over {parts} ranks")
    k = t.shape[axis] // parts
    return t.detach().narrow(axis, index * k, k).contiguous()


def shard_tree(mesh: Mesh, tree: Any, specs: Any) -> Any:
    return _map(lambda t, s: shard_leaf(mesh, t, s), tree, specs)


def shard_task_tree(mesh: Mesh, tree: dict) -> dict:
    """A task's trainable or frozen dict as this rank's local slices, in the
    standard layout (:func:`task_shardings`)."""
    return shard_tree(mesh, tree, task_shardings(tree))


def shard_params(mesh: Mesh, encoder_params: dict, adapters: Optional[List[dict]] = None,
                 extras: Optional[dict] = None):
    """Each tree's local slices; returns the same structure as gwkit's."""
    out = [shard_tree(mesh, encoder_params, encoder_sharding(encoder_params))]
    if adapters is not None:
        out.append(shard_tree(mesh, adapters, adapter_sharding(adapters)))
    if extras is not None:
        out.append(extras)  # replicated: every rank holds the whole tree
    return out[0] if len(out) == 1 else tuple(out)


def gather_leaf(mesh: Mesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The full leaf from every rank's slice (``t`` where nothing is split)."""
    split = _split(mesh, spec)
    if split is None:
        return t
    axis, _, _ = split
    return _all_gather(mesh, t.detach(), axis, spec[axis])


@torch.no_grad()
def gather_tree(mesh: Mesh, tree: Any, specs: Any) -> Any:
    """Full leaves of a sharded tree (for checkpoints and exports)."""
    return _map(lambda t, s: gather_leaf(mesh, t, s), tree, specs)


def gather_layer(mesh: Mesh, p: dict, adapters: Optional[dict]) -> Tuple[dict, Optional[dict]]:
    """One model-sharded layer's full weights and adapters, differentiable in
    the slices (:func:`gather_model`): the kernel chain takes full weights."""
    def full(t, spec):
        if not isinstance(t, torch.Tensor) or MODEL_AXIS not in spec:
            return t
        return gather_model(t, spec.index(MODEL_AXIS), mesh)

    p = _map(full, p, layer_sharding(p))
    if adapters:
        adapters = _map(full, adapters, adapter_layer_sharding(adapters))
    return p, adapters


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _group(mesh: Mesh, name: str):
    return mesh.data_group if name == DATA_AXIS else mesh.model_group


def _all_gather(mesh: Mesh, t: torch.Tensor, dim: int, name: str) -> torch.Tensor:
    """Every rank's ``t`` along the mesh axis ``name``, concatenated on ``dim``."""
    group = _group(mesh, name)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    mesh.calls[f"all_gather/{name}"] += 1
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _all_reduce_(mesh: Mesh, t: torch.Tensor, name: str) -> torch.Tensor:
    """In place: the sum of ``t`` over the mesh axis ``name``."""
    mesh.calls[f"all_reduce/{name}"] += 1
    dist.all_reduce(t, group=_group(mesh, name))
    return t


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward, the sum over "model" backward
    (a replicated input of a model-parallel region)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(ctx.mesh, g.contiguous().clone(), MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the sum of the partial results over "model" forward,
    the identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_(mesh, x.contiguous().clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The full tensor from the model slices forward; backward this rank's
    slice of the gradient (every model rank computes the same full
    gradient from the same rows)."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh, ctx.k = axis, mesh, x.shape[axis]
        return _all_gather(mesh, x, axis, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.axis, ctx.mesh.model_index * ctx.k, ctx.k), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh) if mesh.n_model > 1 else x


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh) if mesh.n_model > 1 else x


def gather_model(x: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    return _GatherFromModel.apply(x, axis, mesh) if mesh.n_model > 1 else x


def model_sum_(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In place: the sum of ``x`` over "model" (no gradient)."""
    return _all_reduce_(mesh, x, MODEL_AXIS) if mesh.n_model > 1 else x


def data_mean_(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In place: the mean of ``flat`` over "data" (one all_reduce whenever
    the mesh has a process group)."""
    if mesh.data_group is None:
        return flat
    return _all_reduce_(mesh, flat, DATA_AXIS).div_(mesh.n_data)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's rows of ``x``, in rank order (the global batch)."""
    if mesh.data_group is None:
        return x
    return _all_gather(mesh, x, 0, DATA_AXIS)


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n`` (n must divide by n_data)."""
    if n % mesh.n_data:
        raise ValueError(f"batch of {n} does not divide over {mesh.n_data} data ranks")
    k = n // mesh.n_data
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)
