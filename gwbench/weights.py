"""The classifier's DoRA adapters and head, made on the card from the seed
in two large draws of a ``torch.Generator`` on the weights' device. The
family is the port's and gwkit's init: DoRA's A U(+-1/sqrt(d_in)), its B
N(0, ``lora_b_std``^2) (non-zero, so the adapters count), its magnitude the
column norms of the base weight; the head's weights and biases
U(+-1/sqrt(fan_in)), the first layer then routed through the spread of the
embeddings it reads (``head_through_spread``). The tree is the port's
parameter layout; the reference gets a copy made before the port sees it."""
from __future__ import annotations

import math

import torch


def _put(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value


def adapters_and_head(cfg: dict, seed: int, device, base: dict) -> dict:
    """{"adapters", "head"} of float32 tensors on ``device``; ``base`` is the
    encoder read from its file (``reference.weights.encoder``), whose base
    weights give the adapters' magnitudes."""
    d, r, L = cfg["d_model"], cfg["adapters"]["r"], cfg["encoder_layers"]
    targets = cfg["adapters"]["targets"]
    dims = [2 * d, *cfg["head"]["widths"], cfg["head"]["num_classes"]]
    uniform = [(("adapters", i, name, "a"), (d, r), d) for i in range(L) for name in targets]
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        uniform += [(("head", j, "w"), (a, b), a), (("head", j, "b"), (b,), a)]
    normal = [(("adapters", i, name, "b"), (r, d)) for i in range(L) for name in targets]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=gen, device=device) * 2 - 1
    gauss = torch.randn(sum(math.prod(s) for _, s in normal), generator=gen, device=device)
    tree = {"adapters": [{name: {} for name in targets} for _ in range(L)], "head": [{} for _ in dims[1:]]}
    at = 0
    for path, shape, fan_in in uniform:
        n = math.prod(shape)
        _put(tree, path, (flat[at: at + n].reshape(shape) / math.sqrt(fan_in)).contiguous())
        at += n
    at = 0
    for path, shape in normal:
        n = math.prod(shape)
        _put(tree, path, (gauss[at: at + n].reshape(shape) * cfg["weights"]["lora_b_std"]).contiguous())
        at += n
    scaling = torch.tensor(cfg["adapters"]["alpha"] / r, device=device)
    for i, layer in enumerate(tree["adapters"]):
        for name, entry in layer.items():
            entry["m"] = torch.from_numpy(base["layers"][i][name]["w"]).to(device).norm(dim=0)
            entry["scaling"] = scaling.clone()
    return tree


def head_through_spread(head: list, emb: torch.Tensor) -> None:
    """Route the head's first layer through the spread of what it reads, in
    place: W <- C W, with C the covariance of ``emb`` (the reference's
    float32 last-token embeddings of a calibration sample, rows of
    2 * d_model), scaled so that each unit's input keeps the drawn layer's
    spread (1/sqrt(3)) over the sample, and the bias shifted by the
    sample's mean. The last token of a 1 s window padded to Whisper's 30 s
    moves with its input by about a hundredth of its size, almost all of it
    along two directions. A head drawn alone reads mostly the part common to
    every input, so its logits would tell inputs apart by less than
    bfloat16's error; a trained head reads the part that moves, as this one
    does."""
    x = emb.double()
    mean = x.mean(dim=0)
    xc = x - mean
    w = (xc.T @ xc / x.shape[0]) @ head[0]["w"].double()
    spread = (xc @ w).pow(2).mean().sqrt()
    w = w / (spread * math.sqrt(3.0))
    head[0]["b"] = (head[0]["b"].double() - mean @ w).float().contiguous()
    head[0]["w"] = w.float().contiguous()


def copy_tree(tree):
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [copy_tree(v) for v in tree]
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree
