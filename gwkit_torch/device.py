"""Device resolution for the port's entry points.

The counterpart of ``gwkit/utils/platform.py`` in role only: gwkit picks its
backend from JAX's device list; the port's entry points take an explicit
``device`` whose default is the CUDA card. A missing card is an error, never
a silent run on the CPU — callers that mean the CPU say ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises if CUDA is unavailable); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gwkit_torch: no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"gwkit_torch: device {dev} requested but CUDA is unavailable")
    return dev


@contextlib.contextmanager
def no_tf32_convs():
    """cuDNN convolutions in full float32 for the duration: a float32
    convolution on the card otherwise runs in TF32 (about three digits),
    which gwkit's float32 reference does not."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
