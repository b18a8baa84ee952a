"""Devices of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/context.py`).

``cpu()`` and ``gpu(i)`` return `torch.device` objects.  Every entry
point of the port takes a ``device`` argument that defaults to
`default_device()` (``cuda``); `resolve_device` turns it into a
`torch.device` and raises `MXNetError` when CUDA was asked for (or
defaulted to) and no GPU is present.  The port never carries on
silently on the CPU: the CPU path runs only when the caller asks for
``device="cpu"``, as the tests do.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "num_gpus", "default_device", "resolve_device"]


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", device_id)


def num_gpus() -> int:
    """Number of visible CUDA devices (parity: mx.context.num_gpus)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_device() -> torch.device:
    """The device entry points use when the caller names none."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` (None, a string or a `torch.device`) as a
    `torch.device`; raises `MXNetError` for CUDA without a GPU."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev} (cuda or cpu)")
    return dev
