"""Errors of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/base.py`)."""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""
