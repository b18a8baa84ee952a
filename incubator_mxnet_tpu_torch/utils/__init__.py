"""Utilities of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/utils/`): the ``.params`` codec."""
from . import serialization

__all__ = ["serialization"]
