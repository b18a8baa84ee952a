"""Contributed extensions of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/contrib/`): the decode subset of `quantization`."""
from . import quantization

__all__ = ["quantization"]
