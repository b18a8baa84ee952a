"""Gluon surface of the PyTorch/CUDA port: the block base and the
layers the serving slice runs (counterpart of
`incubator_mxnet_tpu/gluon/`)."""
from . import nn
from .block import Block, HybridBlock

__all__ = ["Block", "HybridBlock", "nn"]
