"""Optimizers of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/optimizer/`)."""
from .optimizer import SGD, Adam, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "Adam", "create", "register"]
