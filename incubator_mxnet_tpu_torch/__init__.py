"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of
`incubator_mxnet_tpu`, slice by slice.

Its layout mirrors the JAX package's so each module's counterpart is
easy to find; it imports torch, numpy and the standard library, never
JAX and nothing of the JAX package.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
from . import (autograd, context, contrib, convert, gluon, initializer,
               lr_scheduler, models, optimizer, ops, random, serving)
from . import ndarray as nd
from .base import MXNetError
from .context import cpu, gpu, num_gpus

__all__ = ["MXNetError", "autograd", "context", "contrib", "convert", "cpu",
           "gluon", "gpu", "initializer", "lr_scheduler", "models", "nd",
           "num_gpus", "ops", "optimizer", "random", "serving"]
