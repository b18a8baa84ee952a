"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of
`incubator_mxnet_tpu`, slice by slice.

Its layout mirrors the JAX package's so each module's counterpart is
easy to find; it imports torch, numpy and the standard library, never
JAX and nothing of the JAX package.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
from . import (autograd, callback, context, contrib, convert, gluon, image,
               initializer, io, lr_scheduler, metric, models, optimizer, ops,
               random, recordio, serving)
from . import ndarray as nd
from .base import MXNetError
from .context import cpu, gpu, num_gpus
from .initializer import init

__all__ = ["MXNetError", "autograd", "callback", "context", "contrib",
           "convert", "cpu", "gluon", "gpu", "image", "init", "initializer",
           "io",
           "lr_scheduler", "metric", "models", "nd", "num_gpus", "ops",
           "optimizer", "random", "recordio", "serving"]
