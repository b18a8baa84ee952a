"""``mx.nd`` of the PyTorch/CUDA port: ops on `torch.Tensor`s
(counterpart of `incubator_mxnet_tpu/ndarray/`).  The port has no
NDArray class; the ops of the BERT training path are ported."""
from .nn_ops import (Activation, Dropout, DropoutAdd, Embedding,
                     FullyConnected, LayerNorm, gelu, log_softmax,
                     softmax_cross_entropy)

__all__ = ["Activation", "Dropout", "DropoutAdd", "Embedding",
           "FullyConnected", "LayerNorm", "gelu", "log_softmax",
           "softmax_cross_entropy"]
