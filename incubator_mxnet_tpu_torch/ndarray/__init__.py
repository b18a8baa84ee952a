"""``mx.nd`` of the PyTorch/CUDA port: ops on `torch.Tensor`s
(counterpart of `incubator_mxnet_tpu/ndarray/`).  The port has no
NDArray class; the ops of the BERT and ResNet training paths are
ported."""
from .nn_ops import (Activation, BatchNorm, Convolution, Dropout, DropoutAdd,
                     Embedding, FullyConnected, LayerNorm, Pooling, flatten,
                     gelu, log_softmax, softmax_cross_entropy)

__all__ = ["Activation", "BatchNorm", "Convolution", "Dropout", "DropoutAdd",
           "Embedding", "FullyConnected", "LayerNorm", "Pooling", "flatten",
           "gelu", "log_softmax", "softmax_cross_entropy"]
