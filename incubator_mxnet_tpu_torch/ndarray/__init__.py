"""``mx.nd`` of the PyTorch/CUDA port: ops on `torch.Tensor`s
(counterpart of `incubator_mxnet_tpu/ndarray/`).  The port has no
NDArray class; the ops of the BERT and ResNet training paths are
ported, and ``save``/``load``, the ``.params`` codec."""
from .nn_ops import (Activation, BatchNorm, Convolution, Dropout, DropoutAdd,
                     Embedding, FullyConnected, LayerNorm, Pooling, flatten,
                     gelu, log_softmax, softmax_cross_entropy)

__all__ = ["Activation", "BatchNorm", "Convolution", "Dropout", "DropoutAdd",
           "Embedding", "FullyConnected", "LayerNorm", "Pooling", "flatten",
           "gelu", "load", "log_softmax", "save", "softmax_cross_entropy"]


def save(fname, data) -> None:
    """Write a tensor, a list of tensors or a dict name -> tensor in the
    ``.params`` format (`utils.serialization`)."""
    from ..utils import serialization

    serialization.save_ndarrays(fname, data)


def load(fname, device=None):
    """Read a ``.params`` file: a dict name -> tensor, or a list, on
    ``device`` (default: the card)."""
    from ..context import resolve_device
    from ..utils import serialization

    return serialization.load_ndarrays(fname, resolve_device(device))
