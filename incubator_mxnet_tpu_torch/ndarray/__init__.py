"""``mx.nd`` of the PyTorch/CUDA port: ops on `torch.Tensor`s
(counterpart of `incubator_mxnet_tpu/ndarray/`).  The port has no
NDArray class; the neural-network ops (`nn_ops`) and the fused RNN
(`rnn_impl`) are ported, and ``save``/``load``, the ``.params``
codec."""
from .nn_ops import (RNN, Activation, BatchNorm, Convolution, Deconvolution,
                     Dropout, DropoutAdd, Embedding, FullyConnected,
                     GroupNorm, InstanceNorm, L2Normalization, LayerNorm,
                     LeakyReLU, Pooling, SoftmaxOutput, UpSampling, flatten,
                     gelu, log_softmax, masked_log_softmax, masked_softmax,
                     smooth_l1, softmax, softmax_cross_entropy, softmin)

__all__ = ["Activation", "BatchNorm", "Convolution", "Deconvolution",
           "Dropout", "DropoutAdd", "Embedding", "FullyConnected",
           "GroupNorm", "InstanceNorm", "L2Normalization", "LayerNorm",
           "LeakyReLU", "Pooling", "RNN", "SoftmaxOutput", "UpSampling",
           "flatten", "gelu", "load", "log_softmax", "masked_log_softmax",
           "masked_softmax", "save", "smooth_l1", "softmax",
           "softmax_cross_entropy", "softmin"]


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
