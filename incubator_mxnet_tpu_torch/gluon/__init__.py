"""Gluon surface of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/`): blocks and parameters, the layers, the
softmax cross-entropy loss and the single-device Trainer."""
from . import loss, nn
from .block import Block, HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Trainer",
           "loss", "nn"]
