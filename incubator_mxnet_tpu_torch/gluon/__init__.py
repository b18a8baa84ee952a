"""Gluon surface of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/`): blocks and parameters, the layers, the
softmax cross-entropy loss, the single-device Trainer and the vision
model zoo's ResNets."""
from . import loss, model_zoo, nn
from .block import Block, HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Trainer",
           "loss", "model_zoo", "nn"]
