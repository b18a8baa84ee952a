"""Gluon surface of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/`): blocks and parameters, the layers, the
softmax cross-entropy loss, the single-device Trainer, the vision
model zoo's ResNets and the data stack."""
from . import data, loss, model_zoo, nn
from .block import Block, HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Trainer",
           "data", "loss", "model_zoo", "nn"]
