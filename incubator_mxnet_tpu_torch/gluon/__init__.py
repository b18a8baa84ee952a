"""Gluon surface of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/`): blocks and parameters, the layers, the
recurrent layers and cells, the losses, the single-device Trainer,
the vision model zoo's ResNets, the data stack and ``utils``."""
from . import data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Trainer",
           "data", "loss", "model_zoo", "nn", "rnn", "utils"]
