"""Neural-network layers (counterpart of
`incubator_mxnet_tpu/gluon/nn/`)."""
from .basic_layers import Dense, Dropout, DropoutAdd, Embedding, LayerNorm

__all__ = ["Dense", "Dropout", "DropoutAdd", "Embedding", "LayerNorm"]
