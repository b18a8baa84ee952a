"""Recurrent layers and cells (counterpart of
`incubator_mxnet_tpu/gluon/rnn/`): the fused RNN, LSTM and GRU layers
over `nd.RNN`, and the cells with ``unroll``."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, LSTMCell, RecurrentCell, RNNCell,
                       ResidualCell, SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "HybridRecurrentCell", "RNN", "LSTM", "GRU"]
