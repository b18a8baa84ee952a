"""The fused recurrent layers (counterpart of
`incubator_mxnet_tpu/gluon/rnn/rnn_layer.py`): `RNN` (tanh or ReLU),
`LSTM` and `GRU` over `nd.RNN`, one or more layers, one or two
directions, TNC or NTC.

Each layer keeps its weights in one parameter named ``parameters``, the
reference's packed blob (`ndarray.rnn_impl`), so a JAX package's
``lstm.parameters`` or a ``.params`` file maps onto it 1:1.  The name
shadows `torch.nn.Module.parameters`, so the blob sits in the module's
parameter table without being an attribute: `blob` returns it, and
``named_parameters()``, ``collect_params()`` and the ``.params`` files
see it under its name.  A layer is given its ``input_size`` (the port
has no deferred shapes) and makes its blob on ``device`` (default the
card)."""
from __future__ import annotations

import torch

from ... import autograd
from ... import ndarray as nd
from ...context import resolve_device
from ...ndarray.rnn_impl import param_size
from ..block import HybridBlock, new_parameter
from ..nn.basic_layers import _width

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", device=None,
                 dtype=torch.float32):
        super().__init__()
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"layout {layout!r} (TNC or NTC)")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = _width(type(self).__name__, input_size)
        # the blob takes i2h_weight_initializer, as in the JAX package;
        # the others are accepted for Gluon's signature
        self._parameters["parameters"] = new_parameter(
            (param_size(mode, input_size, hidden_size, num_layers,
                        bidirectional),),
            resolve_device(device), dtype, init=i2h_weight_initializer)

    def blob(self):
        """The packed parameter blob (the parameter ``parameters``)."""
        return self._parameters["parameters"]

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape} for _ in range(n)]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (h, and c for LSTM), on the blob's device and in
        its dtype."""
        p = self.blob()
        return [torch.zeros(info["shape"], dtype=p.dtype, device=p.device)
                for info in self.state_info(batch_size)]

    def forward(self, inputs, states=None):
        """``inputs`` (T, N, C), or (N, T, C) for NTC: the output, and with
        ``states`` given (a list, or one tensor) the list of new states
        after it.  Zero states when none are given; inter-layer dropout
        in `autograd`'s train mode."""
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        ret_states = states is not None
        if states is None:
            states = self.begin_state(inputs.shape[1])
        if isinstance(states, torch.Tensor):
            states = [states]
        out = nd.RNN(inputs, self.blob(), states[0],
                     states[1] if len(states) > 1 else None,
                     mode=self._mode, state_size=self._hidden_size,
                     num_layers=self._num_layers,
                     bidirectional=self._dir == 2, p=self._dropout,
                     training=autograd.is_training())
        y = out[0]
        if self._layout == "NTC":
            y = y.transpose(0, 1)
        if ret_states:
            return y, list(out[1:])
        return y


class RNN(_RNNLayer):
    """Elman RNN, ``activation`` tanh or relu."""

    def __init__(self, hidden_size, num_layers=1, activation="tanh",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        mode = "rnn_tanh" if activation == "tanh" else "rnn_relu"
        super().__init__(mode, hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)
