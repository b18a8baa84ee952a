"""The fused multi-layer RNN of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/ndarray/rnn_impl.py`): LSTM, GRU and the tanh and
ReLU RNNs, one or more layers, one or two directions.

The parameters are one packed blob in the reference's layout, which
the JAX package keeps so that ``.params`` files map 1:1: for every
layer and direction in turn the i2h weight (G·H, in) and the h2h weight
(G·H, H), then for every layer and direction the i2h bias and the h2h
bias (G·H each), G the gates (4 for LSTM in the order i, f, g, o; 3 for
GRU in the order r, z, n; 1 otherwise).

Each layer's input product is one matmul over the whole sequence
(hoisted out of the time loop, as in the JAX package); the time loop is
plain torch ops, one ``addmm`` of the hidden state a step and the
cell's elementwise math, where the JAX package runs a ``lax.scan``.
cuDNN's RNN is not used.  Between layers, in training, the output goes
through the port's dropout (`ops.dropout_kernel.fused_dropout`, the
kernel on the card), one fresh seed a layer from the thread's key
stream or the program's seed table; the JAX package draws that mask
with ``jax.random``, so its bits differ.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError
from ..ops.dropout_kernel import fused_dropout

__all__ = ["param_size", "fused_rnn"]

_GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}


def _gates(mode: str) -> int:
    g = _GATES.get(mode)
    if g is None:
        raise MXNetError(f"RNN mode {mode!r} is not one of {sorted(_GATES)}")
    return g


def param_size(mode: str, input_size: int, state_size: int, num_layers: int,
               bidirectional: bool = False) -> int:
    """The packed blob's length (the reference's ``GetParamSize``)."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += d * g * state_size * (in_sz + state_size + 2)
    return size


def _unpack(params, mode, input_size, state_size, num_layers,
            bidirectional):
    """([(w_i2h, w_h2h)], [(b_i2h, b_h2h)]) by layer and direction: views
    of the blob, split in one op (its backward is one concatenation)."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    gh = g * state_size
    shapes = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        shapes += [(gh, in_sz), (gh, state_size)] * d
    shapes += [(gh,)] * (2 * num_layers * d)
    sizes = [s[0] * (s[1] if len(s) > 1 else 1) for s in shapes]
    if params.numel() != sum(sizes):
        raise MXNetError(f"RNN: the parameter blob has {params.numel()} "
                         f"values, {mode} of these sizes needs {sum(sizes)}")
    parts = [t.view(s) for t, s in zip(params.split(sizes), shapes)]
    n = num_layers * d
    weights = [(parts[2 * i], parts[2 * i + 1]) for i in range(n)]
    biases = [(parts[2 * n + 2 * i], parts[2 * n + 2 * i + 1])
              for i in range(n)]
    return weights, biases


def _lstm_step(gates, h, c, H):
    """One LSTM cell: gates (B, 4H) in the order i, f, g, o."""
    s = torch.sigmoid(gates)
    i, f, o = s[:, :H], s[:, H:2 * H], s[:, 3 * H:]
    g = torch.tanh(gates[:, 2 * H:3 * H])
    c = torch.addcmul(f * c, i, g)
    return o * torch.tanh(c), c


def _run_layer(x, w_i2h, w_h2h, b_i2h, b_h2h, h0, c0, mode, state_size,
               reverse=False):
    """One layer in one direction over x (T, B, in): (y (T, B, H), h_T,
    c_T), c_T being h_T where the cell has no memory cell."""
    H = state_size
    if reverse:
        x = x.flip(0)
    T = x.shape[0]
    xg = torch.matmul(x, w_i2h.t()) + b_i2h        # the hoisted product
    wt = w_h2h.t()
    h, c = h0, c0
    ys = []
    if mode == "lstm":
        xg = xg + b_h2h
        for t in range(T):
            h, c = _lstm_step(torch.addmm(xg[t], h, wt), h, c, H)
            ys.append(h)
    elif mode == "gru":
        for t in range(T):
            hg = torch.addmm(b_h2h, h, wt)
            xr, xz, xn = xg[t].split(H, -1)
            hr, hz, hn = hg.split(H, -1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(torch.addcmul(xn, r, hn))
            h = (1 - z) * n + z * h
            ys.append(h)
        c = h
    else:
        act = torch.tanh if mode == "rnn_tanh" else torch.relu
        xg = xg + b_h2h
        for t in range(T):
            h = act(torch.addmm(xg[t], h, wt))
            ys.append(h)
        c = h
    y = torch.stack(ys)
    if reverse:
        y = y.flip(0)
    return y, h, c


def fused_rnn(data, parameters, state, state_cell=None, mode="lstm",
              state_size=0, num_layers=1, bidirectional=False, dropout=0.0,
              training=False):
    """The reference's RNN op: data (T, B, in), state (and for LSTM
    state_cell, zeros if None) (layers·directions, B, H); returns (out
    (T, B, directions·H), h_T, c_T) for LSTM, else (out, h_T).  With
    ``training`` and ``dropout`` the output of every layer but the last
    goes through dropout at that rate."""
    d = 2 if bidirectional else 1
    weights, biases = _unpack(parameters, mode, data.shape[-1], state_size,
                              num_layers, bidirectional)
    c0_all = state_cell if state_cell is not None else torch.zeros_like(state)
    out = data
    hTs, cTs = [], []
    for layer in range(num_layers):
        ys = []
        for di in range(d):
            wi = layer * d + di
            y, hT, cT = _run_layer(out, *weights[wi], *biases[wi],
                                   state[wi], c0_all[wi], mode, state_size,
                                   reverse=di == 1)
            ys.append(y)
            hTs.append(hT)
            cTs.append(cT)
        out = torch.cat(ys, -1) if d == 2 else ys[0]
        if dropout > 0.0 and training and layer < num_layers - 1:
            out = fused_dropout(out, _random.next_seed(), float(dropout))
    hT = torch.stack(hTs)
    if mode == "lstm":
        return out, hT, torch.stack(cTs)
    return out, hT
