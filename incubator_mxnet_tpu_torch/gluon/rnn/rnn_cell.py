"""Recurrent cells (counterpart of
`incubator_mxnet_tpu/gluon/rnn/rnn_cell.py`): `RNNCell`, `LSTMCell`,
`GRUCell`, and `SequentialRNNCell`, `DropoutCell`, `ZoneoutCell`,
`ResidualCell` and `BidirectionalCell` around them.

A cell's call is one time step, ``cell(x_t, states) -> (out, states)``;
`RecurrentCell.unroll` runs the Python time loop over a sequence (the
enclosing block's hybridization captures it).  A cell with weights
keeps the JAX package's names and layouts: ``i2h_weight`` (G·H, in),
``h2h_weight`` (G·H, H), ``i2h_bias`` and ``h2h_bias`` (G·H), G the
gates (LSTM i, f, g, o; GRU r, z, n).  A cell is given its
``input_size`` and makes its weights on ``device`` (default the card).
Zoneout's masks come from the port's keep-mask (`ops.dropout_kernel`);
the JAX package draws them with ``jax.random``, so their bits differ.
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import ndarray as nd
from ... import random as _random
from ...context import resolve_device
from ...ops.dropout_kernel import dropout_mask, dropout_mask_dev
from ..block import HybridBlock, new_parameter
from ..nn.basic_layers import _width

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]


def _sequence_mask(x, length, axis):
    """``x`` with the steps along ``axis`` at or past each row's
    ``length`` set to 0 (rows along the other of axes 0 and 1)."""
    steps = torch.arange(x.shape[axis], device=x.device)
    shape = [1] * x.dim()
    shape[axis] = -1
    batch_axis = 1 - axis if axis in (0, 1) else 0
    lshape = [1] * x.dim()
    lshape[batch_axis] = -1
    keep = steps.reshape(shape) < length.to(x.device).reshape(lshape)
    return torch.where(keep, x, 0.0)


def _sequence_reverse(x, length, axis):
    """Each row's first ``length`` steps along ``axis`` reversed, the
    rest in place; the whole axis reversed without ``length``."""
    if length is None:
        return x.flip(axis)
    xt = x.movedim(axis, 0)                     # (T, B, ...)
    T = xt.shape[0]
    steps = torch.arange(T, device=x.device).reshape(
        (-1,) + (1,) * (xt.dim() - 1))
    lens = length.to(x.device).long().reshape(
        (1, -1) + (1,) * (xt.dim() - 2))
    idx = torch.where(steps < lens, lens - 1 - steps, steps)
    out = xt.gather(0, idx.expand(xt.shape))
    return out.movedim(0, axis)


class RecurrentCell(HybridBlock):
    """A cell: `state_info`, `begin_state`, one step as its call, and
    `unroll`."""

    def __init__(self):
        super().__init__()
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for c in self.children():
            if isinstance(c, RecurrentCell):
                c.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _state_like(self):
        """(device, dtype) of the states: the cell's weights', else the
        card's f32."""
        p = next(self.parameters(), None)
        return (p.device, p.dtype) if p is not None \
            else (resolve_device(None), torch.float32)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states, one for each of `state_info`."""
        infos = self.state_info(batch_size)
        dev, dtype = self._state_like() if infos else (None, None)
        states = []
        for info in infos:
            self._init_counter += 1
            states.append(torch.zeros(info["shape"], dtype=dtype,
                                      device=dev))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """The cell over ``length`` steps of ``inputs`` (``layout`` NTC or
        TNC): (the outputs, stacked along T unless ``merge_outputs`` is
        False, with the steps past ``valid_length`` zeroed; the last
        states)."""
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        states = self.begin_state(batch) if begin_state is None \
            else begin_state
        outputs = []
        for t in range(length):
            out, states = self(inputs.select(axis, t), states)
            outputs.append(out)
        if merge_outputs or merge_outputs is None:
            merged = torch.stack(outputs, axis)
            if valid_length is not None:
                merged = _sequence_mask(merged, valid_length, axis)
            return merged, states
        return outputs, states


class HybridRecurrentCell(RecurrentCell):
    pass


class _GatedCell(HybridRecurrentCell):
    """The weights of a cell of ``gates`` gates."""

    def __init__(self, gates, hidden_size, input_size, init, device, dtype):
        super().__init__()
        self._hidden_size = hidden_size
        dev = resolve_device(device)
        gh = gates * hidden_size
        i2h_w, h2h_w, i2h_b, h2h_b = init
        self.i2h_weight = new_parameter(
            (gh, _width(type(self).__name__, input_size)), dev, dtype,
            init=i2h_w)
        self.h2h_weight = new_parameter((gh, hidden_size), dev, dtype,
                                        init=h2h_w)
        self.i2h_bias = new_parameter((gh,), dev, dtype, init=i2h_b)
        self.h2h_bias = new_parameter((gh,), dev, dtype, init=h2h_b)

    def _products(self, inputs, h):
        i2h = nd.FullyConnected(inputs, self.i2h_weight, self.i2h_bias,
                                flatten=False)
        h2h = nd.FullyConnected(h, self.h2h_weight, self.h2h_bias,
                                flatten=False)
        return i2h, h2h


class RNNCell(_GatedCell):
    """``act(W_i·x + b_i + W_h·h + b_h)``, ``activation`` an
    `nd.Activation` type."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 *, device=None, dtype=torch.float32):
        super().__init__(1, hidden_size, input_size,
                         (i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer),
                         device, dtype)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._products(inputs, states[0])
        out = nd.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 *, device=None, dtype=torch.float32):
        super().__init__(4, hidden_size, input_size,
                         (i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer),
                         device, dtype)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"} for _ in range(2)]

    def forward(self, inputs, states):
        i2h, h2h = self._products(inputs, states[0])
        i, f, g, o = (i2h + h2h).chunk(4, -1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, [h, c]


class GRUCell(_GatedCell):
    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 *, device=None, dtype=torch.float32):
        super().__init__(3, hidden_size, input_size,
                         (i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer),
                         device, dtype)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._products(inputs, states[0])
        xr, xz, xn = i2h.chunk(3, -1)
        hr, hz, hn = h2h.chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * states[0]
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in turn, each on its own slice
    of the states; children named ``"0"``, ``"1"``, ..."""

    def add(self, cell):
        self.add_module(str(len(self._modules)), cell)

    def state_info(self, batch_size=0):
        return [info for c in self._modules.values()
                for info in c.state_info(batch_size)]

    def begin_state(self, batch_size=0, **kwargs):
        return [s for c in self._modules.values()
                for s in c.begin_state(batch_size, **kwargs)]

    def forward(self, inputs, states):
        next_states = []
        p = 0
        for c in self._modules.values():
            n = len(c.state_info())
            inputs, s = c(inputs, states[p:p + n])
            next_states += s
            p += n
        return inputs, next_states

    def __len__(self):
        return len(self._modules)


class DropoutCell(HybridRecurrentCell):
    """`nd.Dropout` of each step's input (``axes`` sharing the mask), in
    `autograd`'s train mode; no states."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self._rate > 0:
            inputs = nd.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class _ModifierCell(HybridRecurrentCell):
    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)


def _zoned(like, rate):
    """A bool mask, each element true with probability ``rate`` (the
    complement of the port's keep-mask at that rate)."""
    seed = _random.next_seed()
    fn = dropout_mask_dev if isinstance(seed, torch.Tensor) \
        else dropout_mask
    return fn(like, seed, rate) == 0


class ZoneoutCell(_ModifierCell):
    """In train mode, each output element keeps the previous step's
    output with probability ``zoneout_outputs`` and each state element
    its previous value with probability ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def forward(self, inputs, states):
        out, new_states = self.base_cell(inputs, states)
        if autograd.is_training():
            if self.zoneout_outputs > 0:
                prev = self._prev_output if self._prev_output is not None \
                    else out * 0
                out = torch.where(_zoned(out, self.zoneout_outputs), prev,
                                  out)
            if self.zoneout_states > 0:
                new_states = [
                    torch.where(_zoned(s_new, self.zoneout_states), s_old,
                                s_new)
                    for s_new, s_old in zip(new_states, states)]
        self._prev_output = out
        return out, new_states


class ResidualCell(_ModifierCell):
    """The base cell's output plus its input."""

    def forward(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed
    (each row's first ``valid_length`` steps), their outputs
    concatenated; `unroll` only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__()
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) \
            + self.r_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.l_cell.begin_state(batch_size, **kwargs) \
            + self.r_cell.begin_state(batch_size, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        if begin_state is None:
            begin_state = self.begin_state(batch)
        nl = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(length, inputs,
                                             begin_state[:nl], layout, True,
                                             valid_length)
        rev = _sequence_reverse(inputs, valid_length, axis)
        r_out, r_states = self.r_cell.unroll(length, rev, begin_state[nl:],
                                             layout, True, valid_length)
        r_out = _sequence_reverse(r_out, valid_length, axis)
        out = torch.cat([l_out, r_out], 2 if layout == "NTC" else -1)
        return out, l_states + r_states

    def forward(self, inputs, states):
        raise NotImplementedError("BidirectionalCell supports only unroll()")
