"""The word-level LSTM language model of the PyTorch/CUDA port (a
port-only module): `WordLM` is the model that
`examples/gluon/word_language_model.py` builds (``build_model``),
Embedding → dropout → multi-layer LSTM (inter-layer dropout) → dropout
→ a decoder over the vocabulary, either its own `Dense` or tied to the
embedding (one shared weight, the decoder keeping only
``decoder_bias``).  Parameter names are the JAX example's
(``embed.weight``, ``lstm.parameters``, ``decoder.weight`` and
``decoder.bias`` or ``decoder_bias``), so `convert.load_jax_params`
carries its weights.  The upstream example's large configuration is
650 wide, 2 layers, dropout 0.5, tied."""
from __future__ import annotations

import torch

from .. import ndarray as nd
from ..context import resolve_device
from ..gluon import nn, rnn
from ..gluon.block import HybridBlock, new_parameter

__all__ = ["WordLM"]


class WordLM(HybridBlock):
    """``forward(x, states) -> (logits, new_states)``: x (bptt, batch)
    tokens, states the LSTM's [h, c] (`begin_state`), logits (bptt,
    batch, vocab).  Made on ``device`` (default the card)."""

    def __init__(self, vocab_size, emsize=650, nhid=650, nlayers=2,
                 dropout=0.5, tied=False, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if tied and emsize != nhid:
            raise ValueError("tied weights require emsize == nhid")
        dev = resolve_device(device)
        self._tied = tied
        self.embed = nn.Embedding(vocab_size, emsize, device=dev,
                                  dtype=dtype)
        self.drop = nn.Dropout(dropout)
        self.lstm = rnn.LSTM(nhid, num_layers=nlayers, layout="TNC",
                             dropout=dropout, input_size=emsize, device=dev,
                             dtype=dtype)
        if tied:
            self.decoder_bias = new_parameter((vocab_size,), dev, dtype,
                                              init="zeros")
        else:
            self.decoder = nn.Dense(vocab_size, nhid, flatten=False,
                                    device=dev, dtype=dtype)

    def begin_state(self, batch_size):
        return self.lstm.begin_state(batch_size)

    def forward(self, x, states):
        emb = self.drop(self.embed(x))
        out, new_states = self.lstm(emb, states)
        out = self.drop(out)
        if self._tied:
            logits = nd.FullyConnected(out, self.embed.weight,
                                       self.decoder_bias, flatten=False)
        else:
            logits = self.decoder(out)
        return logits, new_states
