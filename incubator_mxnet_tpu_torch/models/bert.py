"""Attention and feed-forward blocks (counterpart of the
`MultiHeadAttention` and `PositionwiseFFN` of
`incubator_mxnet_tpu/models/bert.py`).  Layout (batch, seq, hidden)
throughout; children and parameter names are the JAX package's."""
from __future__ import annotations

import torch

from ..gluon.block import HybridBlock
from ..gluon.nn import Dense
from ..ops.flash_attention import flash_attention
from .generation import _activation, _qkv_heads

__all__ = ["MultiHeadAttention", "PositionwiseFFN"]


class MultiHeadAttention(HybridBlock):
    """Self-attention through the flash kernel: ``qkv`` projects to
    (B, T, 3C), split in the order of `generation._qkv_heads`, and
    ``proj`` maps the heads back.  Padding masks are not ported."""

    _causal_attn = False  # _CausalSelfAttention flips this

    def __init__(self, units, num_heads, dropout=0.0, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._dropout = dropout
        self.qkv = Dense(3 * units, units, device=device, dtype=dtype)
        self.proj = Dense(units, units, device=device, dtype=dtype)

    def forward(self, x):
        B, T, C = x.shape
        q, k, v = _qkv_heads(self.qkv(x), self._num_heads)   # (B, T, H, D)
        out = flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=self._causal_attn)
        return self.proj(out.transpose(1, 2).reshape(B, T, C))


class PositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 *, device=None, dtype=torch.float32):
        super().__init__()
        self.ffn_dense1 = Dense(hidden_size, units, device=device,
                                dtype=dtype)
        self.ffn_dense2 = Dense(units, hidden_size, device=device,
                                dtype=dtype)
        self._act = activation

    def forward(self, x):
        return self.ffn_dense2(_activation(self.ffn_dense1(x), self._act))
