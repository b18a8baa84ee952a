"""int8 quantization for decode (PyTorch/CUDA port of the decode subset
of `incubator_mxnet_tpu/contrib/quantization.py`).

* `quantize_weight` / `quantize_kv` — the symmetric int8 recipe: an f32
  scale ``max(amax, 1e-8) / 127`` per channel (weights) or per head
  vector (KV cache entries), values ``clip(round(x / scale), -127,
  127)``.  ``torch.round`` rounds half to even like ``jnp.round``, and
  the division is a division (not a multiplication by a reciprocal), so
  the scales are bit-identical to the JAX package's.
* `DecodeQuantConfig`, `quantize_for_decode`, `dequantize_decode` — the
  weight-only int8 state of the decode stack (`models.generation`):
  per-output-channel int8 weights and f32 scales for the transformer
  matmuls (a `TransformerLM`'s, or a `Transformer`'s decoder), the
  scale applied in the matmul epilogue.

The post-training quantization half of the JAX module (`quantize_net`,
`QuantizedDense`/`QuantizedConv`, `calibrate`) is not ported yet.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import torch

from ..context import default_device

__all__ = ["quantize_weight", "quantize_kv", "DecodeQuantConfig",
           "quantize_for_decode", "dequantize_decode"]

_SERIAL = itertools.count()


def quantize_weight(w, axis: int = 0):
    """Symmetric per-output-channel int8 quantization: returns (int8
    weights, f32 scale per channel, kept as a broadcastable shape)."""
    w = w.detach().float()              # bf16 nets: quantize in f32
    dims = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    amax = w.abs().amax(dim=dims, keepdim=True)
    scale = amax.clamp(min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv(x):
    """`quantize_weight`'s recipe over the feature dim (axis -1) of KV
    cache entries: returns (int8 values shaped like ``x``, f32 scales
    shaped ``x.shape[:-1]``) — the int8 pool's page-write quantizer
    (the paged-attention kernel dequantizes)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _weight_key(w) -> tuple:
    """What changes when a weight does: PyTorch updates parameters in
    place (optimizer steps, ``copy_``, ``set_data``, ``initialize``,
    `convert.load_jax_params`) and ``cast()`` swaps the storage of the
    same Parameter object, so the key is the storage address, the
    in-place version counter, ``Block.cast``'s count of casts (a round
    trip may reuse the old address), and the dtype, shape and device —
    never the object's identity alone.  A write through ``w.data``
    bumps none of these: see `quantize_for_decode`."""
    return (w.data_ptr(), w._version, getattr(w, "_casts", 0), w.dtype,
            tuple(w.shape), w.device)


class DecodeQuantConfig:
    """Weight-only int8 state of the decode stack: per-output-channel
    int8 weights and f32 scales for the transformer matmuls, consumed by
    `models.generation._gather_params` and applied by
    `models.generation._dense` (the scale in the matmul epilogue, never
    on the weight).

    ``act_quant``:

    * ``"none"`` — weight-only: activations stay in the model dtype and
      the product keeps an f32 accumulator.
    * ``"dynamic"`` — per-row dynamic int8 activations and an exact
      INT8xINT8->INT32 product; adds activation rounding error.
    * ``"auto"`` — ``"dynamic"`` for a net on the CPU and ``"none"`` on
      CUDA, the JAX package's rule off the CPU (resolved once, from
      ``device``; the default device is CUDA).

    Quantized copies are cached per target layer and refreshed when the
    weight's `_weight_key` moves, so an in-place update or a ``cast()``
    is re-quantized lazily at the next gather.
    """

    def __init__(self, act_quant: str = "auto", quantize_head: bool = False,
                 device=None):
        if act_quant == "auto":
            dev = torch.device(device) if device is not None \
                else default_device()
            act_quant = "dynamic" if dev.type == "cpu" else "none"
        if act_quant not in ("none", "dynamic"):
            raise ValueError(
                f"act_quant must be auto|none|dynamic, got {act_quant!r}")
        self.act_quant = act_quant
        self.quantize_head = quantize_head
        self._store: Dict[int, dict] = {}      # id(dense) -> entry
        self._targets: Dict[int, object] = {}  # id(dense) -> dense
        self._serial = next(_SERIAL)

    def cache_key(self) -> tuple:
        """The decode programs' key of this state: the strategy, the
        head flag and which `quantize_for_decode` call made it (the
        JAX package keys on the first two; here each call's int8 copies
        are distinct tensors that a captured program reads in place, and
        a new call re-quantizes a write through ``param.data``)."""
        return ("int8", self.act_quant, self.quantize_head, self._serial)

    def add_target(self, dense) -> None:
        self._targets[id(dense)] = dense

    def packed(self, dense) -> Optional[dict]:
        """``{"w8": int8 (out, in), "s": f32 (out,)}`` for a target
        Dense (plus a ``"dyn"`` marker under dynamic activation
        quantization), re-quantized if its weight changed; None for
        other layers."""
        if id(dense) not in self._targets:
            return None
        w = dense.weight
        key = _weight_key(w)
        ent = self._store.get(id(dense))
        if ent is None or ent["key"] != key:
            q, scale = quantize_weight(w, axis=0)
            ent = {"key": key, "w8": q, "s": scale.reshape(-1)}
            self._store[id(dense)] = ent
        packed = {"w8": ent["w8"], "s": ent["s"]}
        if self.act_quant == "dynamic":
            packed["dyn"] = ()
        return packed

    def refresh(self) -> "DecodeQuantConfig":
        """Re-quantize every stale entry now (else at the next gather)."""
        for dense in self._targets.values():
            self.packed(dense)
        return self

    def weight_bytes(self) -> int:
        """int8 + scale bytes the quantized matmuls read per decode
        step."""
        total = 0
        for dense in self._targets.values():
            ent = self.packed(dense)
            total += ent["w8"].numel() + ent["s"].numel() * 4
        return total


def _decode_target_denses(net, quantize_head: bool):
    """The Dense layers the decode programs multiply by, per model family
    (`contrib/quantization.py:439-462` of the JAX package):
    `models.TransformerLM`'s QKV and output projections and FFN layers;
    `models.Transformer`'s decoder, its self-attention's two, the
    cross-attention's three and the FFN's two a layer; and the logits
    head (``head``, ``out_proj``) with ``quantize_head``.  Any other net
    raises TypeError."""
    from ..models.transformer import Transformer, TransformerLM

    out = []
    if isinstance(net, TransformerLM):
        for lyr in net._layers:
            out += [lyr.attn.qkv, lyr.attn.proj,
                    lyr.ffn.ffn_dense1, lyr.ffn.ffn_dense2]
        head = net.head
    elif isinstance(net, Transformer):
        for lyr in net.decoder._layers:
            out += [lyr.self_attn.qkv, lyr.self_attn.proj,
                    lyr.cross_attn.q_proj, lyr.cross_attn.kv_proj,
                    lyr.cross_attn.proj,
                    lyr.ffn.ffn_dense1, lyr.ffn.ffn_dense2]
        head = net.out_proj
    else:
        raise TypeError(f"quantize_for_decode supports models.TransformerLM "
                        f"and models.Transformer, got {type(net).__name__}")
    if quantize_head:
        out.append(head)
    return out


def quantize_for_decode(net, *, act_quant: str = "auto",
                        quantize_head: bool = False):
    """Mark ``net`` (a `models.TransformerLM` or a `models.Transformer`)
    for weight-quantized decode: its transformer matmul weights (QKV and
    output projections, FFN; for the Transformer the decoder's, with its
    cross-attention's, the encoder staying float; the logits head only
    with ``quantize_head=True``) become per-channel int8 plus f32
    scales, and every later ``generate``, ``score``, ``translate`` and
    serving engine consumes them with the scale in the matmul epilogue.
    Embeddings, LayerNorms and biases stay float.

    The transform is runtime-only: the parameters keep their float
    values, and an update to them is re-quantized lazily.  Use
    `dequantize_decode` (or ``quantized=False`` on the entry points) for
    the float path.  Returns ``net``.

    "An update" is any write the port's surface makes: ``Trainer.step``,
    ``Parameter.set_data``, ``initialize(force_reinit=True)``,
    `convert.load_jax_params`, ``cast()``, and in-place torch ops on a
    parameter under ``torch.no_grad()``.  The cache keys on each
    weight's storage, version counter and casts (`_weight_key`), which
    a write through ``param.data`` (``param.data.copy_(...)``) leaves
    unchanged; such a write keeps serving the old int8 copies until
    ``quantize_for_decode`` runs again.  A check of the contents on
    every decode step would add kernels to a host-bound path.
    """
    targets = _decode_target_denses(net, quantize_head)
    cfg = DecodeQuantConfig(act_quant, quantize_head,
                            device=next(net.parameters()).device)
    for dense in targets:
        cfg.add_target(dense)
    cfg.refresh()
    net._decode_quant = cfg
    return net


def dequantize_decode(net):
    """Drop the marking `quantize_for_decode` set: decode goes back to
    the float path.  Returns ``net``."""
    net._decode_quant = None
    return net
