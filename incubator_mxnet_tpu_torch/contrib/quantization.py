"""int8 quantization (PyTorch/CUDA port of
`incubator_mxnet_tpu/contrib/quantization.py`): post-training
quantization of Gluon nets, and the int8 weights of the decode stack.

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

* `calibrate`, `QuantizedConv`, `QuantizedDense`, `quantize_net` —
  post-training quantization: a net's Dense and Conv1D/2D/3D layers
  (ResNet-50 v1's 53 convolutions and its Dense) calibrated on a few
  batches (``minmax``, or ``entropy``: the KL-divergence threshold
  search, in numpy, the JAX package's code and thresholds), then
  swapped for int8 layers: per-channel int8 weights snapshotted at the
  swap, a per-tensor activation scale ``max(threshold, 1e-8) / 127``,
  and the product through `ops.int8_conv` (the hand-written int8
  implicit-GEMM kernel on the card; ``int8_dense`` its GEMM case).
  Each swapped layer stays in the tree as the ``src`` child of a
  `_QuantizedWrapper`, so ``save_parameters`` writes the float
  parameters under the JAX package's keys.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import ndarray as nd
from ..context import default_device
from ..gluon.block import Block, HybridBlock
from ..ops.int8_conv import int8_conv, int8_dense

__all__ = ["quantize_weight", "quantize_kv", "calibrate", "QuantizedDense",
           "QuantizedConv", "quantize_net", "DecodeQuantConfig",
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


def _entropy_threshold(hist, edges, num_quantized_bins=255):
    """The KL-divergence threshold search of ``calib_mode="entropy"``
    (the JAX package's, line for line, so the thresholds are equal)."""
    def kl(p, q):
        p = p / max(p.sum(), 1e-12)
        q = q / max(q.sum(), 1e-12)
        mask = p > 0
        qq = np.where(q > 0, q, 1e-12)
        return float((p[mask] * np.log(p[mask] / qq[mask])).sum())

    n = len(hist)
    best_d, best_t = np.inf, edges[-1]
    for i in range(num_quantized_bins // 2, n + 1, max(1, n // 32)):
        ref = hist[:i].astype("float64").copy()
        ref[i - 1] += hist[i:].sum()    # clip outliers into the edge bin
        factor = i / num_quantized_bins
        q = np.zeros(i)
        for j in range(num_quantized_bins):
            lo = int(j * factor)
            hi = max(int((j + 1) * factor), lo + 1)
            chunk = ref[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
        d = kl(ref, q)
        if d < best_d:
            best_d, best_t = d, edges[i]
    return best_t


def _host_f32(a) -> np.ndarray:
    """A tensor (any device or dtype) or array as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def calibrate(activations: List, mode: str = "minmax") -> float:
    """The activation threshold of calibration batches: the largest
    ``|x|`` (``minmax``) or the entropy search over a 2048-bin
    histogram of ``|x|`` (``entropy``)."""
    flat = np.concatenate([np.abs(_host_f32(a)).ravel()
                           for a in activations])
    if mode == "minmax":
        return float(flat.max())
    if mode == "entropy":
        hist, edges = np.histogram(flat, bins=2048)
        return float(_entropy_threshold(hist, edges))
    raise ValueError(f"unknown calib_mode {mode!r} (minmax|entropy)")


class _Quantized:
    """The int8 state both quantized layers share, snapshotted from the
    float ``layer`` at construction: int8 weights and their f32 scales
    per output channel (`quantize_weight`), the f32 bias, the activation
    scale ``max(threshold, 1e-8) / 127``, ``act_scale * w_scale`` (the
    epilogue's f32 factor) and the fused activation."""

    def __init__(self, layer, act_threshold: float):
        w = layer.weight.detach()
        self.w_q, w_scale = quantize_weight(w, axis=0)
        self.w_scale = w_scale.reshape(-1)
        self.bias = None if layer.bias is None \
            else layer.bias.detach().float()
        self.act_scale = max(act_threshold, 1e-8) / 127.0
        self.scale = torch.tensor([self.act_scale], dtype=torch.float32,
                                  device=w.device) * self.w_scale
        self.activation = getattr(layer, "_activation", None)
        self._src = layer

    def _act(self, out):
        return nd.Activation(out, act_type=self.activation) \
            if self.activation else out


class QuantizedConv(_Quantized):
    """Inference Conv1D/2D/3D over int8 weights (`ops.int8_conv`), with
    the float layer's groups, stride, padding, dilation and activation;
    the output keeps x's dtype."""

    def __init__(self, conv, act_threshold: float):
        super().__init__(conv, act_threshold)
        self.stride = tuple(conv._strides)
        self.pad = tuple(conv._padding)
        self.dilate = tuple(conv._dilation)
        self.groups = int(conv._groups)

    def __call__(self, x):
        return self._act(int8_conv(x, self.w_q, self.scale, self.act_scale,
                                   self.bias, self.stride, self.pad,
                                   self.dilate, self.groups))


class QuantizedDense(_Quantized):
    """Inference Dense over int8 weights (`ops.int8_dense`): with the
    float layer's ``flatten`` an input of more than two dims is folded
    to (N, -1), else the product is over its last axis; the activation
    survives; the output keeps x's dtype."""

    def __call__(self, x):
        lead = None
        if getattr(self._src, "_flatten", False) and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        elif x.dim() > 2:
            lead = x.shape[:-1]
            x = x.reshape(-1, x.shape[-1])
        out = int8_dense(x, self.w_q, self.scale, self.act_scale, self.bias)
        if lead is not None:
            out = out.reshape(*lead, -1)
        return self._act(out)


_SAMPLE_CAP = 1 << 16


def quantize_net(net, calib_data, calib_mode: str = "minmax",
                 layer_types=("Dense", "Conv1D", "Conv2D", "Conv3D")):
    """Post-training-quantize ``net``'s Dense and convolution layers in
    place and return it.

    Every layer whose class is named in ``layer_types`` (searched below
    non-target blocks) gets a forward pre-hook; the batches of
    ``calib_data`` (tensors, or arrays moved to the net's device) run
    through the net eagerly, every block's hybridization switched off
    for them; each hook keeps its layer's running ``|x|`` max and, for
    ``entropy``, up to 65,536 values of each batch (a subsample drawn by
    ``numpy.random.RandomState(<batches seen>)``, as the JAX package
    draws it).  The hooks are removed (a user's own hooks stay), each
    layer's threshold taken (`calibrate`'s rules over those statistics)
    and the layer swapped for a `_QuantizedWrapper` under its name; a
    layer no batch reached raises ValueError.  Every block's captured
    programs are dropped, so a hybridized net captures the int8 program
    at its next call."""
    targets = []

    def walk(block):
        for name, child in list(block._modules.items()):
            if type(child).__name__ in layer_types:
                targets.append((block, name, child))
            elif child is not None:
                walk(child)

    walk(net)
    records: Dict[int, dict] = {id(c): {"amax": 0.0, "samples": [],
                                        "hits": 0} for _, _, c in targets}

    def make_hook(key):
        def hook(blk, inputs):
            a = np.abs(_host_f32(inputs[0]))
            rec = records[key]
            rec["hits"] += 1
            if a.size:
                rec["amax"] = max(rec["amax"], float(a.max()))
            flat = a.ravel()
            if calib_mode == "entropy":
                if flat.size > _SAMPLE_CAP:
                    idx = np.random.RandomState(len(rec["samples"])) \
                        .choice(flat.size, _SAMPLE_CAP, replace=False)
                    flat = flat[idx]
                rec["samples"].append(flat)
        return hook

    handles = [child.register_forward_pre_hook(make_hook(id(child)))
               for _, _, child in targets]
    blocks = [m for m in net.modules() if isinstance(m, Block)]
    saved = [(b, b._hybrid) for b in blocks]
    for b in blocks:
        b._hybrid = False
    dev = next(net.parameters()).device
    try:
        for batch in calib_data:
            net(batch if isinstance(batch, torch.Tensor)
                else torch.as_tensor(np.asarray(batch), device=dev))
    finally:
        for b, hyb in saved:
            b._hybrid = hyb
        for h in handles:
            h.remove()
    for parent, name, child in targets:
        rec = records[id(child)]
        if rec["hits"] == 0:
            raise ValueError(
                f"quantize_net: layer {name!r} of {type(parent).__name__} "
                f"saw no calibration activations — the calib_data batches "
                f"never exercised it")
        setattr(parent, name, _QuantizedWrapper(
            child, _threshold_from_stats(rec, calib_mode)))
    for b in net.modules():
        if isinstance(b, Block):
            b._invalidate_cached_program()
    return net


def _threshold_from_stats(rec: dict, mode: str) -> float:
    if rec["amax"] == 0.0:
        return 1e-8                     # only zeros seen: any scale is exact
    if mode == "minmax":
        return rec["amax"]
    if mode == "entropy":
        flat = np.concatenate(rec["samples"]) if rec["samples"] \
            else np.asarray([rec["amax"]])
        hist, edges = np.histogram(flat, bins=2048, range=(0.0, rec["amax"]))
        return float(_entropy_threshold(hist, edges))
    raise ValueError(f"unknown calib_mode {mode!r} (minmax|entropy)")


class _QuantizedWrapper(HybridBlock):
    """The int8 layer in the tree: its registered child ``src`` keeps the
    float parameters (``save_parameters`` writes them, as in the JAX
    package: quantization is a runtime transform, not a format), its
    forward the int8 one (`QuantizedConv` or `QuantizedDense`)."""

    def __init__(self, layer, threshold: float):
        super().__init__()
        self.src = layer
        qcls = QuantizedConv if type(layer).__name__.startswith("Conv") \
            else QuantizedDense
        self._qd = qcls(layer, threshold)

    def forward(self, x):
        return self._qd(x)


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
