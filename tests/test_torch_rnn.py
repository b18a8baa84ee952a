"""The recurrent modules of the PyTorch/CUDA port against the JAX
package's, on the same numpy inputs from a seed, f32 on the CPU:

* `ndarray.rnn_impl`: ``param_size`` and `fused_rnn` (`nd.RNN`) for
  lstm, gru, rnn_tanh and rnn_relu, one and two layers, one and two
  directions, over the same packed blob: the output, the final states
  and the gradients of the input, the blob and the initial states
  (``jax.vjp`` of the JAX op's ``lax.scan``); the inter-layer dropout
  at its place, through the port's dropout on the CPU (its stream is
  not JAX's, so it is held to the port's own composition);
* `gluon.rnn`'s LSTM, GRU and RNN layers (TNC and NTC, with and without
  states; the blob carried by name as ``parameters``, also through a
  ``.params`` file the JAX package wrote), hybridized too, where the
  captured program takes and returns the state lists;
* the cells: RNNCell, LSTMCell, GRUCell unrolled, SequentialRNNCell with
  DropoutCell and ResidualCell, BidirectionalCell with ``valid_length``,
  ZoneoutCell.

Single ops within 1e-5·|ref| + 1e-5·max|ref| (forward) and
1e-4·|ref| + 1e-5·max|ref| (gradients), per element
(`test_torch_conv_layers`); the unrolled loops of 5 steps within the
same bounds.  The JAX layers and cells run hybridized (one compiled
program each), which keeps this file's time small.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon import rnn as jrnn
from incubator_mxnet_tpu.ndarray import rnn_impl as jri
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import MXNetError, autograd, nd
from incubator_mxnet_tpu_torch import random as mxr
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import rnn
from incubator_mxnet_tpu_torch.ndarray import rnn_impl
from incubator_mxnet_tpu_torch.ops import dropout_kernel as dk
from test_torch_conv_layers import (FWD_TOL, GRAD_TOL, _close, _randn,
                                    _vjp_pair)

torch.set_num_threads(1)  # six xdist workers share the cores

T, B, I, H = 5, 3, 4, 6

RNN_CASES = [
    # mode, layers, bidirectional
    ("lstm", 2, True), ("gru", 2, False), ("gru", 1, True),
    ("rnn_tanh", 2, True), ("rnn_relu", 1, False),
]


def test_param_size_matches_jax():
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for L in (1, 3):
            for bi in (False, True):
                assert rnn_impl.param_size(mode, 7, 5, L, bi) \
                    == jri.param_size(mode, 7, 5, L, bi)
    with pytest.raises(MXNetError):
        rnn_impl.param_size("lstm2", 7, 5, 1)


@pytest.mark.parametrize("case", range(len(RNN_CASES)))
def test_fused_rnn_matches_jax(case):
    """`nd.RNN` over one packed blob: the output and the final states
    (flattened into one vector) and the gradients of the input, the
    blob, h0 and (LSTM) c0."""
    mode, L, bi = RNN_CASES[case]
    d = 2 if bi else 1
    rs = onp.random.RandomState(case)
    n = rnn_impl.param_size(mode, I, H, L, bi)
    arrays = [_randn(rs, T, B, I), _randn(rs, n, scale=0.4),
              _randn(rs, L * d, B, H, scale=0.5)]
    if mode == "lstm":
        arrays.append(_randn(rs, L * d, B, H, scale=0.5))
    kw = dict(mode=mode, state_size=H, num_layers=L, bidirectional=bi)

    def jfn(x, p, h, *c):
        outs = jri.fused_rnn(NDArray(x), NDArray(p), NDArray(h),
                             NDArray(c[0]) if c else None, **kw)
        return jnp.concatenate([o._data.ravel() for o in outs])

    def tfn(x, p, h, *c):
        outs = nd.RNN(x, p, h, c[0] if c else None, **kw)
        assert outs[0].shape == (T, B, d * H)
        assert len(outs) == (3 if mode == "lstm" else 2)
        return torch.cat([o.reshape(-1) for o in outs])

    _vjp_pair(jfn, tfn, arrays, 800 + case)


def test_fused_rnn_blob_size_is_checked():
    with pytest.raises(MXNetError):
        nd.RNN(torch.zeros(T, B, I), torch.zeros(10), torch.zeros(1, B, H),
               mode="gru", state_size=H)


def test_inter_layer_dropout_is_the_ports_dropout():
    """In training with p > 0 each layer's output but the last goes
    through the port's dropout (one seed a layer from the key stream;
    on the CPU the kernel's plain version, no launch): the 3-layer op
    equals its layers run one by one with `fused_dropout` between them
    at the same seeds; at p = 0 or outside training it is the plain
    stack."""
    rs = onp.random.RandomState(3)
    x = torch.from_numpy(_randn(rs, T, B, I))
    blobs = [torch.from_numpy(_randn(rs, rnn_impl.param_size(
        "lstm", I if i == 0 else H, H, 1), scale=0.4)) for i in range(3)]
    # one 3-layer blob from three 1-layer blobs: weights, then biases
    cut = [(4 * H * (I if i == 0 else H) + 4 * H * H) for i in range(3)]
    blob = torch.cat([b[:c] for b, c in zip(blobs, cut)]
                     + [b[c:] for b, c in zip(blobs, cut)])
    h0 = torch.zeros(3, B, H)
    kw = dict(mode="lstm", state_size=H)
    launches = dk.dropout_mask.launches
    mxr.seed(5, device="cpu")
    out, hT, cT = rnn_impl.fused_rnn(x, blob, h0, None, num_layers=3,
                                     dropout=0.3, training=True, **kw)
    mxr.seed(5, device="cpu")
    y, want_h = x, []
    for i in range(3):
        y, h, c = rnn_impl.fused_rnn(y, blobs[i], h0[i:i + 1], None,
                                     num_layers=1, **kw)
        want_h.append(h)
        if i < 2:
            y = dk.fused_dropout(y, mxr.next_seed(), 0.3)
    assert torch.equal(out, y) and torch.equal(hT, torch.cat(want_h))
    assert dk.dropout_mask.launches == launches
    plain = rnn_impl.fused_rnn(x, blob, h0, None, num_layers=3, **kw)
    for p, training in ((0.0, True), (0.3, False)):
        got = rnn_impl.fused_rnn(x, blob, h0, None, num_layers=3,
                                 dropout=p, training=training, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert not torch.equal(out, plain[0])


def _carry(jnet, tnet):
    return load_jax_params(tnet, {
        k: onp.asarray(p.data()._data)
        for k, p in jnet._collect_params_with_prefix().items()})


LAYER_CASES = [
    # class, kwargs, layout, with states
    ("LSTM", dict(num_layers=2), "TNC", True),
    ("GRU", dict(bidirectional=True), "NTC", True),
    ("RNN", dict(activation="relu", bidirectional=True), "TNC", False),
]


@pytest.mark.parametrize("case", range(len(LAYER_CASES)))
def test_rnn_layers_match_jax(case):
    """The fused layers with the blob carried by name
    (``parameters``): output, the new states when states are given
    (from random initial ones) and the gradients of the input and the
    blob; eager, and hybridized over two calls (a capture and a replay
    of the program, which takes and returns the state lists)."""
    name, kw, layout, with_states = LAYER_CASES[case]
    rs = onp.random.RandomState(case)
    mx.random.seed(case)
    jnet = getattr(jrnn, name)(H, layout=layout, input_size=I, **kw)
    jnet.initialize(mx.init.Uniform(0.3))
    jnet.hybridize()
    x = _randn(rs, *((T, B, I) if layout == "TNC" else (B, T, I)))
    states = [_randn(rs, *info["shape"], scale=0.5)
              for info in jnet.state_info(B)] if with_states else None
    jx = NDArray(jnp.asarray(x))
    jx.attach_grad()
    with mx.autograd.record():
        jout = jnet(jx, [NDArray(jnp.asarray(s)) for s in states]) \
            if with_states else jnet(jx)
    jy, jst = jout if with_states else (jout, [])
    ct = rs.randn(*jy.shape).astype(onp.float32)
    jy.backward(NDArray(jnp.asarray(ct)))
    for hybrid in (False, True):
        tnet = _carry(jnet, getattr(rnn, name)(H, layout=layout,
                                              input_size=I, device="cpu",
                                              **kw))
        assert [n for n, _ in tnet.named_parameters()] == ["parameters"]
        if hybrid:
            tnet.hybridize()
        tx = torch.tensor(x, requires_grad=True)
        for _ in range(2 if hybrid else 1):
            tnet.blob().grad = None
            tx.grad = None
            with autograd.record():
                tout = tnet(tx, [torch.from_numpy(s) for s in states]) \
                    if with_states else tnet(tx)
            ty, tst = tout if with_states else (tout, [])
            assert isinstance(tst, list) and len(tst) == len(jst)
            for a, b in zip(tst, jst):
                _close(a, b.asnumpy(), FWD_TOL, "state")
            _close(ty, jy.asnumpy(), FWD_TOL, "output")
            ty.backward(torch.from_numpy(ct))
            _close(tx.grad, jx.grad.asnumpy(), GRAD_TOL, "input gradient")
            _close(tnet.blob().grad, jnet.parameters.grad().asnumpy(),
                   GRAD_TOL, "blob gradient")


def test_begin_state_and_params_file(tmp_path):
    """begin_state gives zeros of state_info's shapes on the blob's
    device and dtype (h, c for LSTM; h otherwise); a ``.params`` file
    the JAX package wrote loads into the port's layer by name."""
    lstm = rnn.LSTM(H, num_layers=2, bidirectional=True, input_size=I,
                    device="cpu")
    st = lstm.begin_state(B)
    assert [tuple(s.shape) for s in st] == [(4, B, H)] * 2
    assert all(s.dtype == torch.float32 and not s.any() for s in st)
    assert [tuple(s.shape) for s in rnn.GRU(H, input_size=I,
                                            device="cpu").begin_state(2)] \
        == [(1, 2, H)]
    mx.random.seed(1)
    jnet = jrnn.LSTM(H, num_layers=2, input_size=I)
    jnet.initialize()
    f = str(tmp_path / "lstm.params")
    jnet.save_parameters(f)
    tnet = rnn.LSTM(H, num_layers=2, input_size=I, device="cpu")
    tnet.load_parameters(f)
    assert onp.array_equal(tnet.blob().detach().numpy(),
                           jnet.parameters.data().asnumpy())
    with pytest.raises(ValueError):
        rnn.LSTM(H, layout="NCT", input_size=I, device="cpu")
    with pytest.raises(MXNetError):
        rnn.LSTM(H, device="cpu")


CELL_CASES = [("RNNCell", dict(activation="relu")), ("LSTMCell", {}),
              ("GRUCell", {})]


@pytest.mark.parametrize("case", range(len(CELL_CASES)))
def test_cells_unroll_matches_jax(case):
    """RNNCell (relu), LSTMCell and GRUCell, weights carried by
    name (``i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``),
    unrolled over NTC inputs with ``valid_length``: outputs, last states
    and the gradients of the input and every weight."""
    name, kw = CELL_CASES[case]
    rs = onp.random.RandomState(case)
    mx.random.seed(case)
    jcell = getattr(jrnn, name)(H, input_size=I, **kw)
    jcell.initialize(mx.init.Uniform(0.4))
    jcell.hybridize()
    tcell = _carry(jcell, getattr(rnn, name)(H, input_size=I, device="cpu",
                                             **kw))
    x = _randn(rs, B, T, I)
    vl = onp.array([5, 2, 4], onp.float32)
    jx = NDArray(jnp.asarray(x))
    jx.attach_grad()
    with mx.autograd.record():
        jy, jst = jcell.unroll(T, jx, layout="NTC",
                               valid_length=NDArray(jnp.asarray(vl)))
    tx = torch.tensor(x, requires_grad=True)
    with autograd.record():
        ty, tst = tcell.unroll(T, tx, layout="NTC",
                               valid_length=torch.from_numpy(vl))
    _close(ty, jy.asnumpy(), FWD_TOL, "outputs")
    for a, b in zip(tst, jst):
        _close(a, b.asnumpy(), FWD_TOL, "states")
    ct = rs.randn(*ty.shape).astype(onp.float32)
    jy.backward(NDArray(jnp.asarray(ct)))
    ty.backward(torch.from_numpy(ct))
    _close(tx.grad, jx.grad.asnumpy(), GRAD_TOL, "input gradient")
    jp = jcell._collect_params_with_prefix()
    for n, p in tcell.named_parameters():
        _close(p.grad, jp[n].grad().asnumpy(), GRAD_TOL, n)


def test_stacked_and_bidirectional_cells_match_jax():
    """SequentialRNNCell of an LSTMCell, a DropoutCell (identity outside
    train mode) and a ResidualCell around a GRUCell, unrolled TNC
    without merging; and a BidirectionalCell of two LSTMCells with
    ``valid_length`` (each row's steps reversed within its length):
    outputs and states against the JAX cells, children named
    ``0``, ``1``, ... and ``l_cell``/``r_cell``."""
    rs = onp.random.RandomState(11)
    mx.random.seed(11)
    jseq = jrnn.SequentialRNNCell()
    jseq.add(jrnn.LSTMCell(H, input_size=I))
    jseq.add(jrnn.DropoutCell(0.5))
    jseq.add(jrnn.ResidualCell(jrnn.GRUCell(H, input_size=H)))
    jseq.initialize(mx.init.Uniform(0.4))
    tseq = rnn.SequentialRNNCell()
    tseq.add(rnn.LSTMCell(H, input_size=I, device="cpu"))
    tseq.add(rnn.DropoutCell(0.5))
    tseq.add(rnn.ResidualCell(rnn.GRUCell(H, input_size=H, device="cpu")))
    _carry(jseq, tseq)
    assert len(tseq) == 3 and len(tseq.state_info(B)) == 3
    x = _randn(rs, T, B, I)
    jouts, jst = jseq.unroll(T, NDArray(jnp.asarray(x)), layout="TNC",
                             merge_outputs=False)
    touts, tst = tseq.unroll(T, torch.from_numpy(x), layout="TNC",
                             merge_outputs=False)
    assert len(touts) == T
    for a, b in zip(touts + tst, jouts + jst):
        _close(a, b.asnumpy(), FWD_TOL, "stacked")
    jbi = jrnn.BidirectionalCell(jrnn.LSTMCell(H, input_size=I),
                                 jrnn.LSTMCell(H, input_size=I))
    jbi.initialize(mx.init.Uniform(0.4))
    tbi = _carry(jbi, rnn.BidirectionalCell(
        rnn.LSTMCell(H, input_size=I, device="cpu"),
        rnn.LSTMCell(H, input_size=I, device="cpu")))
    x = _randn(rs, B, T, I)
    vl = onp.array([3, 5, 1], onp.float32)
    jy, jst = jbi.unroll(T, NDArray(jnp.asarray(x)),
                         valid_length=NDArray(jnp.asarray(vl)))
    ty, tst = tbi.unroll(T, torch.from_numpy(x),
                         valid_length=torch.from_numpy(vl))
    assert ty.shape == (B, T, 2 * H)
    for a, b in zip([ty] + tst, [jy] + jst):
        _close(a, b.asnumpy(), FWD_TOL, "bidirectional")
    with pytest.raises(NotImplementedError):
        tbi(torch.from_numpy(x[:, 0]), tbi.begin_state(B))


def test_zoneout_cell():
    """ZoneoutCell: outside train mode the base cell itself; in train
    mode each output element is the new one or the previous step's
    (zeros at the first) and each state element the new or the old
    one, both kinds present at rate 0.5, drawn from the port's mask on
    the CPU (no launch)."""
    rs = onp.random.RandomState(4)
    base = rnn.LSTMCell(H, input_size=I, device="cpu")
    base.initialize()
    cell = rnn.ZoneoutCell(base, zoneout_outputs=0.5, zoneout_states=0.5)
    x = torch.from_numpy(_randn(rs, B, I))
    st = [torch.from_numpy(_randn(rs, B, H)) for _ in range(2)]
    want, want_st = base(x, st)
    got, got_st = cell(x, st)
    assert torch.equal(got, want) and all(
        torch.equal(a, b) for a, b in zip(got_st, want_st))
    mxr.seed(2, device="cpu")
    launches = dk.dropout_mask.launches
    cell = rnn.ZoneoutCell(base, zoneout_outputs=0.5, zoneout_states=0.5)
    with autograd.train_mode():
        out, new_st = cell(x, st)
        assert torch.all((out == want) | (out == 0))
        assert (out == 0).any() and (out == want).any()
        for s_new, s_old, s_base in zip(new_st, st, want_st):
            assert torch.all((s_new == s_old) | (s_new == s_base))
            assert (s_new == s_old).any() and (s_new == s_base).any()
        out2, _ = cell(x, new_st)
        base2, _ = base(x, new_st)
        assert torch.all((out2 == base2) | (out2 == out))
    assert dk.dropout_mask.launches == launches
    assert cell.begin_state(2)[0].shape == (2, H)
