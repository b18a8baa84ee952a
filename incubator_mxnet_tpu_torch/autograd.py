"""``mx.autograd`` of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/autograd.py`).

The JAX package tapes operations itself (`_tape.py`); the port lets
`torch.autograd` tape them.  Two thread-local flags keep the
reference's semantics:

* recording — ``record()`` turns it on together with
  `torch.enable_grad`, ``pause()`` turns it off together with
  `torch.no_grad`.  Outside any ``record()`` a Gluon block builds no
  graph (`gluon.block.Block.__call__` runs under `torch.no_grad`), as a
  reference forward outside ``record()`` is not taped.  How a backward
  stores a parameter's gradient (``grad_req``) is the parameter's own
  affair (`gluon.parameter.Parameter`).
* train mode — ``record()`` turns it on unless told otherwise,
  ``pause()`` and ``predict_mode()`` turn it off.  Dropout reads this
  flag (`ndarray.nn_ops.Dropout`), not `torch.nn.Module.training`.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    """Set the recording flag; returns the previous value."""
    prev, _STATE.recording = _STATE.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    """Set the train-mode flag; returns the previous value."""
    prev, _STATE.training = _STATE.training, bool(flag)
    return prev


class _Scope:
    """Sets the flags (and torch's grad mode with the recording flag)
    on entry and restores all of them on exit."""

    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._recording = recording
        self._training = training
        self._saved = None

    def __enter__(self):
        self._saved = (_STATE.recording, _STATE.training,
                       torch.is_grad_enabled())
        if self._recording is not None:
            _STATE.recording = self._recording
            torch.set_grad_enabled(self._recording)
        if self._training is not None:
            _STATE.training = self._training
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training, grad = self._saved
        torch.set_grad_enabled(grad)


def record(train_mode: bool = True) -> _Scope:
    """Record operations for ``backward`` (train mode on by default)."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    """Stop recording inside a ``record()`` scope."""
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


def backward(heads, head_grads: Optional[Sequence] = None,
             retain_graph: bool = False) -> None:
    """Gradients of ``heads`` into the ``.grad`` of every parameter the
    recorded graph reaches (``torch.autograd.backward``).  Without
    ``head_grads`` each head's gradient is ones of its shape, as in the
    JAX package, so a per-sample loss needs no reduction first."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
        if head_grads is not None and isinstance(head_grads, torch.Tensor):
            head_grads = [head_grads]
    if head_grads is None:
        head_grads = [torch.ones_like(h) for h in heads]
    torch.autograd.backward(list(heads), grad_tensors=head_grads,
                            retain_graph=retain_graph)
