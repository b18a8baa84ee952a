"""Model zoo (counterpart of `incubator_mxnet_tpu/gluon/model_zoo/`):
the vision models ported so far."""
from . import vision

__all__ = ["vision"]
