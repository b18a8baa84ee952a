"""Kernels of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/ops/`): each module holds a hand-written CUDA
kernel and the plain PyTorch version it is held to.  Importing them
builds nothing; the CUDA sources are compiled on first use."""
from .flash_attention import (attention_reference, flash_attention,
                              flash_attention_with_lse)
from .paged_attention import paged_attention, paged_attention_dense

__all__ = ["flash_attention", "flash_attention_with_lse",
           "attention_reference", "paged_attention",
           "paged_attention_dense"]
