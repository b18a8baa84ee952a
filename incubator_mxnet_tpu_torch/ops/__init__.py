"""Kernels of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/ops/`): each module holds a hand-written CUDA
kernel and the plain PyTorch version it is held to.  Importing them
builds nothing; the CUDA sources are compiled on first use."""
from .dropout_kernel import (dropout_bwd, dropout_fwd, dropout_mask,
                             fused_dropout, fused_dropout_add)
from .flash_attention import (attention_bthd, attention_reference,
                              flash_attention, flash_attention_with_lse)
from .int8_conv import int8_conv, int8_dense, int8_quantize
from .paged_attention import (paged_attention, paged_attention_dense,
                              paged_attention_q8)
from .xent_kernel import (fused_smoothed_xent, fused_sparse_xent,
                          xent_backward, xent_forward)

__all__ = ["attention_bthd", "attention_reference", "dropout_bwd",
           "dropout_fwd", "dropout_mask",
           "flash_attention", "flash_attention_with_lse", "fused_dropout",
           "fused_dropout_add", "fused_smoothed_xent", "fused_sparse_xent",
           "int8_conv", "int8_dense", "int8_quantize",
           "paged_attention", "paged_attention_dense", "paged_attention_q8",
           "xent_backward", "xent_forward"]
