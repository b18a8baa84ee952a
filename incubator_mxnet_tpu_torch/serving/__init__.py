"""Continuous-batching serving over a paged KV cache (counterpart of
`incubator_mxnet_tpu/serving/`): `BlockPool` (host-side block
accounting + prefix cache), `PagedPrograms` (the device pools and the
step / prefill-chunk programs) and `ServingEngine` (the scheduler)."""
from .engine import (Request, RequestCancelled, RequestFailed, RequestShed,
                     RequestTimedOut, ServingEngine, ServingError,
                     default_engine)
from .kv_pool import SCRATCH_BLOCK, BlockPool
from .programs import PagedPrograms

__all__ = ["BlockPool", "SCRATCH_BLOCK", "PagedPrograms", "ServingEngine",
           "Request", "ServingError", "RequestShed", "RequestTimedOut",
           "RequestCancelled", "RequestFailed", "default_engine"]
