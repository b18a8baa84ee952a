"""Models of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/models/`): the serving slice's TransformerLM and
its generation loop."""
from .generation import lm_generate
from .transformer import TransformerLM, positional_encoding

__all__ = ["TransformerLM", "lm_generate", "positional_encoding"]
