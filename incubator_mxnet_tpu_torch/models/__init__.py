"""Models of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/models/`): the serving slice's TransformerLM and
its generation (greedy and sampled decode, beam search, streaming
through the serving engine, scoring), and the training slice's
BERT."""
from . import bert
from .bert import BERTForPretraining, BERTModel, bert_base, bert_large
from .generation import lm_beam_search, lm_generate, lm_score, lm_stream
from .transformer import TransformerLM, positional_encoding

__all__ = ["BERTForPretraining", "BERTModel", "TransformerLM", "bert",
           "bert_base", "bert_large", "lm_beam_search", "lm_generate",
           "lm_score", "lm_stream", "positional_encoding"]
