"""Models of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/models/`): the serving slice's TransformerLM and
its generation (greedy and sampled decode, beam search, streaming
through the serving engine, scoring), the training slice's BERT, and
the encoder-decoder Transformer with its label-smoothed loss and
translation."""
from . import bert
from .bert import BERTForPretraining, BERTModel, bert_base, bert_large
from .generation import (lm_beam_search, lm_generate, lm_score, lm_stream,
                         nmt_translate)
from .transformer import (LabelSmoothedCELoss, Transformer, TransformerLM,
                          positional_encoding, transformer_base,
                          transformer_big)

__all__ = ["BERTForPretraining", "BERTModel", "LabelSmoothedCELoss",
           "Transformer", "TransformerLM", "bert", "bert_base", "bert_large",
           "lm_beam_search", "lm_generate", "lm_score", "lm_stream",
           "nmt_translate", "positional_encoding", "transformer_base",
           "transformer_big"]
