"""Models of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/models/`): the serving slice's TransformerLM and
its generation loop, and the training slice's BERT."""
from . import bert
from .bert import BERTForPretraining, BERTModel, bert_base, bert_large
from .generation import lm_generate, lm_score
from .transformer import TransformerLM, positional_encoding

__all__ = ["BERTForPretraining", "BERTModel", "TransformerLM", "bert",
           "bert_base", "bert_large", "lm_generate", "lm_score",
           "positional_encoding"]
