"""NLP — the port's part of `deeplearning4j_tpu/nlp`: the WordPiece
pipeline of BASELINE config 4.  Word2Vec, GloVe, ParagraphVectors, the
other tokenizers, the vocab cache and the word-vector serializer wait
(ROADMAP A13)."""

from deeplearning4j_tpu_torch.nlp.wordpiece import (
    BasicTokenizer,
    BertIterator,
    BertWordPieceTokenizer,
)

__all__ = ["BasicTokenizer", "BertIterator", "BertWordPieceTokenizer"]
