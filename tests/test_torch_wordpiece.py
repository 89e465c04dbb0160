"""The port's WordPiece pipeline (`deeplearning4j_tpu_torch/nlp/
wordpiece.py`) against the JAX package's: the same text gives the same
tokens, ids, masks and segments, and `BertIterator` the same batches
(padded, bucketed, paired)."""

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import BertIterator as JaxBertIterator
from deeplearning4j_tpu.nlp import BertWordPieceTokenizer as JaxTokenizer
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nlp import (
    BasicTokenizer,
    BertIterator,
    BertWordPieceTokenizer,
)

VOCAB = {t: i for i, t in enumerate([
    "[PAD]", "[UNK]", "[CLS]", "[SEP]",
    "the", "quick", "brown", "fox", "jump", "##ed", "##s", "over", "dog",
    "un", "##believ", "##able", ",", ".", "café", "cafe",
])}
TEXTS = ["The quick, brown FOX.", "unbelievable", "jumped over the dog", "zebra jumps",
         "Café  au\tlait!", "", "the " * 40, "fox" * 200, "un-believ-able?"]


@pytest.fixture(params=[True, False], ids=["lower", "cased"])
def pair(request):
    return (BertWordPieceTokenizer(VOCAB, lower_case=request.param),
            JaxTokenizer(VOCAB, lower_case=request.param))


@pytest.mark.parametrize("text", TEXTS)
def test_tokens_match(pair, text):
    port, jax = pair
    assert port.tokenize(text) == jax.tokenize(text)
    assert BasicTokenizer(port._basic.lower_case).tokenize(text) == \
        jax._basic.tokenize(text)


@pytest.mark.parametrize("text,other,max_len", [
    ("the fox", None, 8), ("the quick brown fox", "the dog", 10),
    ("the quick brown fox jumped over the dog " * 3, "the dog", 12),
    ("unbelievable", None, 4)])
def test_encode_matches(pair, text, other, max_len):
    port, jax = pair
    for got, want in zip(port.encode(text, other, max_len=max_len),
                         jax.encode(text, other, max_len=max_len)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_encode_refusals_match(pair):
    port, _ = pair
    with pytest.raises(ValueError, match="no room"):
        port.encode("the fox", "the dog", max_len=4)
    with pytest.raises(ValueError, match="special tokens"):
        BertWordPieceTokenizer({"the": 0}).encode("the", max_len=4)


def test_vocab_txt(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(sorted(VOCAB, key=VOCAB.get)) + "\n")
    assert BertWordPieceTokenizer(str(path)).vocab == JaxTokenizer(str(path)).vocab == VOCAB


@pytest.mark.parametrize("dynamic", [False, True])
def test_bert_iterator_batches_match(dynamic):
    rng = np.random.default_rng(5)
    words = [w for w in VOCAB if not w.startswith(("[", "##"))]
    sents = [" ".join(rng.choice(words, rng.integers(1, 20))) for _ in range(23)]
    pairs = [" ".join(rng.choice(words, 3)) for _ in range(23)]
    labels = rng.integers(0, 3, 23)
    kw = dict(num_classes=3, batch_size=4, max_len=32, pairs=pairs,
              dynamic_seq_len=dynamic, bucket_size=8)
    port = BertIterator(BertWordPieceTokenizer(VOCAB), sents, labels, **kw)
    jax = JaxBertIterator(JaxTokenizer(VOCAB), sents, labels, **kw)
    got, want = list(port), list(jax)
    assert len(got) == len(want) and all(isinstance(b, DataSet) for b in got)
    for g, w in zip(got, want):
        for field in ("features", "labels", "features_mask", "labels_mask"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.segment_ids(), jax.segment_ids())
    port.reset()
    assert len(list(port)) == len(got)
