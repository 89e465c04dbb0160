"""BERT WordPiece tokenization and the BertIterator batch producer — the
port's counterpart of `deeplearning4j_tpu/nlp/wordpiece.py`.

`BasicTokenizer` (clean, lowercase, strip accents, split on whitespace
and punctuation), `BertWordPieceTokenizer` (greedy longest-match-first
WordPiece against a BERT vocab) and `BertIterator`, which turns
sentences into fixed-shape (token ids, attention mask) `DataSet`
batches: BASELINE config 4's input pipeline.  Tokenization is host-side
Python; the batches are numpy arrays with the JAX package's dtypes and
values, so the same sentences give the same batches in both packages.
"""

from __future__ import annotations

import unicodedata
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BasicTokenizer:
    """BERT's pre-tokenizer: clean, lowercase (optional), strip accents,
    split on whitespace and punctuation."""

    def __init__(self, lower_case: bool = True):
        self.lower_case = lower_case

    def tokenize(self, text: str) -> List[str]:
        if self.lower_case:
            text = text.lower()
            text = unicodedata.normalize("NFD", text)
            text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out: List[str] = []
        word = []
        for ch in text:
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif _is_punct(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out


class BertWordPieceTokenizer:
    """Greedy longest-match-first WordPiece (BertWordPieceTokenizerFactory
    role).  vocab: token -> id mapping, or a vocab.txt path (one token per
    line, id = line number — the format BERT checkpoints ship)."""

    def __init__(self, vocab, *, lower_case: bool = True,
                 unk_token: str = "[UNK]", max_word_chars: int = 100):
        if isinstance(vocab, (str,)) or hasattr(vocab, "read"):
            vocab = self.load_vocab(vocab)
        self.vocab: dict = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.unk_token = unk_token
        self.max_word_chars = max_word_chars
        self._basic = BasicTokenizer(lower_case)

    @staticmethod
    def load_vocab(path_or_file) -> dict:
        close = False
        f = path_or_file
        if isinstance(path_or_file, str):
            f = open(path_or_file, encoding="utf-8")
            close = True
        try:
            return {line.rstrip("\r\n"): i for i, line in enumerate(f)}
        finally:
            if close:
                f.close()

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_word_chars:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._basic.tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, pair: Optional[str] = None,
               *, max_len: int, add_special: bool = True):
        """(ids, mask, segment_ids) padded/truncated to max_len —
        [CLS] a... [SEP] b... [SEP] layout when add_special."""
        cls_id = self.vocab.get("[CLS]")
        sep_id = self.vocab.get("[SEP]")
        pad_id = self.vocab.get("[PAD]", 0)
        a = [self.vocab.get(t, self.vocab.get(self.unk_token, 0))
             for t in self.tokenize(text)]
        b = ([self.vocab.get(t, self.vocab.get(self.unk_token, 0))
              for t in self.tokenize(pair)] if pair else [])
        if add_special:
            if cls_id is None or sep_id is None:
                raise ValueError("vocab lacks [CLS]/[SEP] special tokens")
            budget = max_len - 2 - (1 if b else 0)
            if budget < (2 if b else 1):
                raise ValueError(
                    f"max_len={max_len} leaves no room for content after "
                    "the [CLS]/[SEP] special tokens"
                )
            # longest-first truncation (the BERT pair recipe)
            while len(a) + len(b) > budget:
                (a if len(a) >= len(b) else b).pop()
            ids = [cls_id] + a + [sep_id] + (b + [sep_id] if b else [])
            seg = [0] * (2 + len(a)) + [1] * (len(b) + 1 if b else 0)
        else:
            ids = (a + b)[:max_len]
            seg = [0] * len(ids)
        mask = [1] * len(ids)
        pad = max_len - len(ids)
        return (
            np.asarray(ids + [pad_id] * pad, np.int32),
            np.asarray(mask + [0] * pad, np.float32),
            np.asarray(seg + [0] * pad, np.int32),
        )


class BertIterator(DataSetIterator):
    """Fixed-shape BERT fine-tune batches (BertIterator role): sentences
    (+ optional pairs) with integer labels -> DataSet batches whose
    features are token ids, features_mask is the attention mask, labels
    one-hot.  Static shapes: every batch pads to (batch_size, max_len).

    dynamic_seq_len=True enables SEQUENCE BUCKETING: examples are grouped
    by tokenized length and each batch's time axis is the group's length
    rounded UP to the bucket quantum (`bucket_size`, default
    `runtime/flags.py` `sequence_bucket_size`), capped at max_len.  A
    mixed-length corpus then compiles at most ceil(max_len / quantum)
    distinct step programs instead of one per distinct length, and short
    batches stop paying max_len's worth of attention FLOPs.  The
    attention mask still carries per-token validity, so the loss/metrics
    are identical to the padded-to-max_len layout."""

    def __init__(self, tokenizer: BertWordPieceTokenizer,
                 sentences: Sequence, labels: Sequence[int], *,
                 num_classes: int, batch_size: int = 32, max_len: int = 128,
                 pairs: Optional[Sequence] = None,
                 dynamic_seq_len: bool = False,
                 bucket_size: Optional[int] = None):
        if len(sentences) != len(labels):
            raise ValueError("sentences and labels must align")
        if pairs is not None and len(pairs) != len(sentences):
            raise ValueError("pairs must align with sentences")
        self.tokenizer = tokenizer
        self.sentences = list(sentences)
        self.labels = list(labels)
        self.pairs = list(pairs) if pairs is not None else None
        self.num_classes = num_classes
        self._batch_size = batch_size
        self.max_len = max_len
        self.dynamic_seq_len = dynamic_seq_len
        self.bucket_size = bucket_size
        self._encoded = None         # (ids, mask, segments) cached across epochs
        self._lengths = None         # per-example real token counts

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def _encode_all(self):
        """Tokenize ONCE: sentences/tokenizer/max_len are fixed at
        construction, so later epochs slice cached arrays instead of
        re-running host-side WordPiece."""
        if self._encoded is None:
            n = len(self.sentences)
            ids = np.zeros((n, self.max_len), np.float32)
            mask = np.zeros((n, self.max_len), np.float32)
            segs = np.zeros((n, self.max_len), np.int32)
            for j in range(n):
                pair = self.pairs[j] if self.pairs else None
                i, m, sg = self.tokenizer.encode(
                    self.sentences[j], pair, max_len=self.max_len
                )
                ids[j], mask[j], segs[j] = i, m, sg
            self._encoded = (ids, mask, segs)
            self._lengths = mask.sum(axis=1).astype(np.int64)
        return self._encoded

    def segment_ids(self):
        """(N, max_len) int32 token-type ids aligned with iteration order.
        NOTE: the DSL's Embedding layer has no token-type channel yet, so
        pair inputs train on the [SEP]-delimited sequence alone; consume
        these ids from a custom layer/graph input if segments matter."""
        return self._encode_all()[2]

    def _bucket_plan(self) -> list[tuple[int, list[int]]]:
        """(bucket_len, example indices) groups, shortest bucket first.
        Bucket lengths are multiples of the quantum capped at max_len, so
        distinct feature shapes number at most ceil(max_len/quantum)."""
        from deeplearning4j_tpu_torch.runtime.flags import bucket_length

        self._encode_all()
        q = self.bucket_size
        buckets: dict[int, list[int]] = {}
        for j, ln in enumerate(self._lengths):
            L = min(self.max_len, bucket_length(int(ln), q))
            buckets.setdefault(L, []).append(j)
        return sorted(buckets.items())

    def _emit(self, idx: list[int], seq_len: int):
        all_ids, all_mask, _ = self._encoded
        bs = self._batch_size
        count = len(idx)
        ids = np.zeros((bs, seq_len), np.float32)
        mask = np.zeros((bs, seq_len), np.float32)
        y = np.zeros((bs, self.num_classes), np.float32)
        lmask = np.zeros((bs,), np.float32)
        ids[:count] = all_ids[idx, :seq_len]
        mask[:count] = all_mask[idx, :seq_len]
        for j, src in enumerate(idx):
            y[j, self.labels[src]] = 1.0
            lmask[j] = 1.0
        # static batch shape: the tail batch pads EXAMPLES too and
        # masks them out of the loss via labels_mask
        return DataSet(ids, y, features_mask=mask, labels_mask=lmask)

    def __iter__(self):
        self._encode_all()
        n = len(self.sentences)
        bs = self._batch_size
        if not self.dynamic_seq_len:
            for lo in range(0, n, bs):
                yield self._emit(list(range(lo, min(lo + bs, n))), self.max_len)
            return
        for seq_len, idx in self._bucket_plan():
            for lo in range(0, len(idx), bs):
                yield self._emit(idx[lo : lo + bs], seq_len)

    def reset(self) -> None:
        pass
