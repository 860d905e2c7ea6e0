"""Monolingual text corpus -> padded, bucketed batches.

The port's own copy of ``vae_lagging_encoder_tpu/data/text.py``. A corpus
file is read by the native reader (data/native.py, ``csrc/textproc.cpp``)
unless ``native=False`` selects the pure-Python reader, its plain version,
which gives the same vocabulary, ids and labels. Sentences are wrapped in
``<s> ... </s>``, grouped into a few fixed bucket lengths and padded; masks
make the padding invisible:

- ``mask[b, t] = 1`` for real tokens (including <s> and </s>), else 0;
- partial batches are padded up to ``batch_size`` with all-pad rows whose
  ``row_weight`` is 0, so sums and means over a batch are exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .vocab import _SPECIALS, BOS_ID, EOS_ID, PAD_ID, UNK_ID, Vocab, _strtol, _ws_split


@dataclass(frozen=True)
class TextBatch:
    """One batch of sentences.

    tokens:     int32  [B, L]   — <s> w1..wn </s> <pad>...
    mask:       float32[B, L]   — 1.0 on real tokens, 0.0 on padding
    row_weight: float32[B]      — 1.0 for real sentences, 0.0 for pad rows
    """

    tokens: np.ndarray
    mask: np.ndarray
    row_weight: np.ndarray

    @property
    def seq_len(self) -> int:
        return int(self.tokens.shape[1])


DEFAULT_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def _bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    # overflow bucket: round up to a multiple of 16
    return ((length + 15) // 16) * 16


class MonoTextData:
    """Corpus container: ``data`` holds each sentence's ids incl. <s>/</s>."""

    def __init__(self, fname: str, vocab: Optional[Vocab] = None, label: bool = False,
                 native: bool = True):
        if native:
            from . import native as nat

            self.vocab = vocab if vocab is not None else Vocab.from_file(fname, label)
            words = self.vocab.id2word_[len(_SPECIALS):]
            ids, offs, labels = nat.encode_corpus(fname, label, words, unk_id=UNK_ID,
                                                  first_id=len(_SPECIALS))
            self.labels = [int(x) for x in labels] if label else None
            self.data: List[List[int]] = [[BOS_ID] + ids[offs[i]:offs[i + 1]].tolist() + [EOS_ID]
                                          for i in range(len(offs) - 1)]
            return
        sentences, self.labels = self._read(fname, label)
        self.vocab = vocab if vocab is not None else Vocab.from_corpus(sentences)
        self.data = [self.vocab.encode(s) for s in sentences]

    @staticmethod
    def _read(fname: str, label: bool) -> Tuple[List[List[str]], Optional[List[int]]]:
        """ASCII-whitespace tokenization; labeled lines with an empty body
        are skipped; labels parse strtol-style (leading integer, else 0;
        -1 where a line has no tab)."""
        sentences, labels = [], [] if label else None
        with open(fname) as fh:
            for line in fh:
                if label:
                    split = line.split("\t", 1)
                    toks = _ws_split(split[-1])
                    if not toks:
                        continue
                    labels.append(_strtol(split[0]) if len(split) == 2 else -1)
                else:
                    toks = _ws_split(line)
                    if not toks:
                        continue
                sentences.append(toks)
        return sentences, labels

    def __len__(self) -> int:
        return len(self.data)

    def create_data_batch(self, batch_size: int,
                          buckets: Sequence[int] = DEFAULT_BUCKETS) -> List[TextBatch]:
        """All batches, bucket by bucket (ascending length), in corpus order
        inside a bucket; the batch dim is always ``batch_size``."""
        by_bucket: Dict[int, List[List[int]]] = {}
        for sent in self.data:
            by_bucket.setdefault(_bucket_for(len(sent), buckets), []).append(sent)
        batches: List[TextBatch] = []
        for blen in sorted(by_bucket):
            group = by_bucket[blen]
            for i in range(0, len(group), batch_size):
                batches.append(self._pad_batch(group[i:i + batch_size], blen,
                                               batch_size))
        return batches

    @staticmethod
    def _pad_batch(sents: List[List[int]], seq_len: int, batch_size: int) -> TextBatch:
        tokens = np.full((batch_size, seq_len), PAD_ID, dtype=np.int32)
        mask = np.zeros((batch_size, seq_len), dtype=np.float32)
        row_weight = np.zeros((batch_size,), dtype=np.float32)
        for r, s in enumerate(sents):
            tokens[r, : len(s)] = s
            mask[r, : len(s)] = 1.0
            row_weight[r] = 1.0
        return TextBatch(tokens=tokens, mask=mask, row_weight=row_weight)
