"""Vocabulary with the reference's special tokens.

The port's own copy of ``vae_lagging_encoder_tpu/data/vocab.py``: word ids
are built from the train file only and reused for val/test; specials
``<pad> <unk> <s> </s>`` take ids 0..3; unknown words map to ``<unk>``;
``decode`` maps ids back to words, dropping the specials. ``from_file``
counts a corpus file with the native reader (data/native.py).
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List

PAD, UNK, BOS, EOS = "<pad>", "<unk>", "<s>", "</s>"
PAD_ID, UNK_ID, BOS_ID, EOS_ID = 0, 1, 2, 3
_SPECIALS = (PAD, UNK, BOS, EOS)

_ASCII_WS = re.compile(r"[^ \t\r\n\v\f]+")
_LEADING_INT = re.compile(r"^\s*[+-]?\d+")


def _ws_split(s: str) -> List[str]:
    """ASCII-whitespace tokenization (``str.split()`` would also split
    Unicode whitespace such as U+00A0, which the JAX package's readers keep
    inside a word)."""
    return _ASCII_WS.findall(s)


def _strtol(s: str) -> int:
    """C ``strtol`` semantics for label fields: leading integer, else 0."""
    m = _LEADING_INT.match(s)
    return int(m.group(0)) if m else 0


class Vocab:
    def __init__(self, word2id: Dict[str, int]):
        for i, sp in enumerate(_SPECIALS):
            if word2id.get(sp) != i:
                raise ValueError(f"special {sp!r} must have id {i}")
        self.word2id = word2id
        self.id2word_ = [None] * len(word2id)
        for w, i in word2id.items():
            self.id2word_[i] = w

    @classmethod
    def from_corpus(cls, sentences: Iterable[List[str]]) -> "Vocab":
        counts: Dict[str, int] = {}
        for sent in sentences:
            for w in sent:
                counts[w] = counts.get(w, 0) + 1
        word2id = {sp: i for i, sp in enumerate(_SPECIALS)}
        # deterministic order: frequency desc, then lexicographic
        for w, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
            if w not in word2id:
                word2id[w] = len(word2id)
        return cls(word2id)

    @classmethod
    def from_counts(cls, ordered_words: Iterable[str], counts: Iterable[int]) -> "Vocab":
        """From words already ordered by count descending, then lexicographically."""
        word2id = {sp: i for i, sp in enumerate(_SPECIALS)}
        for w in ordered_words:
            if w not in word2id:
                word2id[w] = len(word2id)
        return cls(word2id)

    @classmethod
    def from_file(cls, path: str, label: bool = False, native: bool = True) -> "Vocab":
        """The vocabulary of a corpus file, counted by the native reader
        (data/native.py) or, with ``native=False``, in Python."""
        if native:
            from . import native as nat

            return cls.from_counts(*nat.count_vocab(path, label))
        with open(path) as fh:
            if label:
                return cls.from_corpus(_ws_split(line.split("\t", 1)[-1]) for line in fh)
            return cls.from_corpus(_ws_split(line) for line in fh)

    def __len__(self) -> int:
        return len(self.word2id)

    def __getitem__(self, word: str) -> int:
        return self.word2id.get(word, UNK_ID)

    def encode(self, words: List[str]) -> List[int]:
        """<s> w1 ... wn </s> as ids (the reference wraps every sentence)."""
        return [BOS_ID] + [self[w] for w in words] + [EOS_ID]

    def decode(self, ids: Iterable[int], strip_specials: bool = True) -> List[str]:
        """Words of ``ids``; the specials are dropped unless ``strip_specials`` is False."""
        return [self.id2word_[i] for i in ids
                if not (strip_specials and self.id2word_[i] in _SPECIALS)]
