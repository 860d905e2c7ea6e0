"""Synthetic text corpora, written offline from a seed.

The port's own copy of ``vae_lagging_encoder_tpu/data/synthetic.py``
(numpy only; the same seeds give byte-identical files):

- ``generate_synthetic_corpus``: sentences from per-topic order-1 Markov
  chains over a small vocabulary, the corpus of the toy 1-D-latent
  posterior-mean-space experiment (``cli/toy.py``); the reference fetches
  a pre-generated ``datasets/synthetic_data``, which is not available
  offline;
- ``generate_flagship_corpus``: a Yahoo-shaped corpus (~20k vocabulary,
  ~100-token sentences from topic-conditioned hidden-Markov state chains
  with Zipf emissions);
- ``ensure_synthetic_dataset`` / ``ensure_flagship_dataset``: write the
  ``<label>\t<sentence>`` split files where a config expects them, unless
  all three exist; refuse to complete a partial set.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def generate_synthetic_corpus(
    num_sentences: int = 16000,
    vocab_size: int = 200,
    min_len: int = 5,
    max_len: int = 30,
    num_topics: int = 2,
    seed: int = 783435,
) -> Tuple[List[List[str]], List[int]]:
    """Sample sentences from per-topic Markov chains over a shared vocab."""
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(vocab_size)]
    # Per-topic sparse-ish transition matrices with distinct stationary mass.
    trans = []
    for _ in range(num_topics):
        logits = rng.gumbel(size=(vocab_size, vocab_size)) * 2.0
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        trans.append(probs)
    start = rng.dirichlet(np.ones(vocab_size) * 0.3, size=num_topics)

    sentences, topics = [], []
    for _ in range(num_sentences):
        t = int(rng.randint(num_topics))
        length = int(rng.randint(min_len, max_len + 1))
        w = int(rng.choice(vocab_size, p=start[t]))
        sent = [w]
        for _ in range(length - 1):
            w = int(rng.choice(vocab_size, p=trans[t][w]))
            sent.append(w)
        sentences.append([words[i] for i in sent])
        topics.append(t)
    return sentences, topics


def generate_flagship_corpus(
    num_sentences: int = 20000,
    vocab_size: int = 19996,
    num_states: int = 24,
    num_topics: int = 8,
    mean_len: float = 100.0,
    std_len: float = 28.0,
    seed: int = 783435,
) -> Tuple[List[List[str]], List[int]]:
    """Yahoo-scale structured corpus: topic-conditioned hidden-Markov state
    chains with per-state zipf emissions over a ~20k vocab, ~100-token
    sentences: an offline stand-in for the real Yahoo/Yelp corpora,
    structured enough that the aggressive encoder has sentence-level signal
    to capture (an i.i.d.-token corpus makes it chase noise). The emission
    stage is vectorized (one searchsorted over a shared zipf CDF per state,
    through per-state vocab permutations); the state chains are a cheap
    per-token Python loop (~8 s at default scale).
    """
    rng = np.random.RandomState(seed)
    trans_cum = []
    for _ in range(num_topics):
        logits = (rng.gumbel(size=(num_states, num_states)) * 1.5
                  + np.eye(num_states) * 2.0)
        p = np.exp(logits - logits.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        trans_cum.append(np.cumsum(p, axis=1))
    perms = [rng.permutation(vocab_size) for _ in range(num_states)]
    w = 1.0 / np.arange(1, vocab_size + 1) ** 1.05
    emit_cum = np.cumsum(w / w.sum())

    lens = np.clip(rng.normal(mean_len, std_len, num_sentences),
                   max(8, mean_len - 2.7 * std_len),
                   mean_len + 2.9 * std_len).astype(int)
    topics = rng.randint(num_topics, size=num_sentences)
    all_states = np.empty(int(lens.sum()), np.int32)
    pos = 0
    for k in range(num_sentences):
        cum = trans_cum[topics[k]]
        u = rng.rand(lens[k])
        s = rng.randint(num_states)
        for i in range(int(lens[k])):
            all_states[pos + i] = s
            # min() guards the ~1e-15 chance of u landing above the CDF's
            # float tail (cum[-1] can be slightly below 1.0)
            s = min(int(np.searchsorted(cum[s], u[i])), num_states - 1)
        pos += int(lens[k])
    tok_ids = np.empty_like(all_states)
    ue = rng.rand(len(all_states))
    for s in range(num_states):
        m = all_states == s
        idx = np.minimum(np.searchsorted(emit_cum, ue[m]), vocab_size - 1)
        tok_ids[m] = perms[s][idx]

    sentences, pos = [], 0
    for L in lens:
        sentences.append([f"w{i}" for i in tok_ids[pos:pos + L]])
        pos += int(L)
    return sentences, [int(t) for t in topics]


def _ensure_splits(root: str, name: str, splits: dict,
                   generate) -> dict:
    """Shared existence check + '<label>\\t<sentence>' split writer.

    All three split files present → return them untouched (idempotent).
    SOME present → refuse: the partial files may be a real corpus (e.g. an
    interrupted tarball extraction) that must not be silently overwritten
    with synthetic text. None present → generate and write all three.
    """
    paths = {split: os.path.join(root, f"{name}.{split}.txt")
             for split in splits}
    present = [p for p in paths.values() if os.path.isfile(p)]
    if len(present) == len(paths):
        return paths
    if present:
        raise FileExistsError(
            f"{root} holds some but not all of {sorted(paths.values())} "
            f"(found {present}); refusing to overwrite possibly-real data "
            "with a synthetic substitute — remove the directory or complete "
            "the real corpus")
    os.makedirs(root, exist_ok=True)
    sents, topics = generate()
    # write to temp names, then rename all three at the end: a crash
    # mid-generation must not leave a partial set that the refusal branch
    # above would mistake for possibly-real data
    for split, sl in splits.items():
        with open(paths[split] + ".tmp", "w") as fh:
            for topic, sent in zip(topics[sl], sents[sl]):
                fh.write(f"{topic}\t" + " ".join(sent) + "\n")
    for p in paths.values():
        os.replace(p + ".tmp", p)
    return paths


def ensure_flagship_dataset(name: str = "yahoo",
                            root: str | None = None,
                            seed: int = 783435,
                            num_sentences: int = 22000) -> dict:
    """Write a Yahoo/Yelp-shaped offline substitute corpus under
    ``datasets/<name>_data/`` (the paths the yahoo/yelp configs expect),
    split 20k/1k/1k. Returns the split→path dict. Idempotent on a complete
    existing corpus; refuses to overwrite a partial one (see
    ``_ensure_splits`` — regenerating with a different seed/size requires
    removing the directory first)."""
    root = root or f"datasets/{name}_data"
    n_eval = max(1, num_sentences // 22)
    splits = {"train": slice(0, num_sentences - 2 * n_eval),
              "valid": slice(num_sentences - 2 * n_eval,
                             num_sentences - n_eval),
              "test": slice(num_sentences - n_eval, num_sentences)}
    return _ensure_splits(
        root, name, splits,
        lambda: generate_flagship_corpus(num_sentences=num_sentences,
                                         seed=seed))


def ensure_synthetic_dataset(root: str = "datasets/synthetic_data",
                             seed: int = 783435) -> dict:
    """Write {train,valid,test}.txt under ``root`` if absent; return paths."""
    splits = {"train": slice(0, 14000), "valid": slice(14000, 15000),
              "test": slice(15000, 16000)}
    return _ensure_splits(root, "synthetic", splits,
                          lambda: generate_synthetic_corpus(seed=seed))
