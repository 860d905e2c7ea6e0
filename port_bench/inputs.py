"""Inputs made from ``--seed``: the corpora, the orders the steps take
batches in, the weights and the noise the port draws.

Every seed gets the same set of shapes in the same order; the seed
changes only what they hold. Text: the sentence lengths are the
quantiles of the configuration's length distribution (N(mean, std)
clipped, as ``chip_smoke.py::lengths_like_yahoo`` and
``bench.py::build_bench_corpus`` draw them), so every seed has the same
lengths; the seed shuffles them and draws the word ids (Zipf over the
vocabulary, ``zipf(a) % words``, after the four specials). Orders visit the buckets in a fixed
interleave (each bucket's j-th visit at the quantile (j + 1/2) / count of
a cycle), one cycle being every batch once; which batch of the bucket a
visit takes is the seed's, but for the bucket's padded last batch, whose
visit is fixed. So a window of any length takes the same shapes and the
same number of real rows on every seed.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

PAD, BOS, EOS, SPECIALS = 0, 2, 3, 4


def seed_state(seed: int, *stream) -> int:
    """A 63-bit seed for the stream ``stream`` (ints) of ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, *[int(s) for s in stream]])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *stream) -> np.random.Generator:
    return np.random.default_rng(seed_state(seed, *stream))


def quantile_lengths(n: int, mean: float, std: float, lo: int, hi: int) -> np.ndarray:
    """The n quantiles of N(mean, std), clipped to [lo, hi], truncated."""
    nd = NormalDist(mean, std)
    return np.array([int(min(max(nd.inv_cdf((i + 0.5) / n), lo), hi)) for i in range(n)])


def bucket_of(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return (length + 15) // 16 * 16


def text_batches(data: dict, n_sents: int, batch: int, seed: int, stream: int):
    """Batches ``(tokens [B, L] int64, mask [B, L] f32, row_weight [B] f32)``
    of ``n_sents`` sentences ``<s> w.. </s>``, grouped by bucket in
    ascending length, a bucket's last batch padded with empty rows (the
    port's ``MonoTextData.create_data_batch`` layout). Returns the list of
    ``(bucket_length, [batches])``."""
    r = rng(seed, stream)
    lens = quantile_lengths(n_sents, data["length_mean"], data["length_std"],
                            data["length_min"], data["length_max"])
    r.shuffle(lens)
    words = data["vocab_size"] - SPECIALS
    ids = r.zipf(data["zipf_a"], size=int(lens.sum())) % words + SPECIALS
    groups: Dict[int, List[np.ndarray]] = {}
    pos = 0
    for ln in lens:
        sent = np.concatenate([[BOS], ids[pos:pos + ln], [EOS]])
        pos += int(ln)
        groups.setdefault(bucket_of(len(sent), data["length_buckets"]), []).append(sent)
    out = []
    for L in sorted(groups):
        sents, bs = groups[L], []
        for s in range(0, len(sents), batch):
            tok = np.full((batch, L), PAD, np.int64)
            mask = np.zeros((batch, L), np.float32)
            w = np.zeros((batch,), np.float32)
            for k, sent in enumerate(sents[s:s + batch]):
                tok[k, :len(sent)] = sent
                mask[k, :len(sent)] = 1.0
                w[k] = 1.0
            bs.append((tok, mask, w))
        out.append((L, bs))
    return out


def interleave(counts: Sequence[int]) -> List[int]:
    """One cycle of bucket indices: bucket b's j-th visit at (j + 1/2) / count_b."""
    keys = [((j + 0.5) / c, b) for b, c in enumerate(counts) for j in range(c)]
    return [b for _, b in sorted(keys)]


def schedule(counts: Sequence[int], seed: int, stream: int) -> Iterator[int]:
    """Flat batch indices, cycle after cycle: the fixed interleave of the
    buckets (``counts`` batches each, flat order bucket by bucket), each
    cycle a fresh seeded permutation inside every bucket, but for its last
    batch (the one a bucket's remainder pads), which takes the bucket's last
    visit of every cycle, so that a window of any length holds the same
    padded rows on every seed."""
    r = rng(seed, stream)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pattern = interleave(counts)
    while True:
        visits = [[c - 1] + list(r.permutation(c - 1)) for c in counts]
        for b in pattern:
            yield int(starts[b] + visits[b].pop())


def first_of_largest(counts: Sequence[int], n: int, seed: int, stream: int) -> List[int]:
    """``n`` distinct flat batches of the bucket with the most batches
    (not its last, which may be padded)."""
    b = int(np.argmax(counts))
    start = int(np.sum(counts[:b]))
    return [start + int(i) for i in rng(seed, stream).permutation(counts[b] - 1)[:n]]


def uniform_weights(shapes: Dict[str, Tuple[int, ...]], scales: Dict[str, float], seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """Weights U(-scale, scale) per leaf (a scale of 0: zeros), made on
    ``device`` from one generator in one call, then split."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    g = torch.Generator(device=device).manual_seed(seed_state(seed, 1))
    flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2.0).sub_(1.0)
    out, pos = {}, 0
    for k, n in zip(names, sizes):
        out[k] = flat[pos:pos + n].view(shapes[k]).mul(scales[k]).contiguous()
        pos += n
    return out


def is_uniform_site(site: str) -> bool:
    """The port's noise convention: uniforms for the dropout (``keep*``)
    and binarization (``*bin``) sites, standard normals otherwise."""
    return site.startswith("keep") or site.endswith("bin")


class Noise:
    """The ``noise(i, site, shape)`` provider handed to the port: draws in
    call order from one seeded device generator; ``"pick"`` (the aggressive
    loop's batch choice) takes the next index of ``picks``. A step begins
    at the first draw with a new ``i``: ``on_step(n, i)`` is then called
    with the step's number, before any of its work is queued. While
    ``record`` is a dict, every draw is kept there, on the host, under
    ``(n, site)``, and ``picked`` lists the picks while it is a list."""

    def __init__(self, seed: int, device, picks: Iterator[int]):
        self.device = device
        self.g = torch.Generator(device=device).manual_seed(seed_state(seed, 2))
        self.picks = picks
        self.on_step = None
        self.record = None
        self.picked = None
        self.steps = 0
        self._last = object()

    def __call__(self, i, site: str, shape):
        if i != self._last:
            self._last = i
            self.steps += 1
            if self.on_step is not None:
                self.on_step(self.steps - 1, i)
        if site == "pick":
            v = next(self.picks)
            if self.picked is not None:
                self.picked.append(v)
            return v
        fn = torch.rand if is_uniform_site(site) else torch.randn
        t = fn(tuple(shape), generator=self.g, device=self.device)
        if self.record is not None:
            self.record[(self.steps - 1, site)] = t.to("cpu", copy=True)
        return t

    def tagged(self, tag):
        """The provider with ``i`` made unique across calls: ``(tag, i)``."""
        return lambda i, site, shape: self(("c", tag, i), site, shape)


def indexed_noise(seed: int, key: int, site: str, shape, device) -> torch.Tensor:
    """One draw from its own generator, seeded by ``(seed, key, site)``."""
    g = torch.Generator(device=device).manual_seed(
        seed_state(seed, 3, key, *[ord(c) for c in site]))
    fn = torch.rand if is_uniform_site(site) else torch.randn
    return fn(tuple(shape), generator=g, device=device)
