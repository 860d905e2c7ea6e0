"""Device-resident bucketed batch pool.

Counterpart of ``vae_lagging_encoder_tpu/data/pool.py::BucketedPool``: the
padded batches are stacked once per bucket length into tensors on the
device — tokens [n_b, B, L_b] int64, mask [n_b, B, L_b] f32, row_weight
[n_b, B] f32 — and iterated in the JAX package's flat order: buckets by
ascending length, then batch index inside a bucket. Flat batch ``i`` is the
``i`` the JAX evaluators fold into their per-batch key, so noise injected
by batch index lines up with the reference. ``coords`` maps a flat index
to (bucket, index in bucket) by ``searchsorted`` over the cumulative counts,
as the JAX package's ``sample_coords`` maps its uniform draw; ``batch``
reads one batch. Both run on the host (the bucket decides the sequence
length, so the caller needs it there anyway).
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .text import TextBatch


class BucketedPool:
    def __init__(self, batches: Sequence[TextBatch], device):
        if not batches:
            raise ValueError("empty batch list")
        groups = {}
        for b in batches:
            groups.setdefault(b.seq_len, []).append(b)
        self.lengths: Tuple[int, ...] = tuple(sorted(groups))
        self.arrays: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        for L in self.lengths:
            grp = groups[L]
            self.arrays.append((
                torch.from_numpy(np.stack([g.tokens for g in grp]).astype(np.int64)).to(device),
                torch.from_numpy(np.stack([g.mask for g in grp])).to(device),
                torch.from_numpy(np.stack([g.row_weight for g in grp])).to(device),
            ))
        self.counts = [len(groups[L]) for L in self.lengths]
        self.cum = np.concatenate([[0], np.cumsum(self.counts)]).astype(np.int64)
        self.num_batches = int(self.cum[-1])

    def coords(self, flat: int) -> Tuple[int, int]:
        """Flat batch index -> (bucket, index within the bucket)."""
        if not 0 <= flat < self.num_batches:
            raise IndexError(f"batch {flat} outside [0, {self.num_batches})")
        bucket = int(np.searchsorted(self.cum, flat, side="right") - 1)
        return bucket, int(flat - self.cum[bucket])

    def batch(self, flat: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Flat batch ``flat``: ``(tokens [B, L], mask [B, L], row_weight [B])``."""
        bucket, idx = self.coords(flat)
        return tuple(a[idx] for a in self.arrays[bucket])

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Batches ``(tokens [B, L], mask [B, L], row_weight [B])`` in flat order."""
        for tokens, mask, row_weight in self.arrays:
            for i in range(tokens.shape[0]):
                yield tokens[i], mask[i], row_weight[i]
