"""Device-resident bucketed batch pool.

Counterpart of ``vae_lagging_encoder_tpu/data/pool.py::BucketedPool``: the
padded batches are stacked once per bucket length into tensors on the
device — tokens [n_b, B, L_b] int64, mask [n_b, B, L_b] f32, row_weight
[n_b, B] f32 — and iterated in the JAX package's flat order: buckets by
ascending length, then batch index inside a bucket. Flat batch ``i`` is the
``i`` the JAX evaluators fold into their per-batch key, so noise injected
by batch index lines up with the reference.
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
        self.num_batches = int(sum(self.counts))

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Batches ``(tokens [B, L], mask [B, L], row_weight [B])`` in flat order."""
        for tokens, mask, row_weight in self.arrays:
            for i in range(tokens.shape[0]):
                yield tokens[i], mask[i], row_weight[i]
