"""Device-resident batch pools.

Counterpart of ``vae_lagging_encoder_tpu/data/pool.py``. ``BucketedPool``
stacks the padded text batches once per bucket length into tensors on the
device — tokens [n_b, B, L_b] int64, mask [n_b, B, L_b] f32, row_weight
[n_b, B] f32; ``ImagePool`` holds one bucket of image batches — probs
[n_b, B, H, W, C] f32 (grayscale probabilities, binarized in the loss),
row_weight [n_b, B]. Both iterate in the JAX package's flat order: buckets
by ascending length, then batch index inside a bucket. Flat batch ``i`` is
the ``i`` the JAX evaluators fold into their per-batch key, so noise
injected by batch index lines up with the reference. ``coords`` maps a flat
index to (bucket, index in bucket) by ``searchsorted`` over the cumulative
counts, as the JAX package's ``sample_coords`` maps its uniform draw;
``batch`` reads one batch. Both run on the host (for text the bucket
decides the sequence length, so the caller needs it there anyway).
``shard`` keeps a data-parallel rank's rows of every batch.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .omniglot import image_batches
from .text import TextBatch


class Pool:
    """Batches stacked per bucket in ``arrays``; flat-order access."""

    arrays: List[Tuple[torch.Tensor, ...]]

    def _finalize(self, counts: Sequence[int]) -> None:
        self.counts = list(counts)
        self.cum = np.concatenate([[0], np.cumsum(self.counts)]).astype(np.int64)
        self.num_batches = int(self.cum[-1])

    def coords(self, flat: int) -> Tuple[int, int]:
        """Flat batch index -> (bucket, index within the bucket)."""
        if not 0 <= flat < self.num_batches:
            raise IndexError(f"batch {flat} outside [0, {self.num_batches})")
        bucket = int(np.searchsorted(self.cum, flat, side="right") - 1)
        return bucket, int(flat - self.cum[bucket])

    def batch(self, flat: int) -> Tuple[torch.Tensor, ...]:
        """Flat batch ``flat``: one tensor per array of its bucket."""
        bucket, idx = self.coords(flat)
        return tuple(a[idx] for a in self.arrays[bucket])

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        """Batches in flat order."""
        for arrs in self.arrays:
            for i in range(arrs[0].shape[0]):
                yield tuple(a[i] for a in arrs)

    def shard(self, mesh) -> "Pool":
        """Keep only this dp rank's contiguous rows of every batch (the JAX
        package's ``P(None, "dp")``; parallel/dp.py::shard_rows), in place.
        The batch count and order are unchanged. Training pools only: the
        evaluators split a whole pool by batch instead."""
        from ..parallel.dp import shard_rows

        self.arrays = [tuple(shard_rows(mesh, a, dim=1).contiguous() for a in arrs)
                       for arrs in self.arrays]
        return self


class BucketedPool(Pool):
    """Text batches: ``(tokens [B, L], mask [B, L], row_weight [B])``."""

    def __init__(self, batches: Sequence[TextBatch], device):
        if not batches:
            raise ValueError("empty batch list")
        groups = {}
        for b in batches:
            groups.setdefault(b.seq_len, []).append(b)
        self.lengths: Tuple[int, ...] = tuple(sorted(groups))
        self.arrays = []
        for L in self.lengths:
            grp = groups[L]
            self.arrays.append((
                torch.from_numpy(np.stack([g.tokens for g in grp]).astype(np.int64)).to(device),
                torch.from_numpy(np.stack([g.mask for g in grp])).to(device),
                torch.from_numpy(np.stack([g.row_weight for g in grp])).to(device),
            ))
        self._finalize([len(groups[L]) for L in self.lengths])


class ImagePool(Pool):
    """Image batches: ``(probs [B, H, W, C], row_weight [B])``; a partial
    last batch is zero-padded with row_weight 0 (``image_batches``), or,
    with ``pad=False``, kept at its own size as a second bucket (a batch
    norm's statistics over a training batch would count padded rows)."""

    def __init__(self, images: np.ndarray, batch_size: int, device, pad: bool = True):
        n = len(images) if pad else len(images) // batch_size * batch_size
        parts = [image_batches(images[:n], batch_size)] if n else []
        if n < len(images):
            parts.append(image_batches(images[n:], len(images) - n))
        if not parts:
            raise ValueError("no images")
        self.arrays = [(torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))
                       for a, b in parts]
        self._finalize([a.shape[0] for a, _ in parts])
