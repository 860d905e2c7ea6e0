"""OmniGlot image data.

The port's own copy of ``vae_lagging_encoder_tpu/data/omniglot.py``: the
reference's ``datasets/omniglot_data/omniglot.pt`` (train/val/test
grayscale-probability tensors, 28x28) or an ``.npz`` of the same arrays,
normalized to float32 [N, 28, 28, 1] in [0, 1]; a missing file warns and
falls back to a deterministic synthetic substitute with OmniGlot's shapes
and class structure (the same arrays as the JAX package's for the same
seed). Binarization is dynamic (a fresh Bernoulli draw per step and at
evaluation) and happens on the device in the loss (``train/epoch.py``).
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Tuple

import numpy as np

# The reference's scale: ~24,345 train / 8,070 test images. A smaller
# substitute lets the PixelCNN memorize the corpus and voids the latent.
_SYNTH_SIZES = {"train": 24000, "val": 1000, "test": 1000}

# the render loop costs ~10 s at reference scale: memoized per seed;
# callers treat the arrays as read-only
_SYNTH_CACHE: Dict[int, Dict[str, np.ndarray]] = {}


def _as_prob_arrays(obj) -> Dict[str, np.ndarray]:
    """Normalize a loaded .pt/.npz payload to {split: float32 [N,28,28,1]}."""
    out = {}
    if hasattr(obj, "keys"):
        items = {k: obj[k] for k in obj.keys()}
    elif isinstance(obj, (list, tuple)):
        items = dict(zip(("train", "val", "test"), obj))
    else:
        items = {"train": obj}
    for k, v in items.items():
        arr = np.asarray(v, dtype=np.float32)
        if arr.ndim == 2:  # [N, 784]
            arr = arr.reshape(arr.shape[0], 28, 28, 1)
        elif arr.ndim == 3:  # [N, 28, 28]
            arr = arr[..., None]
        elif arr.ndim == 4 and arr.shape[1] == 1:  # NCHW -> NHWC
            arr = np.transpose(arr, (0, 2, 3, 1))
        if arr.max() > 1.0:
            arr = arr / 255.0
        key = {"valid": "val", "validation": "val"}.get(str(k).lower(), str(k).lower())
        out[key] = np.clip(arr, 0.0, 1.0)
    return out


def _render_glyph(strokes: np.ndarray, rng, ys, xs) -> np.ndarray:
    """Render one drawing of a prototype: per-drawing global shift/rotation
    plus per-stroke parameter jitter over gaussian-ridge strokes."""
    img = np.zeros((28, 28), np.float32)
    gdy, gdx = rng.normal(0, 1.5, size=2)
    grot = rng.normal(0, 0.15)
    for (cy, cx, ang, l_, w_) in strokes:
        # rotate the stroke center around the canvas center, then jitter
        ry = 14 + (cy - 14) * np.cos(grot) - (cx - 14) * np.sin(grot)
        rx = 14 + (cy - 14) * np.sin(grot) + (cx - 14) * np.cos(grot)
        cy_ = ry + gdy + rng.normal(0, 0.7)
        cx_ = rx + gdx + rng.normal(0, 0.7)
        # the stroke axis co-rotates with the center: R(grot)·(sin a, cos a)
        # = (sin(a - grot), cos(a - grot)), a rigid rotation of the glyph
        ang_ = ang - grot + rng.normal(0, 0.1)
        l2 = l_ * rng.uniform(0.85, 1.15)
        w2 = w_ * rng.uniform(0.85, 1.15)
        dy, dx = ys - cy_, xs - cx_
        u = dy * np.sin(ang_) + dx * np.cos(ang_)
        v = -dy * np.cos(ang_) + dx * np.sin(ang_)
        img += np.exp(-(u / l2) ** 2 - (v / w2) ** 2)
    return np.clip(img, 0, 1)


def _synthetic_omniglot(seed: int = 783435) -> Dict[str, np.ndarray]:
    """Class-structured stroke glyphs (offline substitute): 1000 prototype
    "characters" (fixed stroke layouts), each rendered many times with
    per-drawing deformations. Train uses prototypes 0-799 (~30 drawings
    each); val and test use 100 held-out prototypes each, as OmniGlot
    evaluates on unseen characters."""
    if seed in _SYNTH_CACHE:
        return _SYNTH_CACHE[seed]
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:28, 0:28].astype(np.float32)
    protos = []
    for _ in range(1000):
        n_strokes = rng.randint(2, 6)
        protos.append(np.stack([
            rng.uniform(6, 22, size=n_strokes),        # cy
            rng.uniform(6, 22, size=n_strokes),        # cx
            rng.uniform(0, np.pi, size=n_strokes),     # angle
            rng.uniform(3, 9, size=n_strokes),         # length
            rng.uniform(0.6, 1.6, size=n_strokes),     # width
        ], axis=1))
    split_protos = {"train": protos[:800], "val": protos[800:900],
                    "test": protos[900:]}
    out = {}
    for split, n in _SYNTH_SIZES.items():
        ps = split_protos[split]
        imgs = np.zeros((n, 28, 28, 1), np.float32)
        for i in range(n):
            imgs[i, :, :, 0] = _render_glyph(ps[i % len(ps)], rng, ys, xs)
        out[split] = imgs
    _SYNTH_CACHE[seed] = out
    return out


def load_omniglot(path: str = "datasets/omniglot_data/omniglot.pt",
                  allow_synthetic: bool = True,
                  seed: int = 783435) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (train, val, test) float32 probability arrays [N, 28, 28, 1]."""
    data: Dict[str, np.ndarray] | None = None
    if path and os.path.isfile(path):
        if path.endswith(".npz"):
            data = _as_prob_arrays(np.load(path))
        else:
            import torch  # the reference's .pt payload (a pickle of tensors)
            data = _as_prob_arrays(torch.load(path, map_location="cpu",
                                              weights_only=False))
    elif allow_synthetic:
        if path:
            warnings.warn(f"{path} not found — using the SYNTHETIC OmniGlot "
                          "substitute; results are not real-OmniGlot numbers",
                          stacklevel=2)
        # reuse the npz ensure_omniglot_dataset() wrote for this seed (the
        # file is seed-stamped; another seed's file is not served)
        npz = os.path.join(os.path.dirname(path) or "datasets/omniglot_data",
                           "omniglot_synthetic.npz")
        if os.path.isfile(npz):
            with np.load(npz) as z:
                file_seed = int(z["seed"][()]) if "seed" in z.files else None
                if file_seed == seed:
                    data = _as_prob_arrays(
                        {k: z[k] for k in z.files if k != "seed"})
        if data is None:
            data = _synthetic_omniglot(seed)
    else:
        raise FileNotFoundError(
            f"{path} not found; pass allow_synthetic=True for the offline substitute")

    train = data.get("train")
    if train is None:
        raise ValueError(
            f"{path or 'payload'}: no 'train' split among keys "
            f"{sorted(data)} — cannot interpret this as an OmniGlot corpus")
    test = data.get("test")
    if test is None:  # carved from the train tail and REMOVED from train, so
        # the val fallback below cannot overlap it
        n_test = min(500, max(1, len(train) // 5))
        train, test = train[:-n_test], train[-n_test:]
    val = data.get("val")
    if val is None:  # the reference carves val out of train when absent
        n_val = max(1, len(train) // 10)
        train, val = train[:-n_val], train[-n_val:]
    return train, val, test


def ensure_omniglot_dataset(root: str = "datasets/omniglot_data",
                            seed: int = 783435) -> str:
    """Write the synthetic substitute as a seed-stamped .npz; return its
    path. A file written for another seed is regenerated."""
    path = os.path.join(root, "omniglot_synthetic.npz")
    if os.path.isfile(path):
        with np.load(path) as z:
            if "seed" in z.files and int(z["seed"][()]) == seed:
                return path
    os.makedirs(root, exist_ok=True)
    np.savez_compressed(path, seed=np.int64(seed), **_synthetic_omniglot(seed))
    return path


def image_batches(images: np.ndarray, batch_size: int,
                  drop_remainder: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Stack into [num_batches, B, 28, 28, 1] + row weights [num_batches, B].

    A partial final batch is zero-padded with row_weight 0 (the masking
    convention of the text batches), so every batch has one shape."""
    n = len(images)
    num_batches = n // batch_size if drop_remainder else -(-n // batch_size)
    out = np.zeros((num_batches, batch_size) + images.shape[1:], images.dtype)
    w = np.zeros((num_batches, batch_size), np.float32)
    for i in range(num_batches):
        chunk = images[i * batch_size:(i + 1) * batch_size]
        out[i, : len(chunk)] = chunk
        w[i, : len(chunk)] = 1.0
    return out, w
