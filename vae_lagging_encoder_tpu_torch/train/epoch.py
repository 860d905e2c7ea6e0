"""Evaluators over a pool: ELBO, MI, active units, importance-weighted NLL.

Counterparts of the evaluators in ``vae_lagging_encoder_tpu/train/
epoch.py`` (make_loss_fn in eval mode, make_eval_fn, make_mi_fn,
make_au_fn, make_iwnll_fn). Where the JAX package compiles one fused
reduction program per evaluator (``make_pool_reducer``), each evaluator
here is a host loop over the pool's batches in flat order that
accumulates on the device and reads the sums back once at the end.

Noise comes from a ``noise(batch_index, site, shape)`` provider: sites are
``"elbo"`` (eps [B, nsamples, nz]), ``"mi"`` ([B, 1, nz]) and ``"iw<j>"``
for IW chunk ``j`` ([B, ns, nz]). ``make_noise`` draws from a seeded
``torch.Generator``; a test can instead hand in the JAX package's exact
draws.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from ..data.pool import BucketedPool
from ..models.vae import VAE

Noise = Callable[[int, str, Tuple[int, ...]], torch.Tensor]


def make_noise(seed: int, device) -> Noise:
    """Standard-normal draws from one generator seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def noise(i: int, site: str, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.randn(shape, generator=g, device=device)

    return noise


def _safe_exp(x: float) -> float:
    try:
        return math.exp(x)
    except OverflowError:
        return float("inf")


def make_loss_fn(vae: VAE, nsamples: int = 1) -> Callable:
    """``loss_fn(batch, eps) -> (mean_loss, (loss_sum, rec_sum, kl_sum,
    n_sents, n_words))`` for ``batch = (tokens, mask, row_weight)``, in
    evaluation mode; mean_loss is per real sentence."""

    def loss_fn(batch, eps):
        tokens, mask, row_weight = batch
        loss, rec, kl = vae.loss(tokens, mask, row_weight, kl_weight=1.0,
                                 nsamples=nsamples, eps=eps)
        n_sents = row_weight.sum()
        n_words = (mask[:, 1:] * row_weight[:, None]).sum()
        loss_sum = loss.sum()
        return loss_sum / torch.clamp(n_sents, min=1.0), (
            loss_sum, rec.sum(), kl.sum(), n_sents, n_words)

    return loss_fn


def make_eval_fn(vae: VAE, pool: BucketedPool, nsamples: int = 1) -> Callable:
    """ELBO evaluation: ``eval_fn(noise) -> dict(loss, rec, kl, nll per
    sentence; ppl; n_sents, n_words)``."""
    loss_fn = make_loss_fn(vae, nsamples)

    @torch.no_grad()
    def eval_fn(noise: Noise) -> Dict[str, float]:
        sums = None
        for i, batch in enumerate(pool):
            eps = noise(i, "elbo", (batch[0].shape[0], nsamples, vae.nz))
            _, out = loss_fn(batch, eps)
            sums = out if sums is None else tuple(a + b for a, b in zip(sums, out))
        loss_s, rec_s, kl_s, n_sent, n_words = torch.stack(sums).tolist()
        return {"loss": loss_s / n_sent, "rec": rec_s / n_sent, "kl": kl_s / n_sent,
                "nll": (rec_s + kl_s) / n_sent,
                "ppl": _safe_exp((rec_s + kl_s) / n_words),
                "n_sents": n_sent, "n_words": n_words}

    return eval_fn


def make_mi_fn(vae: VAE, pool: BucketedPool) -> Callable:
    """Corpus MI: batch-size-weighted mean of per-batch MI estimates."""

    @torch.no_grad()
    def mi_fn(noise: Noise) -> float:
        mi_sum, n_sum = 0.0, 0.0
        for i, (x, mask, row_weight) in enumerate(pool):
            eps = noise(i, "mi", (x.shape[0], 1, vae.nz))
            n = row_weight.sum()
            mi_sum = mi_sum + vae.calc_mi_q(x, mask, row_weight, eps) * n
            n_sum = n_sum + n
        mi_sum, n_sum = torch.stack([mi_sum, n_sum]).tolist()
        return mi_sum / max(n_sum, 1.0)

    return mi_fn


def make_au_fn(vae: VAE, pool: BucketedPool, delta: float = 0.01) -> Callable:
    """Active units: #dims with Var_x[mu(x)] > delta, in two passes."""

    @torch.no_grad()
    def au_fn() -> Tuple[int, torch.Tensor]:
        mu_sum, n = 0.0, 0.0
        for x, mask, row_weight in pool:
            mu = vae.calc_infer_mean(x, mask)
            mu_sum = mu_sum + torch.sum(mu * row_weight[:, None], dim=0)
            n = n + row_weight.sum()
        mu_mean = mu_sum / torch.clamp(n, min=1.0)
        var_sum = 0.0
        for x, mask, row_weight in pool:
            mu = vae.calc_infer_mean(x, mask)
            var_sum = var_sum + torch.sum((mu - mu_mean) ** 2 * row_weight[:, None], dim=0)
        var = (var_sum / torch.clamp(n - 1.0, min=1.0)).cpu()
        return int((var > delta).sum()), var

    return au_fn


def make_iwnll_fn(vae: VAE, pool: BucketedPool, nsamples: int = 500,
                  ns: int = 100) -> Callable:
    """Importance-weighted NLL + PPL over a pool (the reference's calc_iwnll)."""

    @torch.no_grad()
    def iwnll_fn(noise: Noise) -> Dict[str, float]:
        sums = torch.zeros(3, device=pool.arrays[0][0].device)
        for i, (x, mask, row_weight) in enumerate(pool):
            nll = vae.nll_iw(x, mask, nsamples, ns,
                             noise=lambda j, shape, i=i: noise(i, f"iw{j}", shape))
            sums = sums + torch.stack([(nll * row_weight).sum(), row_weight.sum(),
                                       (mask[:, 1:] * row_weight[:, None]).sum()])
        nll_sum, n_sent, n_words = sums.tolist()
        return {"nll": nll_sum / n_sent, "ppl": _safe_exp(nll_sum / n_words),
                "n_sents": n_sent, "n_words": n_words}

    return iwnll_fn
