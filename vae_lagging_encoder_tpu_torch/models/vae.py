"""VAE composition and the estimators the final evaluation reports.

Counterpart of ``vae_lagging_encoder_tpu/models/vae.py`` (the reference's
modules/vae.py): loss (per-sentence loss/rec/KL), eval_complete_ll,
nll_iw (importance-weighted NLL in chunks of ``ns``), KL, calc_mi_q,
calc_infer_mean, and generation and the toy's probe: sample_from_prior,
reconstruct and calc_model_posterior_mean. Submodules ``enc`` and ``dec``
mirror the JAX package's ``{"enc": ..., "dec": ...}`` parameter tree.

Noise is explicit: each estimator takes ``eps`` (or, for ``nll_iw``, a
``noise(j, shape)`` callable per chunk) or a ``torch.Generator``; the
training loss takes a ``draw(site, shape)`` callable for all of a step's
draws (see ``loss``); ``reconstruct`` takes ``eps`` and the decoder's
per-step ``noise``, or one generator for both, as the JAX package's
``reconstruct`` uses one key for both.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..utils.numeric import log_sum_exp
from ..utils.profiling import span
from .encoder import eval_inference_dist, gaussian_kl
from .modes import module_mode


class VAE(nn.Module):
    """``x`` is (tokens [B, T], mask [B, T]) for text and (images
    [B, H, W, C] binarized, mask None) for images."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.enc = encoder
        self.dec = decoder
        self.nz = encoder.nz

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.enc.reset_parameters(generator)
        self.dec.reset_parameters(generator)

    def sample_from_prior(self, nsamples: int, generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        """z ~ N(0, I): [nsamples, nz] on the model's device."""
        dev = next(self.parameters()).device
        return torch.randn((nsamples, self.nz), generator=generator, device=dev)

    def eval_prior_dist(self, z: torch.Tensor) -> torch.Tensor:
        """log p(z) under N(0, I): [..., nz] -> [...]."""
        return -0.5 * (torch.sum(z ** 2, dim=-1) + self.nz * math.log(2 * math.pi))

    def loss(self, x, mask=None, row_weight=None, kl_weight: float = 1.0,
             nsamples: int = 1, eps=None, generator=None, draw=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-sentence (loss, rec, kl), each [B] (per image for images).

        loss = rec + kl_weight * KL, rec = E_{z~q}[-log p(x|z)] averaged over
        ``nsamples`` (``eps`` [B, nsamples, nz]); zero-weight pad rows are
        zeroed. Without ``draw`` this is evaluation mode (no dropout). With
        ``draw(site, shape)`` it is the JAX package's ``train=True``: eps is
        ``draw("eps", (B, nsamples, nz))`` and the decoder draws its dropout
        uniforms (sites ``"keep_in"``, ``"keep_out"``), in that order."""
        if draw is not None:
            eps = draw("eps", (x.shape[0], nsamples, self.nz))
        z, kl = self.enc.encode(x, mask, nsamples, eps, generator)
        rec = self.dec.reconstruct_error(x, mask, z, draw=draw).mean(dim=1)
        if row_weight is not None:
            rec = rec * row_weight
            kl = kl * row_weight
        return rec + kl_weight * kl, rec, kl

    def eval_complete_ll(self, x, mask, z) -> torch.Tensor:
        """log p(x, z) = log p(z) + log p(x|z): z [B, K, nz] -> [B, K]."""
        return self.eval_prior_dist(z) + self.dec.log_probability(x, mask, z)

    def nll_iw(self, x, mask=None, nsamples: int = 500, ns: int = 100,
               noise: Optional[Callable[[int, Tuple[int, ...]], torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               log_px: Optional[Callable] = None) -> torch.Tensor:
        """Importance-weighted NLL per sentence: [B].

        ``nsamples`` z ~ q(z|x) in chunks of ``ns`` (each chunk re-encodes x,
        as the reference does): w = log p(x, z) - log q(z|x), NLL =
        -(logsumexp(w) - log nsamples). Chunk ``j`` draws its eps
        [B, ns, nz] from ``noise(j, shape)`` when given, else from
        ``generator``. ``log_px(x, mask, z) -> [B, K]`` is the decoder's
        likelihood (default ``dec.log_probability``; the vocab-sharded one
        under tensor parallelism, parallel/tp.py). Under a profiler each
        chunk is the span ``iw_chunk``, with its device time."""
        log_px = log_px or self.dec.log_probability
        ns = min(ns, nsamples)
        if nsamples % ns:
            raise ValueError(f"nll_iw: nsamples {nsamples} must be divisible by ns {ns}")
        B = x.shape[0]
        log_w = []
        for j in range(nsamples // ns):
            with span("iw_chunk", device=True):
                eps = noise(j, (B, ns, self.nz)) if noise is not None else None
                z, (mu, logvar) = self.enc.sample(x, mask, ns, eps, generator)
                log_w.append(self.eval_prior_dist(z) + log_px(x, mask, z)
                             - eval_inference_dist(z, mu, logvar))
        return -(log_sum_exp(torch.cat(log_w, dim=1), dim=1) - math.log(nsamples))

    def KL(self, x, mask=None) -> torch.Tensor:
        """Analytic KL per row: [B]."""
        mu, logvar = self.enc(x, mask)
        return gaussian_kl(mu, logvar)

    def calc_mi_q(self, x, mask=None, row_weight=None, eps=None, generator=None) -> torch.Tensor:
        """Batch MI estimate (scalar tensor)."""
        return self.enc.calc_mi(x, mask, row_weight, eps, generator)

    def calc_infer_mean(self, x, mask=None) -> torch.Tensor:
        """mu(x) of the approximate posterior: [B, nz]."""
        mu, _ = self.enc(x, mask)
        return mu

    @torch.no_grad()
    def reconstruct(self, x, mask=None, decoding_strategy: str = "greedy", max_len: int = 100,
                    eps=None, noise=None, generator: Optional[torch.Generator] = None):
        """Decode one z ~ q(z|x) per row: text ids [B, max_len] (greedy,
        sample) or hypotheses (beam); binary images [B, H, W, C]. ``eps``
        [B, 1, nz] and the decoder's ``noise`` default to draws from
        ``generator`` (eps first). In evaluation mode (models/modes.py)."""
        with module_mode(self, False):
            z, _ = self.enc.sample(x, mask, 1, eps, generator)
            z_flat = z[:, 0, :]
            if decoding_strategy == "greedy":
                return self.dec.greedy_decode(z_flat, max_len)
            if decoding_strategy == "sample":
                return self.dec.sample_decode(z_flat, max_len, noise=noise, generator=generator)
            if decoding_strategy == "beam":
                return self.dec.beam_search_decode(z_flat, max_len=max_len)
        raise ValueError(decoding_strategy)

    def calc_model_posterior_mean(self, x, mask, z_grid: torch.Tensor) -> torch.Tensor:
        """<z> under the model's posterior p(z|x) by quadrature on ``z_grid``
        [G, nz]: p(z|x) proportional to p(x|z) p(z) on the grid; returns the
        softmax-weighted grid mean [B, nz]."""
        z = z_grid[None].expand(x.shape[0], *z_grid.shape)
        w = torch.softmax(self.eval_complete_ll(x, mask, z), dim=1)  # [B, G]
        return torch.einsum("bg,gz->bz", w, z_grid)
