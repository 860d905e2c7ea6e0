"""Gaussian-posterior encoder machinery.

Counterpart of ``vae_lagging_encoder_tpu/models/encoder.py`` (the
reference's GaussianEncoderBase): reparameterization, the analytic KL to
N(0, I), the inference-distribution density and the paper's mutual-
information estimator, as plain functions on (mu, logvar) tensors.
Estimators take an optional ``row_weight`` so zero-weight pad rows drop
out of means and out of the aggregate posterior mixture exactly.

Noise is explicit: pass ``eps`` (e.g. the JAX package's exact draws, in
tests) or a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..utils.numeric import log_sum_exp


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, nsamples: int = 1,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """z = mu + std * eps, eps ~ N(0, I) [B, nsamples, nz]. Returns [B, nsamples, nz]."""
    B, nz = mu.shape
    std = torch.exp(0.5 * logvar)
    if eps is None:
        eps = torch.randn((B, nsamples, nz), generator=generator,
                          device=mu.device, dtype=mu.dtype)
    return mu[:, None, :] + eps * std[:, None, :]


def gaussian_kl(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Analytic KL(q(z|x) || N(0, I)) per row: [B]."""
    return 0.5 * torch.sum(mu ** 2 + torch.exp(logvar) - logvar - 1.0, dim=-1)


def eval_inference_dist(z: torch.Tensor, mu: torch.Tensor,
                        logvar: torch.Tensor) -> torch.Tensor:
    """log q(z|x) for z [B, K, nz] under per-row Gaussians: [B, K]."""
    nz = mu.shape[-1]
    var = torch.exp(logvar)
    dev = z - mu[:, None, :]
    return (-0.5 * torch.sum(dev ** 2 / var[:, None, :], dim=-1)
            - 0.5 * (nz * math.log(2 * math.pi) + torch.sum(logvar, dim=-1))[:, None])


def calc_mi(mu: torch.Tensor, logvar: torch.Tensor,
            row_weight: Optional[torch.Tensor] = None,
            eps: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The paper's MI estimator over one batch (scalar tensor):
    I(x; z) ~ E_x[-H(q(z|x))] - E_{x,z}[log q(z)], with q(z) the batch
    mixture (one z per x; ``eps`` [B, 1, nz])."""
    B, nz = mu.shape
    if row_weight is None:
        row_weight = mu.new_ones((B,))
    n = torch.clamp(row_weight.sum(), min=1.0)
    neg_entropy = torch.sum(
        row_weight * (-0.5 * nz * (1.0 + math.log(2 * math.pi))
                      - 0.5 * torch.sum(logvar, dim=-1))) / n
    z = reparameterize(mu, logvar, 1, eps, generator)[:, 0, :]  # [B, nz]
    var = torch.exp(logvar)
    dev = z[:, None, :] - mu[None, :, :]
    log_density = (-0.5 * torch.sum(dev ** 2 / var[None, :, :], dim=-1)
                   - 0.5 * (nz * math.log(2 * math.pi)
                            + torch.sum(logvar, dim=-1))[None, :])
    log_w = torch.where(row_weight > 0, 0.0, -math.inf)[None, :]
    log_qz = log_sum_exp(log_density + log_w, dim=1) - torch.log(n)
    log_qz_mean = torch.sum(row_weight * log_qz) / n
    return neg_entropy - log_qz_mean


class GaussianEncoderBase(nn.Module):
    """Subclasses implement ``forward(x, mask) -> (mu [B, nz], logvar [B, nz])``."""

    nz: int

    def sample(self, x, mask=None, nsamples: int = 1, eps=None, generator=None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        mu, logvar = self(x, mask)
        return reparameterize(mu, logvar, nsamples, eps, generator), (mu, logvar)

    def encode(self, x, mask=None, nsamples: int = 1, eps=None, generator=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (z [B, K, nz], KL [B])."""
        mu, logvar = self(x, mask)
        return reparameterize(mu, logvar, nsamples, eps, generator), gaussian_kl(mu, logvar)

    def calc_mi(self, x, mask=None, row_weight=None, eps=None, generator=None) -> torch.Tensor:
        mu, logvar = self(x, mask)
        return calc_mi(mu, logvar, row_weight, eps, generator)
