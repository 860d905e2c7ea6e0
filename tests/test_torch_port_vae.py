"""The port's VAE estimators against the JAX package's, on the same weights
and the JAX package's own noise: ``loss``, ``nll_iw``, ``KL`` and
``calc_mi_q``. The reparameterization eps is drawn with ``jax.random`` from
the key schedule each JAX estimator uses and handed to the port.

Small widths (enc/dec nh 128, V 1100, nz 4). The scan route is held against
the JAX scan/XLA route; the kernel route against the JAX Pallas route with
its kernels in interpret mode.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vae_lagging_encoder_tpu.models import (VAE as JaxVAE, GaussianLSTMEncoder as JaxEncoder,
                                            LSTMDecoder as JaxDecoder)
from vae_lagging_encoder_tpu_torch.models import VAE, GaussianLSTMEncoder, LSTMDecoder
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

V, NI, NH, NZ = 1100, 16, 128, 4
B, T = 8, 10
# per-sentence sums of ~9 token log-probs (~7 nats each) in f32 in another
# order; ELBO/IW terms are those sums plus O(1) Gaussian terms
ATOL = 1e-4


def _setup(kernel_route, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(4, V, (B, T)).astype(np.int32)
    lens = rng.randint(3, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    tokens = np.where(mask > 0, tokens, 0).astype(np.int32)
    row_weight = np.ones(B, np.float32)
    row_weight[-2:] = 0.0  # two pad rows
    backend = "pallas" if kernel_route else "scan"
    with pltpu.force_tpu_interpret_mode():
        vae_j = JaxVAE(JaxEncoder(V, NI, NH, NZ, backend=backend),
                       JaxDecoder(V, NI, NH, NZ, dropout_in=0.0, dropout_out=0.0,
                                  backend=backend))
    params = jax.device_get(vae_j.init(jax.random.PRNGKey(seed)))
    # larger encoder output weights so that the posterior is not ~N(0, I)
    params["enc"]["linear"] = (rng.randn(NH, 2 * NZ) * 0.3).astype(np.float32)
    vae = VAE(GaussianLSTMEncoder(V, NI, NH, NZ, kernel_route=kernel_route),
              LSTMDecoder(V, NI, NH, NZ, kernel_route=kernel_route))
    vae.load_state_dict(from_jax_params(params))
    pj = jax.tree.map(jnp.asarray, params)
    jx = (jnp.asarray(tokens), jnp.asarray(mask))
    tx = (torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    return vae_j, pj, jx, jnp.asarray(row_weight), vae, tx, torch.from_numpy(row_weight)


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))


@pytest.mark.parametrize("kernel_route", [False, True])
def test_loss_matches_jax(kernel_route):
    vae_j, pj, jx, rw_j, vae, tx, rw = _setup(kernel_route)
    key = jax.random.PRNGKey(11)
    with pltpu.force_tpu_interpret_mode():
        want = jax.device_get(vae_j.loss(pj, key, *jx, row_weight=rw_j, kl_weight=0.7,
                                         nsamples=2, train=False))
    eps = _normal(jax.random.split(key)[0], (B, 2, NZ))  # loss: k_enc = split(key)[0]
    with torch.no_grad():
        got = vae.loss(*tx, row_weight=rw, kl_weight=0.7, nsamples=2, eps=eps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel_route", [False, True])
def test_nll_iw_matches_jax(kernel_route):
    vae_j, pj, jx, _, vae, tx, _ = _setup(kernel_route, seed=1)
    key = jax.random.PRNGKey(12)
    nsamples, ns = 30, 10  # three chunks; the decoder chunks 10 into iw_chunk
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(vae_j.nll_iw(pj, key, *jx, nsamples=nsamples, ns=ns))
    with torch.no_grad():
        got = vae.nll_iw(*tx, nsamples=nsamples, ns=ns,
                         noise=lambda j, shape: _normal(jax.random.fold_in(key, j), shape))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_nll_iw_rejects_indivisible_chunks():
    *_, vae, tx, _ = _setup(False)
    with pytest.raises(ValueError, match="divisible"):
        vae.nll_iw(*tx, nsamples=25, ns=10)


def test_kl_mi_and_infer_mean_match_jax():
    vae_j, pj, jx, rw_j, vae, tx, rw = _setup(False, seed=2)
    key = jax.random.PRNGKey(13)
    kl_j = np.asarray(vae_j.KL(pj, *jx))
    mi_j = float(vae_j.calc_mi_q(pj, key, *jx, row_weight=rw_j))
    mu_j = np.asarray(vae_j.calc_infer_mean(pj, *jx))
    with torch.no_grad():
        kl = vae.KL(*tx)
        mi = vae.calc_mi_q(*tx, row_weight=rw, eps=_normal(key, (B, 1, NZ)))
        mu = vae.calc_infer_mean(*tx)
    np.testing.assert_allclose(kl.numpy(), kl_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(mu.numpy(), mu_j, atol=1e-5, rtol=0)
    assert math.isclose(float(mi), mi_j, abs_tol=1e-5)
    # pad rows leave the MI estimate: dropping them changes nothing
    with torch.no_grad():
        mi_real = vae.calc_mi_q(tx[0][:-2], tx[1][:-2],
                                eps=_normal(key, (B, 1, NZ))[:-2])
    assert math.isclose(float(mi_real), float(mi), abs_tol=1e-5)
