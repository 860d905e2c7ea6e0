"""The port's encoder and decoder against the JAX package's, on the same
weights (``from_jax_params``) at small widths (nh 128, V 1100).

Each route is held against the JAX route it stands for: the kernel route
against the JAX Pallas route with its kernels in interpret mode (as
tests/test_pallas.py runs them), the scan route against the JAX scan/XLA
route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vae_lagging_encoder_tpu.models import GaussianLSTMEncoder as JaxEncoder
from vae_lagging_encoder_tpu.models import LSTMDecoder as JaxDecoder
from vae_lagging_encoder_tpu_torch.models import GaussianLSTMEncoder, LSTMDecoder
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

V, NI, NH, NZ = 1100, 16, 128, 4
B, T, K = 8, 10, 25  # K > iw_chunk on both routes (20 kernel, 10 scan)

# f32 LSTM/matmuls in another summation order: ~1e-6 per element; the
# encoder head is one 128-long dot
ENC_ATOL = 2e-5
# token-summed NLLs of ~9 tokens x ~7 nats: f32 sums of per-token values
# that agree to ~1e-5 (the CE runs bf16 operands on both kernel routes)
REC_ATOL = 1e-4


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(4, V, (B, T)).astype(np.int32)
    lens = rng.randint(3, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    tokens = np.where(mask > 0, tokens, 0).astype(np.int32)
    z = rng.randn(B, K, NZ).astype(np.float32)
    return tokens, mask, z


@pytest.mark.parametrize("kernel_route", [False, True])
def test_encoder_matches_jax(kernel_route):
    tokens, mask, _ = _batch(1)
    backend = "pallas" if kernel_route else "scan"
    enc_j = JaxEncoder(V, NI, NH, NZ, backend=backend)
    params = jax.device_get(enc_j.init(jax.random.PRNGKey(0)))
    with pltpu.force_tpu_interpret_mode():
        mu_j, lv_j = jax.device_get(enc_j.forward(_jnp(params), jnp.asarray(tokens),
                                                  jnp.asarray(mask)))
    enc = GaussianLSTMEncoder(V, NI, NH, NZ, kernel_route=kernel_route)
    enc.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        mu, lv = enc(torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(mu.numpy(), mu_j, atol=ENC_ATOL, rtol=0)
    np.testing.assert_allclose(lv.numpy(), lv_j, atol=ENC_ATOL, rtol=0)


@pytest.mark.parametrize("kernel_route", [False, True])
def test_decoder_reconstruct_error_matches_jax(kernel_route):
    tokens, mask, z = _batch(2)
    backend = "pallas" if kernel_route else "scan"
    with pltpu.force_tpu_interpret_mode():
        dec_j = JaxDecoder(V, NI, NH, NZ, dropout_in=0.0, dropout_out=0.0, backend=backend)
        params = jax.device_get(dec_j.init(jax.random.PRNGKey(1)))
        want = np.asarray(dec_j.reconstruct_error(_jnp(params), jnp.asarray(tokens), jnp.asarray(mask),
                                                  jnp.asarray(z)))
    dec = LSTMDecoder(V, NI, NH, NZ, kernel_route=kernel_route)
    assert dec.iw_chunk == dec_j.iw_chunk == (20 if kernel_route else 10)
    dec.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got = dec.reconstruct_error(torch.from_numpy(tokens).long(), torch.from_numpy(mask),
                                    torch.from_numpy(z))
    assert got.shape == (B, K)
    np.testing.assert_allclose(got.numpy(), want, atol=REC_ATOL, rtol=0)
    np.testing.assert_allclose(dec.log_probability(
        torch.from_numpy(tokens).long(), torch.from_numpy(mask),
        torch.from_numpy(z)).detach().numpy(), -got.numpy())


def test_decoder_decode_logits_match_jax():
    """Teacher-forced logits [B, K, T, V] on the scan route (z-major rows)."""
    tokens, mask, z = _batch(3)
    dec_j = JaxDecoder(V, NI, NH, NZ, dropout_in=0.0, dropout_out=0.0)
    params = jax.device_get(dec_j.init(jax.random.PRNGKey(2)))
    want = np.asarray(dec_j.decode(_jnp(params), jnp.asarray(tokens), jnp.asarray(z[:, :3])))
    dec = LSTMDecoder(V, NI, NH, NZ)
    dec.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got = dec.decode(torch.from_numpy(tokens).long(), torch.from_numpy(z[:, :3]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_kernel_route_gradient_runs_on_cpu():
    """On the CPU the kernel route's gradient runs ``LSTMSeqFn`` with its
    plain forward and backward (the CUDA route is tested in
    test_torch_port_cuda.py)."""
    tokens, mask, _ = _batch(4)
    enc = GaussianLSTMEncoder(V, NI, NH, NZ, kernel_route=True)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    mu, lv = enc(torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    (mu.sum() + lv.sum()).backward()
    assert enc.lstm.wh.grad is not None and torch.isfinite(enc.lstm.wh.grad).all()
