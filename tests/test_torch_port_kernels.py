"""The port's LSTM and fused-CE functions against the JAX package.

- ``lstm_run`` (vae_lagging_encoder_tpu_torch/models/lstm_core.py) on its
  kernel route against the JAX ``lstm_run`` on its Pallas route, the
  Pallas kernels run in interpret mode (as tests/test_pallas.py runs
  them): ``_fwd_kernel`` at B 8 and ``_infer_kernel`` at B 136 with
  ``inference=True``; H 128 and H 512 (the widest LSTM that keeps ``wh``
  in f32) in f32, and H 640, where both packages drop ``wh`` to bf16. On its scan route against the JAX scan route.
- ``ce_logp_plain`` against ``fused_ce_logp(..., interpret=True)`` with f32
  and bf16 operands, at an odd vocabulary and a row count that the TPU
  kernel pads.

The CUDA kernels themselves are checked in test_torch_port_cuda.py.
Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vae_lagging_encoder_tpu.models.lstm_core import lstm_run as jax_lstm_run
from vae_lagging_encoder_tpu.ops.ce_pallas import fused_ce_logp
from vae_lagging_encoder_tpu_torch.models.lstm_core import LSTMParams, lstm_run
from vae_lagging_encoder_tpu_torch.ops import build, ce_cuda, lstm_cuda
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

# f32: both sides run the same f32 recurrence; only the order of the f32
# sums differs (the JAX package's own kernel-vs-scan bound, test_pallas.py).
LSTM_ATOL_F32 = 2e-5
# bf16 wh (H > 512): both round h_{t-1} to bf16 before the product; a
# last-bit difference in h can flip one rounding, a ~4e-3 relative step on
# one input of a 640-long dot whose terms are ~1e-2: ~1e-4 at worst.
LSTM_ATOL_BF16 = 1e-4
CE_ATOL_F32 = 1e-5
# bf16 operands: identical rounded inputs, exact products, f32 sums in
# another order over nh 128 and a 1100-long logsumexp
CE_ATOL_BF16 = 2e-5


def _lstm_inputs(seed, B, T, ni, H, masked):
    rng = np.random.RandomState(seed)
    params = {"wx": rng.uniform(-0.1, 0.1, (ni, 4 * H)).astype(np.float32),
              "wh": rng.uniform(-0.08, 0.08, (H, 4 * H)).astype(np.float32),
              "b_ih": rng.uniform(-0.1, 0.1, (4 * H,)).astype(np.float32),
              "b_hh": rng.uniform(-0.1, 0.1, (4 * H,)).astype(np.float32)}
    x = rng.randn(B, T, ni).astype(np.float32)
    if masked:
        lens = rng.randint(3, T + 1, size=B)
        mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    else:
        mask = np.ones((B, T), np.float32)
    h0 = (0.1 * rng.randn(B, H)).astype(np.float32)
    c0 = (0.1 * rng.randn(B, H)).astype(np.float32)
    return params, x, mask, h0, c0


def _port_lstm(params, x, mask, h0, c0, kernel_route):
    p = LSTMParams(x.shape[-1], params["wh"].shape[0])
    p.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        out, (hT, cT) = lstm_run(p, torch.from_numpy(x), torch.from_numpy(mask),
                                 torch.from_numpy(h0), torch.from_numpy(c0),
                                 kernel_route=kernel_route)
    return out.numpy(), hT.numpy(), cT.numpy()


def _assert_lstm_close(got, want, mask, atol):
    out, hT, cT = got
    w_out, w_hT, w_cT = (np.asarray(a) for a in want)
    np.testing.assert_allclose(hT, w_hT, atol=atol, rtol=0)
    np.testing.assert_allclose(cT, w_cT, atol=atol, rtol=0)
    m = mask[..., None]  # pad positions: kept state here, raw output on JAX scan
    np.testing.assert_allclose(out * m, w_out * m, atol=atol, rtol=0)


@pytest.mark.parametrize("B,H,masked,inference", [
    (8, 128, False, False),    # JAX: _fwd_kernel
    (8, 128, True, False),     # JAX: _fwd_kernel, masked carry
    (136, 128, True, True),    # JAX: _infer_kernel (B > 128, inference)
    (8, 512, True, False),     # JAX: _fwd_kernel, the widest f32 wh (the H 512 path)
    (8, 640, True, False),     # JAX: _fwd_kernel with bf16 wh (H > 512)
])
def test_lstm_run_kernel_route_matches_jax_pallas(B, H, masked, inference):
    params, x, mask, h0, c0 = _lstm_inputs(B + H, B, 10, 24, H, masked)
    with pltpu.force_tpu_interpret_mode():
        want = jax_lstm_run(params, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(h0),
                            jnp.asarray(c0), backend="pallas", inference=inference)
        want = jax.device_get(want)
    got = _port_lstm(params, x, mask, h0, c0, kernel_route=True)
    _assert_lstm_close(got, (want[0], *want[1]), mask,
                       LSTM_ATOL_BF16 if H > 512 else LSTM_ATOL_F32)


@pytest.mark.parametrize("masked", [False, True])
def test_lstm_run_scan_route_matches_jax_scan(masked):
    params, x, mask, h0, c0 = _lstm_inputs(5, 8, 12, 24, 128, masked)
    want = jax.device_get(jax_lstm_run(params, jnp.asarray(x), jnp.asarray(mask),
                                       jnp.asarray(h0), jnp.asarray(c0), backend="scan"))
    got = _port_lstm(params, x, mask, h0, c0, kernel_route=False)
    _assert_lstm_close(got, (want[0], *want[1]), mask, LSTM_ATOL_F32)


def _ce_inputs(n=100, nh=128, vocab=1100, seed=0):
    rng = np.random.RandomState(seed)
    h = (rng.randn(n, nh) * 0.4).astype(np.float32)
    w = (rng.randn(nh, vocab) * 0.05).astype(np.float32)
    tgt = rng.randint(0, vocab, n).astype(np.int32)
    return h, w, tgt


@pytest.mark.parametrize("bf16", [False, True])
def test_ce_logp_plain_matches_jax_fused_ce(bf16):
    h, w, tgt = _ce_inputs()  # n 100 is padded to the TPU kernel's row block
    want = np.asarray(fused_ce_logp(jnp.asarray(h), jnp.asarray(w), jnp.asarray(tgt),
                                    mxu_dtype=jnp.bfloat16 if bf16 else None,
                                    interpret=True))
    dt = torch.bfloat16 if bf16 else None
    th, tw, tt = torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(tgt)
    logp, lse = ce_cuda.ce_logp_plain(th, tw, tt, dt)
    np.testing.assert_allclose(logp.numpy(), want, atol=CE_ATOL_BF16 if bf16 else CE_ATOL_F32,
                               rtol=0)
    # lse is the row logsumexp of the same logits
    hq, wq = (a.to(dt).float() if bf16 else a for a in (th, tw))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(hq @ wq, -1).numpy(), atol=1e-5)
    # a CPU tensor goes to the plain version, with no launch
    before = dict(build.LAUNCHES)
    routed = ce_cuda.ce_forward(th, tw, tt, dt)
    assert torch.equal(routed[0], logp) and build.LAUNCHES == before


def test_lstm_seq_cpu_routes_to_plain_without_launch():
    params, x, mask, h0, c0 = _lstm_inputs(1, 3, 5, 8, 16, True)
    xw = torch.randn(5, 3, 64)
    m = torch.from_numpy(mask.T.copy())
    wh = torch.from_numpy(params["wh"])
    before = dict(build.LAUNCHES)
    for res in (False, True):
        got = lstm_cuda.lstm_seq(xw, m, wh, torch.from_numpy(h0), torch.from_numpy(c0), res)
        ref = lstm_cuda.lstm_seq_plain(xw, m, wh, torch.from_numpy(h0), torch.from_numpy(c0), res)
        assert len(got) == (5 if res else 3)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert build.LAUNCHES == before
