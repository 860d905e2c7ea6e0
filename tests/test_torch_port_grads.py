"""The port's gradient paths against the JAX package's Pallas kernels.

- ``lstm_bwd_plain`` (the plain version of ``csrc/lstm_bwd.cu``) against
  ``ops/lstm_pallas.py::_bwd_call`` (da, dh0, dc0) on the residuals of the
  JAX forward kernel, and ``LSTMSeqFn``'s gradients (dxw, dwh, dh0, dc0)
  against ``jax.grad`` of ``lstm_seq_fused``: masked and unmasked, f32 and
  bf16 ``wh``, at B 8, T 12, H 128.
- The plain grad-mode CE (``ce_logp_plain(..., save_logits=True)``: logp,
  the logsumexp of the rounded logits, the spilled logits) against
  ``_ce_forward(..., save_logits=True)``, and ``FusedCEFn``'s dh and dW
  against ``jax.grad`` of ``fused_ce_logp``: f32 and bf16 operands, a
  ragged vocabulary (1100 against the TPU kernel's 1024-wide tiles) and a
  row count the TPU kernel pads (100).

The Pallas kernels run in interpret mode, as tests/test_pallas.py runs
them. Inputs are made with numpy from a seed and handed to both packages.
On the CPU the port's wrappers run these plain versions; the CUDA kernels
are held against them in test_torch_port_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vae_lagging_encoder_tpu.ops.ce_pallas import _ce_forward, fused_ce_logp
from vae_lagging_encoder_tpu.ops.lstm_pallas import _bwd_call, _fwd_call, lstm_seq_fused
from vae_lagging_encoder_tpu_torch.ops import build, ce_cuda, lstm_cuda

B, T, H = 8, 12, 128
# LSTM grads: tests/test_pallas.py:92 (kernel against scan, f32)
LSTM_ATOL, LSTM_RTOL = 3e-4, 1e-3
# CE grads: tests/test_pallas.py:158-161
CE_DH = dict(atol=1e-5, rtol=1e-4)
CE_DW = dict(atol=1e-4, rtol=1e-4)
# CE forward values: f32 sums in another order over nh 128 and a 1100-long
# logsumexp (test_torch_port_kernels.py)
CE_ATOL = 2e-5
BF16_STEP = 2.0 ** -7  # the largest relative spacing of bf16 values


def _assert_within_bf16_step(got, want, atol=0.0):
    """Two roundings to bf16 of f32 values that differ in their last bits
    (summation order) may land one bf16 step apart."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_less(np.abs(got - want), BF16_STEP * np.abs(want) + atol + 1e-30)


def _lstm_inputs(seed, masked):
    rng = np.random.RandomState(seed)
    xw = (rng.randn(T, B, 4 * H) * 0.3).astype(np.float32)
    wh = rng.uniform(-0.08, 0.08, (H, 4 * H)).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.1).astype(np.float32)
    c0 = (rng.randn(B, H) * 0.1).astype(np.float32)
    if masked:
        lens = rng.randint(3, T + 1, size=B)
        mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    else:
        mask = np.ones((T, B), np.float32)
    dhs = (rng.randn(T, B, H) * 0.1).astype(np.float32)
    dhT = (rng.randn(B, H) * 0.1).astype(np.float32)
    dcT = (rng.randn(B, H) * 0.1).astype(np.float32)
    return xw, mask, wh, h0, c0, dhs, dhT, dcT


def _jdt(wh_dtype):
    return jnp.bfloat16 if wh_dtype == "bfloat16" else jnp.float32


def _tdt(wh_dtype):
    return torch.bfloat16 if wh_dtype == "bfloat16" else torch.float32


@pytest.mark.parametrize("wh_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_lstm_bwd_plain_matches_jax_bwd_kernel(masked, wh_dtype):
    xw, mask, wh, h0, c0, dhs, dhT, dcT = _lstm_inputs(1, masked)
    whj = jnp.asarray(wh).astype(_jdt(wh_dtype))
    with pltpu.force_tpu_interpret_mode():
        _, cs, gates, _, _ = _fwd_call(jnp.asarray(xw), jnp.asarray(mask), whj,
                                       jnp.asarray(h0), jnp.asarray(c0))
        c_prev = jnp.concatenate([jnp.asarray(c0)[None], cs[:-1]], axis=0)
        want = jax.device_get(_bwd_call(gates, jnp.asarray(mask), whj, c_prev,
                                        jnp.asarray(dhs), jnp.asarray(dhT), jnp.asarray(dcT)))
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    before = dict(build.LAUNCHES)
    got = lstm_cuda.lstm_bwd(t(gates), t(mask), t(wh).to(_tdt(wh_dtype)), t(c_prev), t(dhs),
                             t(dhT), t(dcT))
    assert build.LAUNCHES == before  # a CPU tensor runs the plain version
    for g, w, name in zip(got, want, ("da", "dh0", "dc0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LSTM_ATOL, rtol=LSTM_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("wh_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_lstm_seq_fn_grads_match_jax_grad(masked, wh_dtype):
    xw, mask, wh, h0, c0, _, _, _ = _lstm_inputs(2, masked)
    rng = np.random.RandomState(3)
    tgt_hs = (rng.randn(T, B, H) * 0.1).astype(np.float32)
    tgt_h = (rng.randn(B, H) * 0.1).astype(np.float32)

    def loss_jax(xw, wh, h0, c0):
        hs, hT, cT = lstm_seq_fused(xw, jnp.asarray(mask), wh.astype(_jdt(wh_dtype)), h0, c0)
        return jnp.sum(hs * tgt_hs) + jnp.sum(hT * tgt_h) + 0.5 * jnp.sum(cT * tgt_h)

    with pltpu.force_tpu_interpret_mode():
        want = jax.device_get(jax.grad(loss_jax, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (xw, wh, h0, c0))))

    args = [torch.from_numpy(a).requires_grad_() for a in (xw, wh, h0, c0)]
    hs, hT, cT = lstm_cuda.LSTMSeqFn.apply(args[0], torch.from_numpy(mask),
                                           args[1].to(_tdt(wh_dtype)), args[2], args[3])
    (torch.sum(hs * torch.from_numpy(tgt_hs)) + torch.sum(hT * torch.from_numpy(tgt_h))
     + 0.5 * torch.sum(cT * torch.from_numpy(tgt_h))).backward()
    for a, w, name in zip(args, want, ("dxw", "dwh", "dh0", "dc0")):
        if name == "dwh" and wh_dtype == "bfloat16":
            # returned in bf16 on both sides: the same f32 product rounded
            _assert_within_bf16_step(a.grad.numpy(), w, atol=LSTM_ATOL)
        else:
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=LSTM_ATOL,
                                       rtol=LSTM_RTOL, err_msg=name)


def _ce_inputs(n=100, nh=128, vocab=1100, seed=0):
    rng = np.random.RandomState(seed)
    h = (rng.randn(n, nh) * 0.4).astype(np.float32)
    w = (rng.randn(nh, vocab) * 0.05).astype(np.float32)
    tgt = rng.randint(0, vocab, n).astype(np.int32)
    row_mask = (rng.rand(n) > 0.3).astype(np.float32)
    return h, w, tgt, row_mask


@pytest.mark.parametrize("bf16", [False, True])
def test_ce_plain_grad_mode_matches_jax_ce_forward(bf16):
    h, w, tgt, _ = _ce_inputs(n=96)  # _ce_forward takes whole row blocks
    logp_j, lse_j, spill_j = jax.device_get(_ce_forward(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(tgt), block_n=32, block_v=1024,
        mxu_dtype=jnp.bfloat16 if bf16 else None, interpret=True, save_logits=True))
    dt = torch.bfloat16 if bf16 else None
    logp, lse, spill = ce_cuda.ce_forward(torch.from_numpy(h), torch.from_numpy(w),
                                          torch.from_numpy(tgt), dt, save_logits=True)
    assert spill.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert spill.shape == (96, 1100) and spill_j.shape == (96, 2048)  # JAX pads to its tile
    np.testing.assert_allclose(logp.numpy(), logp_j, atol=CE_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=CE_ATOL, rtol=0)
    spill_j = np.asarray(spill_j[:, :1100], np.float32)
    if bf16:
        # plus the f32 summation-order difference itself at logits near 0
        _assert_within_bf16_step(spill.float().numpy(), spill_j, atol=1e-5)
        # the residual lse is the rounded logits' own (s2), not the exact one
        exact = torch.logsumexp(torch.from_numpy(h).bfloat16().float()
                                @ torch.from_numpy(w).bfloat16().float(), -1)
        assert float((lse - exact).abs().max()) > 0
    else:
        np.testing.assert_allclose(spill.numpy(), spill_j, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_ce_fn_grads_match_jax_grad(bf16):
    h, w, tgt, row_mask = _ce_inputs()
    mxu = jnp.bfloat16 if bf16 else None

    def loss_jax(h, w):
        return -jnp.sum(fused_ce_logp(h, w, jnp.asarray(tgt), mxu_dtype=mxu, interpret=True)
                        * row_mask)

    want = jax.device_get(jax.grad(loss_jax, (0, 1))(jnp.asarray(h), jnp.asarray(w)))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    logp = ce_cuda.FusedCEFn.apply(th, tw, torch.from_numpy(tgt),
                                   torch.bfloat16 if bf16 else None)
    (-(logp * torch.from_numpy(row_mask)).sum()).backward()
    np.testing.assert_allclose(th.grad.numpy(), want[0], err_msg="dh", **CE_DH)
    np.testing.assert_allclose(tw.grad.numpy(), want[1], err_msg="dw", **CE_DW)
