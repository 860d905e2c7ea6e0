"""The plain references against the port's CPU path (its kernels' plain
versions) at tiny widths, on the same weights, batches and noise.

Run: ``python -m pytest port_bench/tests -q`` from the repository's root.
The references import nothing of the port; these tests import both.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from port_bench import inputs, models
from port_bench.reference import text_vae
from port_bench.reference.numerics import Products

TEXT = {"ni": 16, "enc_nh": 32, "dec_nh": 32, "nz": 4, "vocab_size": 1030, "batch_size": 4,
        "dec_dropout_in": 0.5, "dec_dropout_out": 0.5, "length_mean": 9, "length_std": 3,
        "length_min": 3, "length_max": 20, "zipf_a": 1.3, "train_sentences": 12,
        "length_buckets": [16, 32], "dataset": "yahoo", "model": "text_vae", "nsamples": 1,
        "init": {"emb": 1.0, "wx": 0.2, "wh": 0.2, "b_ih": 0.1, "b_hh": 0.1, "linear": 0.2,
                 "trans": 0.3, "pred": 0.3}}


def _text(nh: int):
    """A text model with LSTMs ``nh`` wide: above 512 the port takes the
    recurrent product in bf16, at or below in f32."""
    c = dict(TEXT, enc_nh=nh, dec_nh=nh,
             precision={"lstm_recurrent": "bfloat16" if nh > 512 else "float32"})
    m = models.model_for(c, {})
    cfg = models.port_config(c, {})
    w = m.weights(3, torch.device("cpu"), c["init"])
    vae = m.build(cfg, w, torch.device("cpu"))
    batch = m.ref_batch(m.batches("train", 3, 4)[0][1][0], "cpu")
    return c, m, cfg, w, vae, batch


def _grads(vae):
    return {k: p.grad.clone() for k, p in vae.named_parameters()}


@pytest.mark.parametrize("nh", [32, 520])
def test_text_training_step_matches_the_port(nh):
    from vae_lagging_encoder_tpu_torch.train.epoch import make_loss_fn

    c, m, cfg, w, vae, batch = _text(nh)
    B, T = batch[0].shape
    g = torch.Generator().manual_seed(5)
    noise = {"eps": torch.randn(B, 1, c["nz"], generator=g),
             "keep_in": torch.rand(B, T - 1, c["ni"], generator=g),
             "keep_out": torch.rand(B, T - 1, nh, generator=g)}
    mean, _ = make_loss_fn(vae, 1, train=True)(batch, lambda s, shape: noise[s], 0.3)
    mean.backward()
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    ref, _ = text_vae.train_loss(leaves, c, batch, noise, 0.3, models.products(c))
    grads = dict(zip(leaves, torch.autograd.grad(ref, list(leaves.values()))))
    assert float(mean.detach()) == pytest.approx(float(ref.detach()), rel=1e-6)
    for k, pg in _grads(vae).items():
        scale = float(grads[k].abs().max()) + 1e-30
        assert float((pg - grads[k]).abs().max()) / scale < 1e-4, k


def test_text_iwnll_matches_the_port():
    c, m, cfg, w, vae, batch = _text(32)
    tokens, mask, _ = batch
    g = torch.Generator().manual_seed(6)
    eps = [torch.randn(tokens.shape[0], 10, c["nz"], generator=g) for _ in range(3)]
    with torch.no_grad():
        port = vae.nll_iw(tokens, mask, 30, 10, noise=lambda j, shape: eps[j])
    ref = text_vae.nll_iw(w, tokens, mask, eps, models.products(c), rows=8)
    torch.testing.assert_close(port, ref, rtol=1e-6, atol=1e-4)


def test_the_control_moves_every_product_one_step_down():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, 3.0e-3])
    low = Products(control=True)
    assert low.rnd(x)[0] == 1.0 and low.rnd(x)[1] == x[1]  # TF32: 10 significand bits
    assert Products().rnd(x) is x
    y = torch.linspace(-2.0, 2.0, 101)
    e_bf16 = float((Products().low(y) - y).abs().max())
    e_fp8 = float((low.low(y) - y).abs().max())
    assert 0 < e_bf16 < e_fp8 <= 2.0 * 2 ** -4  # fp8 e4m3: 3 significand bits, scaled


def test_the_recurrent_product_follows_the_configuration():
    assert Products(recurrent="bfloat16").rec(torch.tensor([1.0 + 2 ** -10]))[0] == 1.0
    x = torch.tensor([1.0 + 2 ** -10])
    assert Products(recurrent="float32").rec(x)[0] == x[0]


def test_quantile_lengths_are_the_same_for_every_seed():
    a = inputs.text_batches(TEXT, 40, 4, seed=1, stream=0)
    b = inputs.text_batches(TEXT, 40, 4, seed=2 ** 31 + 5, stream=0)
    assert [(L, len(bs)) for L, bs in a] == [(L, len(bs)) for L, bs in b]
    la = sorted(int(m.sum()) for _, bs in a for _, mm, _ in bs for m in mm if m.sum())
    lb = sorted(int(m.sum()) for _, bs in b for _, mm, _ in bs for m in mm if m.sum())
    assert la == lb
    assert not np.array_equal(a[-1][1][0][0], b[-1][1][0][0])  # the words are the seed's
    lens = inputs.quantile_lengths(10000, 80, 25, 20, 160)
    assert abs(lens.mean() - 80) < 1 and lens.min() == 20 and lens.max() == 160
    assert math.isclose(np.median(lens), 80, abs_tol=1)
