"""The port's image modules against the JAX package's, on the JAX package's
weights (``from_jax_params``) and noise, at small widths.

- ``ops/conv.py``: ``conv2d`` at strides 1 and 2 on 28x28 and 13x13 (every
  ``SAME`` pad case: (0, 1), (1, 1) and symmetric), ``causal_mask``,
  ``masked_conv2d``;
- ``ResNetEncoderV2``'s (mu, logvar); ``PixelCNNDecoderV2``'s ``_logits``,
  ``decode`` and ``reconstruct_error`` with K <= ``iw_chunk`` and K above
  it (zero-padded chunks); the autoregressive property of the logits;
- ``VAE.loss``, ``nll_iw`` and ``calc_mi_q`` on JAX's eps; the bf16 mode
  against JAX's bf16;
- the data: ``load_omniglot`` on ``.npz`` and ``.pt`` payloads, the
  synthetic substitute (``_render_glyph`` on a few prototypes and the whole
  generator at a reduced size), ``ImagePool`` against ``image_batches``;
- parameter trees with lists: ``from_jax_params`` / ``to_jax_params``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_lagging_encoder_tpu.config import get_config as jax_get_config
from vae_lagging_encoder_tpu.data import ImagePool as JaxImagePool
from vae_lagging_encoder_tpu.data import omniglot as jax_og
from vae_lagging_encoder_tpu.models import build_image_vae as jax_build
from vae_lagging_encoder_tpu.ops import conv as jax_conv
from vae_lagging_encoder_tpu_torch.config import get_config
from vae_lagging_encoder_tpu_torch.data import ImagePool
from vae_lagging_encoder_tpu_torch.data import omniglot as og
from vae_lagging_encoder_tpu_torch.models import build_image_vae
from vae_lagging_encoder_tpu_torch.ops import conv
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params, to_jax_params

SMALL = dict(nz=4, enc_layers=(8, 8), dec_layers=3, dec_filters=8, dec_kernel_size=7)
# f32 on both sides; only the order of the sums differs: conv outputs and
# (mu, logvar) of O(1) agree to ~1e-6, per-image BCE sums of ~100-500 nats
# to ~1e-6 relative. As tight as that order allows, and tighter than the
# JAX package's own torch replica (mu/logvar 1e-4, rec 5e-3, IW 1e-2:
# tests/test_torch_parity.py).
ATOL, RTOL = 1e-5, 1e-5
SUM_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(size=28, seed=0, scale=None, **kw):
    """The JAX model and params and the port's model with the same weights;
    ``scale`` redraws the encoder's weights U(-scale, scale) so that mu and
    logvar depend on x (at the init scale they are ~1e-4)."""
    over = dict(SMALL, img_size=(size, size, 1), **kw)
    jvae = jax_build(jax_get_config("omniglot", **over))
    params = jax.device_get(jvae.init(jax.random.PRNGKey(seed)))
    if scale:
        rng = np.random.RandomState(seed + 100)
        for blk in params["enc"]["blocks"]:
            for k in blk:
                blk[k] = rng.uniform(-scale, scale, blk[k].shape).astype(np.float32)
        params["enc"]["fc"] = rng.uniform(-scale, scale, params["enc"]["fc"].shape
                                          ).astype(np.float32)
    vae = build_image_vae(get_config("omniglot", **over), device="cpu")
    vae.load_state_dict(from_jax_params(params))
    return jvae, jax.tree.map(jnp.asarray, params), vae, params


def _images(n, size, seed):
    return (np.random.RandomState(seed).rand(n, size, size, 1) > 0.6).astype(np.float32)


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("size,stride,k", [(28, 1, 3), (28, 2, 3), (14, 2, 3), (7, 2, 3),
                                           (13, 2, 3), (13, 1, 7), (28, 1, 1)])
def test_conv2d_matches_jax(size, stride, k):
    rng = np.random.RandomState(size + stride + k)
    x = rng.randn(3, size, size, 5).astype(np.float32)
    w = rng.randn(k, k, 5, 6).astype(np.float32)
    want = np.asarray(jax_conv.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride))
    got = conv.conv2d(_t(x), _t(w), stride=stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_same_pads_cases():
    assert conv.same_pads(28, 3, 2) == (0, 1)
    assert conv.same_pads(14, 3, 2) == (0, 1)
    assert conv.same_pads(7, 3, 2) == (1, 1)
    assert conv.same_pads(13, 7, 1) == (3, 3)


@pytest.mark.parametrize("k,center", [(7, False), (3, True), (5, False), (1, True)])
def test_causal_mask_and_masked_conv_match_jax(k, center):
    np.testing.assert_array_equal(conv.causal_mask(k, k, 2, 3, center).numpy(),
                                  np.asarray(jax_conv.causal_mask(k, k, 2, 3, center)))
    rng = np.random.RandomState(k)
    x = rng.randn(2, 13, 13, 2).astype(np.float32)
    w = rng.randn(k, k, 2, 3).astype(np.float32)
    want = np.asarray(jax_conv.masked_conv2d(jnp.asarray(x), jnp.asarray(w), center))
    np.testing.assert_allclose(conv.masked_conv2d(_t(x), _t(w), center).numpy(), want,
                               atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("size", [28, 13])
def test_encoder_matches_jax(size):
    jvae, pj, vae, _ = _models(size, scale=0.3)
    x = _images(6, size, 1)
    mu_j, lv_j = jvae.encoder.forward(pj["enc"], jnp.asarray(x))
    with torch.no_grad():
        mu, lv = vae.enc(_t(x))
    assert float(np.abs(np.asarray(mu_j)).max()) > 0.1  # the check sees real values
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("size", [28, 13])
def test_decoder_logits_and_decode_match_jax(size):
    jvae, pj, vae, _ = _models(size, seed=1)
    rng = np.random.RandomState(2)
    x = _images(4, size, 3)
    z = rng.randn(4, 3, SMALL["nz"]).astype(np.float32)
    want = np.asarray(jvae.decoder._logits(pj["dec"], jnp.asarray(x), jnp.asarray(z[:, 0])))
    want_dec = np.asarray(jvae.decoder.decode(pj["dec"], jnp.asarray(x), jnp.asarray(z)))
    with torch.no_grad():
        got = vae.dec._logits(_t(x), _t(z[:, 0])).numpy()
        got_dec = vae.dec.decode(_t(x), _t(z)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert got_dec.shape == want_dec.shape == (4, 3, size, size, 1)
    np.testing.assert_allclose(got_dec, want_dec, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("K", [7, 25, 60])
def test_reconstruct_error_matches_jax(K):
    """K <= iw_chunk (one pass), K > iw_chunk (chunks, 60 zero-padded to 75)."""
    jvae, pj, vae, _ = _models(seed=2)
    x = _images(3, 28, 4)
    z = np.random.RandomState(K).randn(3, K, SMALL["nz"]).astype(np.float32) * 2
    want = np.asarray(jvae.decoder.reconstruct_error(pj["dec"], jnp.asarray(x), None,
                                                     jnp.asarray(z)))
    with torch.no_grad():
        got = vae.dec.reconstruct_error(_t(x), None, _t(z)).numpy()
    assert got.shape == (3, K) and want.min() > 100  # per-image sums of 784 BCEs
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)
    # under autograd the chunks are recomputed in the backward: same values
    zt = _t(z).requires_grad_()
    with torch.enable_grad():
        out = vae.dec.reconstruct_error(_t(x), None, zt)
        out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), got, rtol=1e-6)
    assert torch.isfinite(zt.grad).all() and zt.grad.abs().sum() > 0


@pytest.mark.parametrize("size,first_kernel", [(28, 7), (13, 5)])
def test_logits_are_autoregressive(size, first_kernel):
    """The logit at pixel p has zero gradient with respect to every input
    pixel at p or after it in raster order, and a nonzero one to some pixel
    before it."""
    _, _, vae, _ = _models(size, seed=3, dec_kernel_size=first_kernel)
    z = torch.from_numpy(np.random.RandomState(5).randn(1, SMALL["nz"]).astype(np.float32))
    rng = np.random.RandomState(6)
    for p in [1, size + 1, size * size // 2] + list(rng.randint(2, size * size, 6)):
        x = _t(_images(1, size, 7)).requires_grad_()
        i, j = divmod(int(p), size)
        vae.dec._logits(x, z)[0, i, j, 0].backward()
        g = x.grad[0, :, :, 0].reshape(-1)
        assert (g[p:] == 0).all(), p
        assert g[:p].abs().sum() > 0, p


# ---------------------------------------------------------------- the VAE
def test_vae_estimators_match_jax():
    """``loss`` (eps [B, 2, nz]), ``nll_iw`` (40 samples in chunks of 20),
    ``calc_mi_q`` with a pad row, on JAX's draws."""
    jvae, pj, vae, _ = _models(seed=4, scale=0.3)
    x = _images(5, 28, 8)
    xj, xt = jnp.asarray(x), _t(x)
    rw = np.ones(5, np.float32)
    rw[-1] = 0.0
    key = jax.random.PRNGKey(9)
    loss_j, rec_j, kl_j = jvae.loss(pj, key, xj, None, jnp.asarray(rw), kl_weight=0.6,
                                    nsamples=2, train=False)
    eps = _t(jax.random.normal(jax.random.split(key)[0], (5, 2, SMALL["nz"])))
    nll_j = jvae.nll_iw(pj, key, xj, None, nsamples=40, ns=20)
    mi_j = jvae.calc_mi_q(pj, key, xj, None, jnp.asarray(rw))
    with torch.no_grad():
        loss, rec, kl = vae.loss(xt, None, _t(rw), kl_weight=0.6, nsamples=2, eps=eps)
        nll = vae.nll_iw(xt, None, 40, 20, noise=lambda j, shape: _t(
            jax.random.normal(jax.random.fold_in(key, j), shape)))
        mi = vae.calc_mi_q(xt, None, _t(rw), _t(jax.random.normal(key, (5, 1, SMALL["nz"]))))
    assert float(np.asarray(kl_j)[:4].min()) > 0.1  # x-dependent posteriors
    for got, want in ((loss, loss_j), (rec, rec_j), (kl, kl_j), (nll, nll_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SUM_RTOL, atol=ATOL)
    np.testing.assert_allclose(float(mi), float(mi_j), rtol=1e-4, atol=1e-4)


def test_bf16_mode_matches_jax_bf16():
    """compute_dtype bfloat16 on both sides (the same casts: bf16 convs,
    bias/conditioning/ELU in f32, f32 fc and output conv). Both round the
    same values to bf16; a rounding one side flips moves a per-image sum of
    ~500 nats by a few 1e-3 relative at most, the JAX package's own bound
    for bf16 against f32 (rtol 2e-3, tests/test_image.py)."""
    jvae, pj, vae, _ = _models(seed=5, compute_dtype="bfloat16", scale=0.3)
    assert vae.dec.compute_dtype == torch.bfloat16
    x = _images(4, 28, 9)
    key = jax.random.PRNGKey(3)
    loss_j, _, _ = jvae.loss(pj, key, jnp.asarray(x), None, kl_weight=1.0, train=False)
    eps = _t(jax.random.normal(jax.random.split(key)[0], (4, 1, SMALL["nz"])))
    with torch.no_grad():
        loss, _, _ = vae.loss(_t(x), None, kl_weight=1.0, eps=eps)
        loss_f32 = build_image_vae(get_config("omniglot", **SMALL), device="cpu")
        loss_f32.load_state_dict(vae.state_dict())
        l32, _, _ = loss_f32.loss(_t(x), None, kl_weight=1.0, eps=eps)
    assert torch.isfinite(loss).all() and not torch.equal(loss, l32)  # bf16 really ran
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=2e-3)


# ------------------------------------------------------------------ data
def _splits(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.rand(n, 28, 28, 1).astype(np.float32)
            for k, n in (("train", 40), ("val", 12), ("test", 16))}


def test_load_omniglot_npz_and_pt_match_jax(tmp_path):
    arrs = _splits(5)
    np.savez(tmp_path / "o.npz", **arrs)
    torch.save({k: torch.from_numpy(np.transpose(v, (0, 3, 1, 2))) for k, v in arrs.items()},
               tmp_path / "o.pt")  # NCHW tensors, as the reference's file
    torch.save((torch.from_numpy(arrs["train"].reshape(40, 784) * 255),),
               tmp_path / "flat.pt")  # a bare tuple of [N, 784] bytes-scaled rows
    for name in ("o.npz", "o.pt", "flat.pt"):
        got = og.load_omniglot(str(tmp_path / name), allow_synthetic=False)
        want = jax_og.load_omniglot(str(tmp_path / name), allow_synthetic=False)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        og.load_omniglot(str(tmp_path / "missing.pt"), allow_synthetic=False)


def test_synthetic_substitute_matches_jax(tmp_path, monkeypatch):
    ys, xs = np.mgrid[0:28, 0:28].astype(np.float32)
    protos = np.random.RandomState(1).uniform(3, 20, size=(4, 3, 5))
    for p in protos:
        np.testing.assert_array_equal(og._render_glyph(p, np.random.RandomState(2), ys, xs),
                                      jax_og._render_glyph(p, np.random.RandomState(2), ys, xs))
    sizes = {"train": 30, "val": 6, "test": 6}
    for mod in (og, jax_og):
        monkeypatch.setattr(mod, "_SYNTH_SIZES", sizes)
        monkeypatch.setattr(mod, "_SYNTH_CACHE", {})
    got, want = og._synthetic_omniglot(7), jax_og._synthetic_omniglot(7)
    for k in sizes:
        assert got[k].shape == (sizes[k], 28, 28, 1)
        np.testing.assert_array_equal(got[k], want[k])
    # the seed-stamped file: each package reads the other's; a missing path warns
    path = og.ensure_omniglot_dataset(str(tmp_path), seed=7)
    assert jax_og.ensure_omniglot_dataset(str(tmp_path), seed=7) == path
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        splits = og.load_omniglot(str(tmp_path / "omniglot.pt"), seed=7)
    for a, k in zip(splits, ("train", "val", "test")):
        np.testing.assert_array_equal(a, want[k])


@pytest.mark.parametrize("n,bs", [(20, 8), (16, 8)])
def test_image_pool_matches_jax(n, bs):
    imgs = _splits(3)["train"][:n]
    jpool = JaxImagePool(imgs, bs)
    pool = ImagePool(imgs, bs, "cpu")
    stacked, w = jax_og.image_batches(imgs, bs)
    assert pool.num_batches == jpool.num_batches == len(stacked) == -(-n // bs)
    for i, (probs, rw) in enumerate(pool):
        np.testing.assert_array_equal(probs.numpy(), stacked[i])
        np.testing.assert_array_equal(rw.numpy(), w[i])
    for s in range(6):
        key = jax.random.PRNGKey(s)
        flat = int(jax.random.randint(key, (), 0, jpool.num_batches))
        b, i = (int(v) for v in jpool.sample_coords(key))
        assert pool.coords(flat) == (b, i)
        for got, want in zip(pool.batch(flat), jpool.arrays[b]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[i]))


# ---------------------------------------------------------------- params
def test_image_params_round_trip_with_lists():
    _, _, vae, params = _models(seed=6)
    back = to_jax_params(vae.state_dict())
    assert isinstance(back["enc"]["blocks"], list) and isinstance(back["dec"]["layers"], list)
    assert len(back["enc"]["blocks"]) == 2 and len(back["dec"]["layers"]) == 3
    flat = lambda t: {k: v.numpy() for k, v in from_jax_params(t).items()}
    want, got = flat(params), flat(back)
    assert got.keys() == want.keys() and "enc.blocks.1.conv2" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
