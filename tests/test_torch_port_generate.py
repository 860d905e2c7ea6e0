"""The port's generation against the JAX package's, on the JAX package's
weights (``from_jax_params``) and its own draws, at small widths.

- ``lstm_cell`` in f32 and bf16; ``Vocab.decode``;
- greedy and sample decode, token for token, on models whose ``pred`` is
  scaled up so that the margins between tokens are large (JAX's Gumbel
  draws from its split chain handed to the port);
- ``_topk_small`` against JAX's and ``lax.top_k``: duplicates, many exact
  ties, an all -inf row;
- the batched and the host beam search against JAX's two backends over
  random vocabularies, beam widths and lengths, with the near-tie rule of
  ``tests/test_models.py::test_beam_device_matches_host``, and against the
  exhaustive tiny-vocabulary oracle;
- ``VAE.reconstruct`` for each strategy (one key for eps and the decoder's
  draws, as in the JAX package), ``sample_from_prior``'s shape and moments,
  ``calc_model_posterior_mean``;
- the PixelCNN samplers at 12x12 with 3 layers of 8 filters: the
  incremental sampler's logits against the dense ``_logits`` under
  ``force_image`` (f32 1e-5, bf16 0.05, as ``tests/test_image.py``), and
  both samplers against JAX's on JAX's uniforms;
- ``save_grid``'s PNG bytes against the JAX package's.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_lagging_encoder_tpu.cli import image as jax_cli_image
from vae_lagging_encoder_tpu.config import get_config as jax_get_config
from vae_lagging_encoder_tpu.data.vocab import Vocab as JaxVocab
from vae_lagging_encoder_tpu.models import VAE as JaxVAE
from vae_lagging_encoder_tpu.models import GaussianLSTMEncoder as JaxEncoder
from vae_lagging_encoder_tpu.models import LSTMDecoder as JaxDecoder
from vae_lagging_encoder_tpu.models import build_image_vae as jax_build_image
from vae_lagging_encoder_tpu.models import dec_lstm as jax_dec_lstm
from vae_lagging_encoder_tpu.models import lstm_core as jax_lstm_core
from vae_lagging_encoder_tpu_torch.cli import image as cli_image
from vae_lagging_encoder_tpu_torch.config import get_config
from vae_lagging_encoder_tpu_torch.data.vocab import BOS_ID, EOS_ID, PAD_ID, Vocab
from vae_lagging_encoder_tpu_torch.models import (VAE, GaussianLSTMEncoder, LSTMDecoder,
                                                  build_image_vae, dec_lstm, lstm_core)
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

V, NI, NH, NZ = 40, 8, 16, 3
# f32 on both sides, the order of the sums aside: a normalized beam score
# is a mean of ~10 log-probs of O(1-10) nats (test_models.py's bound)
RESCORE_TOL = 1e-4
IMAGE = dict(nz=3, enc_layers=(8, 8), dec_layers=3, dec_filters=8, dec_kernel_size=7,
             img_size=(12, 12, 1))


def _t(a):
    return torch.from_numpy(np.array(a))


def _decoders(v=V, seed=0, pred_scale=20.0, nz=NZ):
    """The JAX decoder and params and the port's decoder with the same
    weights; ``pred`` scaled so that the margins between tokens are large."""
    dec_j = JaxDecoder(v, NI, NH, nz, dropout_in=0.0, dropout_out=0.0)
    params = jax.device_get(dec_j.init(jax.random.PRNGKey(seed)))
    params["pred"] = params["pred"] * pred_scale
    dec = LSTMDecoder(v, NI, NH, nz, dropout_in=0.0, dropout_out=0.0)
    dec.load_state_dict(from_jax_params(params))
    return dec_j, jax.tree.map(jnp.asarray, params), dec


def _jax_gumbels(key, steps, shape):
    """The Gumbel draws of JAX's ``_generate_jit``: ``k, sub = split(k)``
    at each step, ``categorical(sub, .)`` = argmax(logits + gumbel(sub))."""
    out, k = [], key
    for _ in range(steps):
        k, sub = jax.random.split(k)
        out.append(_t(jax.random.gumbel(sub, shape, jnp.float32)))
    return lambda step, shp: out[step]


# ------------------------------------------------------------ cell, vocab
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_cell_matches_jax(dtype):
    rng = np.random.RandomState(0)
    h, c = rng.randn(5, 32).astype(np.float32), rng.randn(5, 32).astype(np.float32)
    xw, wh = rng.randn(5, 128).astype(np.float32), (rng.randn(32, 128) * 0.2).astype(np.float32)
    hj, cj = jax_lstm_core.lstm_cell(h, c, xw, wh, getattr(jnp, dtype))
    hp, cp = lstm_core.lstm_cell(_t(h), _t(c), _t(xw), _t(wh), getattr(torch, dtype))
    # the products of values rounded alike are exact in f32 on both sides;
    # only the order of the 32-long sums differs
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), atol=1e-6, rtol=0)


def test_vocab_decode_matches_jax():
    w2i = {"<pad>": 0, "<unk>": 1, "<s>": 2, "</s>": 3, "a": 4, "b": 5, "c": 6}
    ids = [2, 4, 1, 6, 5, 3, 0, 0]
    for strip in (True, False):
        assert Vocab(dict(w2i)).decode(ids, strip) == JaxVocab(dict(w2i)).decode(ids, strip)
    assert Vocab(dict(w2i)).decode(ids) == ["a", "c", "b"]


# ------------------------------------------------------ greedy and sample
@pytest.mark.parametrize("strategy", ["greedy", "sample"])
def test_greedy_and_sample_decode_match_jax(strategy):
    dec_j, pj, dec = _decoders(seed=1)
    z = np.random.RandomState(2).randn(6, NZ).astype(np.float32) * 2
    L = 12
    key = jax.random.PRNGKey(5)
    if strategy == "greedy":
        want = np.asarray(dec_j.greedy_decode(pj, jnp.asarray(z), max_len=L))
        got = dec.greedy_decode(_t(z), max_len=L)
    else:
        want = np.asarray(dec_j.sample_decode(pj, key, jnp.asarray(z), L))
        got = dec.sample_decode(_t(z), L, noise=_jax_gumbels(key, L, (6, V)))
    assert got.shape == (6, L) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)
    for row in got.numpy():  # PAD after the first EOS
        hits = np.where(row == EOS_ID)[0]
        if len(hits):
            assert (row[hits[0] + 1:] == PAD_ID).all()


def test_sample_decode_default_generator_is_seeded():
    _, _, dec = _decoders(seed=3, pred_scale=1.0)
    z = torch.randn(4, NZ, generator=torch.Generator().manual_seed(0))
    a = dec.sample_decode(z, 10, generator=torch.Generator().manual_seed(7))
    b = dec.sample_decode(z, 10, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.shape == (4, 10)


# ------------------------------------------------------------------ top-k
def test_topk_small_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(7, 3, 2000).astype(np.float32)
    x[0, 0, 100:110] = x[0, 0, 50]          # duplicates across positions
    x[1, 1, :] = -np.inf                    # dead-beam row
    x[2, 2, ::2] = 3.25                     # many exact ties
    x[3, 0, 1500:] = -np.inf                # a tail of -inf
    for k in (1, 5, 15):
        vj, ij = jax_dec_lstm._topk_small(jnp.asarray(x), k)
        vt, it = jax.lax.top_k(jnp.asarray(x), k)
        v, i = dec_lstm._topk_small(_t(x), k)
        for a, b in ((v, vj), (i, ij), (v, vt), (i, it)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), str(k))
    # JAX's short-axis branch is top_k itself
    vj, ij = jax_dec_lstm._topk_small(jnp.asarray(x[..., :512]), 2)
    v, i = dec_lstm._topk_small(_t(x[..., :512]), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vj))


# ------------------------------------------------------------------- beam
def _rescore(dec, z_row, seq):
    """Length-normalized total log-prob of ``seq`` (BOS..) under the port's
    teacher-forced decoder."""
    with torch.no_grad():
        logits = dec.decode(torch.tensor([seq[:-1]]), z_row[None, None])
    lp = torch.log_softmax(logits[0, 0].double(), -1)
    return sum(float(lp[t, seq[t + 1]]) for t in range(len(seq) - 1)) / len(seq)


@pytest.mark.parametrize("seed", range(6))
def test_beam_search_matches_jax(seed):
    rng = np.random.RandomState(seed)
    v = int(rng.choice([6, 11, 30]))
    w = int(rng.choice([1, 2, 3, 5, v]))
    L = int(rng.choice([4, 7, 12]))
    dec_j, pj, dec = _decoders(v=v, seed=seed, pred_scale=float(rng.choice([5.0, 20.0, 40.0])),
                               nz=2)
    z = rng.randn(5, 2).astype(np.float32) * 2
    jz, tz = jnp.asarray(z), _t(z)
    runs = {"jax_device": dec_j.beam_search_decode(pj, jz, w, L, backend="device"),
            "jax_host": dec_j.beam_search_decode(pj, jz, w, L, backend="host"),
            "device": dec.beam_search_decode(tz, w, L, backend="device"),
            "host": dec.beam_search_decode(tz, w, L, backend="host")}
    mismatched = 0
    for ours, theirs in (("device", "jax_device"), ("host", "jax_host"), ("device", "host")):
        for n, (a, b) in enumerate(zip(runs[ours], runs[theirs])):
            assert a[0] == BOS_ID and len(a) <= L + 1
            if a == b:
                continue
            mismatched += 1  # a floating-point near-tie: the scores must agree
            gap = abs(_rescore(dec, tz[n], a) - _rescore(dec, tz[n], b))
            assert gap < RESCORE_TOL, (ours, theirs, n, a, b, gap)
    assert mismatched <= 3, mismatched


@pytest.mark.parametrize("backend", ["host", "device"])
def test_beam_search_matches_exhaustive_oracle(backend):
    """V 6, max_len 4, beam width 6 (every token expanded): the beam returns
    the EOS-terminated sequence of the best length-normalized log-prob."""
    v, L = 6, 4
    _, _, dec = _decoders(v=v, seed=3, pred_scale=40.0, nz=2)
    z = _t(np.random.RandomState(8).randn(1, 2).astype(np.float32) * 2)
    best_score, best_seq = -np.inf, None
    for k in range(1, L + 1):
        seqs = np.array(list(itertools.product(range(v), repeat=k)), dtype=np.int64)
        toks_in = np.concatenate([np.full((len(seqs), 1), BOS_ID), seqs[:, :-1]], axis=1)
        with torch.no_grad():
            logits = dec.decode(torch.from_numpy(toks_in), z[:, None].expand(len(seqs), 1, 2))
        logp = torch.log_softmax(logits[:, 0], -1).numpy()
        chain = logp[np.arange(len(seqs))[:, None], np.arange(k)[None, :], seqs].sum(axis=1)
        done = seqs[:, -1] == EOS_ID
        if k > 1:
            done &= (seqs[:, :-1] != EOS_ID).all(axis=1)
        for s, sc in zip(seqs[done], chain[done]):
            if sc / (k + 1) > best_score:
                best_score, best_seq = sc / (k + 1), [BOS_ID] + list(map(int, s))
    assert best_seq is not None
    assert dec.beam_search_decode(z, beam_width=v, max_len=L, backend=backend)[0] == best_seq


def test_beam_unknown_backend_raises():
    _, _, dec = _decoders()
    with pytest.raises(ValueError, match="backend"):
        dec.beam_search_decode(torch.zeros(1, NZ), 2, 3, backend="devcie")


# --------------------------------------------------------------- VAE level
def _text_vaes(nz=NZ, seed=0):
    vae_j = JaxVAE(JaxEncoder(V, NI, NH, nz), JaxDecoder(V, NI, NH, nz, dropout_in=0.0,
                                                         dropout_out=0.0))
    params = jax.device_get(vae_j.init(jax.random.PRNGKey(seed)))
    params["dec"]["pred"] = params["dec"]["pred"] * 20.0
    params["enc"]["linear"] = (np.random.RandomState(seed).randn(NH, 2 * nz) * 0.3
                               ).astype(np.float32)
    vae = VAE(GaussianLSTMEncoder(V, NI, NH, nz), LSTMDecoder(V, NI, NH, nz, dropout_in=0.0,
                                                              dropout_out=0.0))
    vae.load_state_dict(from_jax_params(params))
    rng = np.random.RandomState(seed + 1)
    lens = rng.randint(3, 9, size=5)
    mask = (np.arange(9)[None, :] < lens[:, None]).astype(np.float32)
    tokens = np.where(mask > 0, rng.randint(4, V, (5, 9)), 0).astype(np.int32)
    return vae_j, jax.tree.map(jnp.asarray, params), vae, tokens, mask


@pytest.mark.parametrize("strategy", ["greedy", "sample", "beam"])
def test_reconstruct_matches_jax(strategy):
    vae_j, pj, vae, tokens, mask = _text_vaes(seed=4)
    key = jax.random.PRNGKey(9)
    L = 10
    want = vae_j.reconstruct(pj, key, jnp.asarray(tokens), jnp.asarray(mask), strategy, L)
    # one key for the encoder's eps and the decoder's draws, as JAX's reconstruct
    eps = _t(jax.random.normal(key, (5, 1, NZ), jnp.float32))
    got = vae.reconstruct(torch.from_numpy(tokens).long(), torch.from_numpy(mask), strategy, L,
                          eps=eps, noise=_jax_gumbels(key, L, (5, V)))
    if strategy == "beam":
        assert got == want
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_from_prior_shape_and_moments():
    _, _, vae, _, _ = _text_vaes()
    z = vae.sample_from_prior(20000, torch.Generator().manual_seed(0))
    assert z.shape == (20000, NZ) and z.dtype == torch.float32
    # standard errors: mean 0.007, std 0.005 at 20000 draws
    assert z.mean(0).abs().max() < 0.03 and (z.std(0) - 1).abs().max() < 0.03
    again = vae.sample_from_prior(20000, torch.Generator().manual_seed(0))
    assert torch.equal(z, again)


def test_calc_model_posterior_mean_matches_jax():
    vae_j, pj, vae, tokens, mask = _text_vaes(nz=1, seed=6)
    grid = np.linspace(-5, 5, 51, dtype=np.float32)[:, None]
    want = vae_j.calc_model_posterior_mean(pj, jnp.asarray(tokens), jnp.asarray(mask),
                                           jnp.asarray(grid))
    with torch.no_grad():
        got = vae.calc_model_posterior_mean(torch.from_numpy(tokens).long(),
                                            torch.from_numpy(mask), _t(grid))
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ images
def _image_models(dtype="float32", seed=0):
    over = dict(IMAGE, compute_dtype=dtype)
    jvae = jax_build_image(jax_get_config("omniglot", **over))
    params = jax.device_get(jvae.init(jax.random.PRNGKey(seed)))
    # larger weights, so that the logits vary over the image
    rng = np.random.RandomState(seed)
    for layer in params["dec"]["layers"]:
        layer["w"] = (rng.randn(*layer["w"].shape) * 0.3).astype(np.float32)
        layer["b"] = (rng.randn(*layer["b"].shape) * 0.1).astype(np.float32)
    params["dec"]["out_w"] = (rng.randn(*params["dec"]["out_w"].shape) * 0.5).astype(np.float32)
    vae = build_image_vae(get_config("omniglot", **over), device="cpu")
    vae.load_state_dict(from_jax_params(params))
    return jvae, jax.tree.map(jnp.asarray, params), vae


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 0.05)])
def test_incremental_sampler_matches_dense_logits(dtype, atol):
    jvae, pj, vae = _image_models(dtype, seed=1)
    rng = np.random.RandomState(7)
    x = (rng.rand(3, 12, 12, 1) > 0.5).astype(np.float32)
    z = rng.randn(3, IMAGE["nz"]).astype(np.float32)
    canvas, inc = vae.dec._incremental_pixels(_t(z), force_image=_t(x))
    with torch.no_grad():
        dense = vae.dec._logits(_t(x), _t(z))
    np.testing.assert_array_equal(canvas.numpy(), x)
    np.testing.assert_allclose(inc.numpy(), dense.numpy(), atol=atol, rtol=0, err_msg=dtype)
    _, inc_j = jvae.decoder._incremental_pixels(pj["dec"], jnp.asarray(z), jax.random.PRNGKey(0),
                                                force_image=jnp.asarray(x))
    np.testing.assert_allclose(inc.numpy(), np.asarray(inc_j), atol=atol, rtol=0, err_msg=dtype)


@pytest.mark.parametrize("fast", [True, False])
def test_samplers_match_jax(fast):
    """Both samplers on JAX's uniforms: the incremental one keys pixel p
    with ``fold_in(key, p)``, the dense one with a split chain."""
    jvae, pj, vae = _image_models(seed=2)
    z = np.random.RandomState(3).randn(4, IMAGE["nz"]).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jvae.decoder.sample(pj["dec"], key, jnp.asarray(z), fast=fast))
    shape, n_pix = (4, 1), 12 * 12
    if fast:
        us = [_t(jax.random.uniform(jax.random.fold_in(key, p), shape)) for p in range(n_pix)]
    else:
        us, k = [], key
        for _ in range(n_pix):
            k, sub = jax.random.split(k)
            us.append(_t(jax.random.uniform(sub, shape)))
    got = vae.dec.sample(_t(z), noise=lambda p, shp: us[p], fast=fast)
    assert 0 < want.mean() < 1  # the images are not blank
    np.testing.assert_array_equal(got.numpy(), want)


def test_image_reconstruct_and_defaults():
    _, _, vae = _image_models(seed=3)
    x = (np.random.RandomState(4).rand(2, 12, 12, 1) > 0.5).astype(np.float32)
    a = vae.reconstruct(_t(x), None, "sample", generator=torch.Generator().manual_seed(1))
    b = vae.reconstruct(_t(x), None, "sample", generator=torch.Generator().manual_seed(1))
    g = vae.reconstruct(_t(x), None, "greedy", eps=torch.zeros(2, 1, IMAGE["nz"]))
    assert torch.equal(a, b) and a.shape == g.shape == (2, 12, 12, 1)
    assert set(torch.unique(g).tolist()) <= {0.0, 1.0}


@pytest.mark.parametrize("n,ncols", [(7, 3), (20, 10), (2, 10)])
def test_save_grid_bytes_match_jax(tmp_path, n, ncols):
    imgs = np.random.RandomState(n).rand(n, 5, 6, 1).astype(np.float32)
    imgs[0] = (imgs[0] > 0.5)
    cli_image.save_grid(imgs, str(tmp_path / "port.png"), ncols=ncols)
    jax_cli_image.save_grid(imgs, str(tmp_path / "jax.png"), ncols=ncols)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    with pytest.raises(ValueError, match="no images"):
        cli_image.save_grid(imgs[:0], str(tmp_path / "empty.png"))
