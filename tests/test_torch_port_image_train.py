"""The port's image training and evaluation paths against the JAX package's,
on the JAX package's own noise, at small widths (enc (8, 8), 3 PixelCNN
layers of 8 filters, nz 4, 28x28).

- One training step: the loss of ``make_image_loss_fn`` (a fresh
  binarization, then the loss), every gradient leaf, and the parameters and
  Adam moments after the clipped enc+dec update, against the JAX
  ``make_image_loss_fn`` + ``make_grad_on`` and its Adam.
- The final evaluation (ELBO with its binarization, MI, AU with one
  binarization for both passes, IW-NLL with pixels as the PPL's unit):
  the port's ``run_final_eval`` against the JAX package's.
- The trajectory: the port's ``run_training`` against the JAX package's real
  ``run_training`` for images over 3 epochs with the aggressive inner loop
  and the MI switch-off; inner-loop counts equal.

The noise providers replay the JAX key schedule (see
``tests/test_torch_port_train.py`` for the text one). The image loss splits
its key into (k_bin, k_loss) and binarizes with ``uniform(k_bin) < probs``
(what ``bernoulli`` computes); the evaluators split each batch key into
(k_prep, key) for MI and IW; AU binarizes with the batch key itself.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vae_lagging_encoder_tpu.config import get_config as jax_get_config
from vae_lagging_encoder_tpu.data import ImagePool as JaxImagePool
from vae_lagging_encoder_tpu.models import build_image_vae as jax_build
from vae_lagging_encoder_tpu.train import optim as jax_optim
from vae_lagging_encoder_tpu.train.aggressive import make_grad_on as jax_make_grad_on
from vae_lagging_encoder_tpu.train.checkpoint import load_checkpoint as jax_load
from vae_lagging_encoder_tpu.train.epoch import binarize_prep as jax_binarize_prep
from vae_lagging_encoder_tpu.train.epoch import make_image_loss_fn as jax_image_loss_fn
from vae_lagging_encoder_tpu.train.loop import run_final_eval as jax_final_eval
from vae_lagging_encoder_tpu.train.loop import run_training as jax_run_training
from vae_lagging_encoder_tpu.utils.exp_utils import Logger as JaxLogger
from vae_lagging_encoder_tpu_torch.config import get_config
from vae_lagging_encoder_tpu_torch.data import ImagePool
from vae_lagging_encoder_tpu_torch.models import build_image_vae
from vae_lagging_encoder_tpu_torch.train import optim
from vae_lagging_encoder_tpu_torch.train.aggressive import grads_of, make_grad_on
from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
from vae_lagging_encoder_tpu_torch.train.epoch import binarize_prep, make_image_loss_fn
from vae_lagging_encoder_tpu_torch.train.loop import run_final_eval, run_training
from vae_lagging_encoder_tpu_torch.utils.exp_utils import Logger
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

SMALL = dict(nz=4, enc_layers=(8, 8), dec_layers=3, dec_filters=8, dec_kernel_size=7)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _probs(n, seed):
    """Glyph-like probabilities: mostly near 0 or 1, some in between."""
    return (np.random.RandomState(seed).rand(n, 28, 28, 1) ** 4).astype(np.float32)


def image_loss_draw(k_loss):
    """The draws of the image loss with key ``k_loss``: the binarization
    uniforms from split(k_loss)[0], eps from split(split(k_loss)[1])[0]."""
    k_bin, k_l = jax.random.split(k_loss)

    def draw(site, shape):
        if site == "bin":
            return _t(jax.random.uniform(k_bin, shape, jnp.float32))
        return _t(jax.random.normal(jax.random.split(k_l)[0], shape, jnp.float32))

    return draw


def eval_noise(base, site_kind):
    """Per batch i from ``fold_in(base, i)``: "elbo" splits it into
    (k_bin, k_loss) as the eval loss does; "mi" / "iw" into (k_prep, key);
    "au" binarizes with the batch key itself."""

    def noise(i, site, shape):
        k_i = jax.random.fold_in(base, i)
        if site_kind == "elbo":
            return image_loss_draw(k_i)("bin" if site.endswith("bin") else "eps", shape)
        if site_kind == "au":
            return _t(jax.random.uniform(k_i, shape, jnp.float32))
        k_prep, key = jax.random.split(k_i)
        if site.endswith("bin"):
            return _t(jax.random.uniform(k_prep, shape, jnp.float32))
        if site.startswith("iw"):
            key = jax.random.fold_in(key, int(site[2:]))
        return _t(jax.random.normal(key, shape, jnp.float32))

    return noise


def final_noise(seed):
    """``run_final_eval``'s keys: PRNGKey(seed + 1) for ELBO, fold_in 1 / 2 / 3
    for MI / AU / IW."""
    key = jax.random.PRNGKey(seed + 1)
    by_kind = {kind: eval_noise(jax.random.fold_in(key, j) if j else key, kind)
               for j, kind in enumerate(("elbo", "mi", "au", "iw"))}

    def noise(i, site, shape):
        return by_kind["iw" if site.startswith("iw") else site.split("_")[0]](i, site, shape)

    return noise


def _setup(seed, **over):
    cfg_kw = dict(SMALL, batch_size=8, optim="adam", lr=2e-3, seed=5, **over)
    jcfg, cfg = jax_get_config("omniglot", **cfg_kw), get_config("omniglot", **cfg_kw)
    jvae = jax_build(jcfg)
    params = jax.device_get(jvae.init(jax.random.PRNGKey(seed)))
    vae = build_image_vae(cfg, device="cpu")
    vae.load_state_dict(from_jax_params(params))
    return jcfg, cfg, jvae, params, vae


# -------------------------------------------------------- one training step
# f32 on both sides, sums in another order; the losses are sums of ~800
# per-pixel BCEs, the gradients sums over 8 images x 784 pixels: as the
# kernels' own grad checks (tests/test_pallas.py:92). Adam divides by
# sqrt(v) ~ |g|, so its step amplifies a relative gradient difference only
# where |g| ~ eps; the parameters after one step agree to ~1e-7.
STEP_ATOL, STEP_RTOL = 3e-4, 1e-3
PARAM_ATOL = 1e-6


def test_image_train_step_with_adam_matches_jax():
    jcfg, cfg, jvae, params, vae = _setup(1)
    probs = _probs(8, 2)
    rw = np.ones(8, np.float32)
    rw[-1] = 0.0
    key, kl_weight, lr, clip = jax.random.PRNGKey(4), 0.4, 2e-3, 5.0
    pj = jax.tree.map(jnp.asarray, params)
    grad_on_j = jax.jit(jax_make_grad_on(jax_image_loss_fn(jvae, nsamples=1, train=True)))
    grads_j, aux_j = grad_on_j(pj, key, (jnp.asarray(probs), jnp.asarray(rw)),
                               jnp.float32(kl_weight))
    scale_j, _, finite_j = jax_optim.clip_scale(grads_j, clip)
    init_j, adam_j = jax_optim.make_optimizer("adam")
    new_j, state_j = {}, {}
    for part in ("enc", "dec"):
        new_j[part], state_j[part] = adam_j(pj[part], grads_j[part], init_j(pj[part]),
                                            jnp.float32(lr), scale=scale_j, finite=finite_j)
    grads_j, aux_j, new_j, state_j = jax.device_get((grads_j, aux_j, new_j, state_j))

    aux = make_grad_on(vae, make_image_loss_fn(vae, nsamples=1, train=True))(
        (_t(probs), _t(rw)), image_loss_draw(key), kl_weight)
    for got, want, name in zip(aux, aux_j, ("loss_sum", "rec_sum", "kl_sum", "n", "n_pixels")):
        np.testing.assert_allclose(float(got.detach()), float(want), atol=STEP_ATOL,
                                   rtol=STEP_RTOL, err_msg=name)
    assert float(aux[4]) == 7 * 784
    named = dict(vae.named_parameters())
    grads = grads_of(named)
    want = _flat(grads_j)
    assert want.keys() == grads.keys()
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k], atol=STEP_ATOL, rtol=STEP_RTOL,
                                   err_msg=k)
    scale, _, finite = optim.clip_scale(grads, clip)
    init, adam = optim.make_optimizer("adam")
    state = {}
    for part, mod in (("enc", vae.enc), ("dec", vae.dec)):
        ps = dict(mod.named_parameters())
        state[part] = adam(ps, grads_of(ps), init(ps), lr, scale=scale, finite=finite)
    for k, v in _flat(new_j).items():
        np.testing.assert_allclose(named[k].detach().numpy(), v, atol=PARAM_ATOL, err_msg=k)
    # the moments, through the JAX tree layout (lists for blocks and layers)
    tree = optim.state_to_tree(state)
    assert isinstance(tree["dec"]["m"]["layers"], list)
    got_s, want_s = _flat(tree), _flat(state_j)
    assert got_s.keys() == want_s.keys()
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], atol=STEP_ATOL, rtol=STEP_RTOL,
                                   err_msg=k)


# ----------------------------------------------------- the final evaluation
# per-image values agree to ~1e-6 relative (f32, sums in another order);
# corpus means of O(100-500) nats to ~1e-4 absolute
RTOL, ATOL = 1e-5, 1e-4


def test_image_final_eval_matches_jax():
    jcfg, cfg, jvae, params, vae = _setup(2, iw_nsamples=40, iw_batch=20)
    rng = np.random.RandomState(3)
    for blk in params["enc"]["blocks"]:  # an encoder whose posterior depends on x
        for k in blk:
            blk[k] = rng.uniform(-0.3, 0.3, blk[k].shape).astype(np.float32)
    params["enc"]["fc"] = rng.uniform(-0.3, 0.3, params["enc"]["fc"].shape).astype(np.float32)
    vae.load_state_dict(from_jax_params(params))
    imgs = _probs(21, 4)  # 3 batches of 8, the last one with 5 real rows
    want = jax_final_eval(jcfg, jvae, jax.tree.map(jnp.asarray, params),
                          JaxImagePool(imgs, 8), JaxLogger(quiet=True),
                          eval_loss_fn=jax_image_loss_fn(jvae, nsamples=1, train=False),
                          prep=jax_binarize_prep)
    with torch.no_grad():
        got = run_final_eval(cfg, vae, ImagePool(imgs, 8, "cpu"), Logger(quiet=True),
                             noise=final_noise(cfg.seed),
                             eval_loss_fn=make_image_loss_fn(vae, nsamples=1, train=False),
                             prep=binarize_prep)
    assert set(got) == set(want)
    assert got["au"] == want["au"] and want["au"] > 0 and want["kl"] > 0.1
    for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "iw_ppl"):
        assert math.isclose(got[k], want[k], rel_tol=RTOL, abs_tol=ATOL), (k, got[k], want[k])


# ------------------------------------------------------------- trajectory
def jax_image_noise_for(seed):
    """``noise_for(stage, epoch)`` replaying the JAX ``run_training`` keys for
    images: per epoch ``fold_in(fold_in(PRNGKey(seed), epoch), 0)``, per
    outer step ``split(key, 3)`` -> (carry, k_inner, k_loss), per inner
    sub-iteration ``split(carry, 3)`` -> (carry, k_pick, k_loss); the
    per-epoch val MI / val ELBO / test keys ``fold_in(master, 10_000 /
    20_000 / 30_000 + epoch)``; the final evaluation's ``final_noise``."""
    master = jax.random.PRNGKey(seed)

    def train_noise(epoch):
        key0 = jax.random.fold_in(jax.random.fold_in(master, epoch), 0)
        steps, inner = [], {}

        def step_keys(s):
            while len(steps) <= s:
                steps.append(jax.random.split(steps[-1][0] if steps else key0, 3))
            return steps[s]

        def noise(i, site, shape):
            if isinstance(i, tuple):
                s, sub = i
                chain = inner.setdefault(s, [])
                while len(chain) <= sub:
                    chain.append(jax.random.split(chain[-1][0] if chain else step_keys(s)[1], 3))
                _, k_pick, k_loss = chain[sub]
                if site == "pick":
                    return int(jax.random.randint(k_pick, (), 0, shape[0]))
            else:
                k_loss = step_keys(i)[2]
            return image_loss_draw(k_loss)(site, shape)

        return noise

    def noise_for(stage, epoch):
        if stage == "train":
            return train_noise(epoch)
        if stage == "final":
            return final_noise(seed)
        off, kind = {"val_mi": (10_000, "mi"), "val": (20_000, "elbo"),
                     "test": (30_000, "elbo")}[stage]
        return eval_noise(jax.random.fold_in(master, off + epoch), kind)

    return noise_for


class _Capture:
    def __init__(self):
        self.lines, self.metrics = [], []

    def info(self, msg):
        self.lines.append(msg)

    def metric(self, **kv):
        kv.pop("ts", None)
        self.metrics.append(kv)


# f32 on both sides over ~100 Adam steps: the per-epoch losses agree to
# ~1e-6 relative and the parameters to ~1e-5 (Adam's normalised steps carry
# a relative gradient difference into the parameters at lr scale). A wrong
# draw, anneal order or plateau decision moves them by far more; the
# discrete decisions (inner-loop counts, the switch-off) must agree exactly.
TRAJ_LOSS_RTOL, TRAJ_PARAM_ATOL = 1e-4, 1e-4


def test_image_aggressive_trajectory_matches_jax(tmp_path):
    over = dict(warm_up=1, kl_start=0.1, burn_max_iters=10, burn_window=3, epochs=3,
                aggressive=True, test_nepoch=2, iw_nsamples=10, iw_batch=5, decay_epoch=1,
                max_decay=1)
    jcfg, cfg, jvae, params, vae = _setup(7, **over)
    train, val, test = _probs(32, 8), _probs(16, 9), _probs(16, 10)
    jlog = _Capture()
    want = jax_run_training(
        jcfg.replace(save_path=str(tmp_path / "jax.ckpt")), jvae, jax.tree.map(jnp.asarray, params),
        JaxImagePool(train, 8), JaxImagePool(val, 8), JaxImagePool(test, 8), jlog,
        loss_fn=jax_image_loss_fn(jvae, nsamples=1, train=True),
        eval_loss_fn=jax_image_loss_fn(jvae, nsamples=1, train=False), prep=jax_binarize_prep)
    log = _Capture()
    got = run_training(
        cfg.replace(save_path=str(tmp_path / "port.ckpt")), vae, ImagePool(train, 8, "cpu"),
        ImagePool(val, 8, "cpu"), ImagePool(test, 8, "cpu"), log,
        loss_fn=make_image_loss_fn(vae, nsamples=1, train=True),
        eval_loss_fn=make_image_loss_fn(vae, nsamples=1, train=False), prep=binarize_prep,
        noise_for=jax_image_noise_for(cfg.seed))

    epochs_j = [m for m in jlog.metrics if "val_loss" in m]
    assert epochs_j[0]["inner_iters"] > 0 and not epochs_j[-1]["aggressive"]
    assert any("aggressive OFF" in l for l in jlog.lines)
    epochs = [m for m in log.metrics if "val_loss" in m]
    assert len(epochs) == len(epochs_j) == 3
    for m, mj in zip(epochs, epochs_j):
        assert (m["inner_iters"], m["aggressive"], m["lr"]) == \
            (mj["inner_iters"], mj["aggressive"], mj["lr"]), (m, mj)
        for k in ("train_loss", "val_loss", "kl_weight"):
            np.testing.assert_allclose(m[k], mj[k], rtol=TRAJ_LOSS_RTOL, err_msg=k)
    assert [l for l in log.lines if "OFF" in l] == [l for l in jlog.lines if "OFF" in l]
    for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "best_val_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=TRAJ_LOSS_RTOL, err_msg=k)
    assert got["au"] == want["au"]
    pj, ej = jax_load(str(tmp_path / "jax.ckpt"))
    pp, ep = load_checkpoint(str(tmp_path / "port.ckpt"))
    assert set(ep) == set(ej) and ep["epoch"] == ej["epoch"]
    fj, fp = _flat(pj), _flat(pp)
    assert fj.keys() == fp.keys()
    assert max(float(np.abs(fj[k] - fp[k]).max()) for k in fj) < TRAJ_PARAM_ATOL
    sj, sp = _flat(ej["opt_state"]), _flat(ep["opt_state"])
    assert sj.keys() == sp.keys()
