"""The port's training path against the JAX package's, on the JAX package's
own noise.

- ``train/optim.py``: ``clip_scale`` and SGD, SGD with momentum and Adam
  over three steps (one with a non-finite gradient), against
  ``vae_lagging_encoder_tpu/train/optim.py`` on random trees; the optimizer
  state through a checkpoint the JAX package writes.
- ``data/pool.py::coords`` against ``sample_coords``.
- One training step with dropout on: loss, rec, KL, every gradient leaf and
  the parameters after the clipped enc+dec SGD update, against the JAX
  ``make_loss_fn(train=True)`` / ``make_grad_on`` with the JAX package's
  eps and dropout masks; on the scan route and on the kernel route (the
  JAX Pallas kernels in interpret mode; the port's ``LSTMSeqFn`` and
  ``FusedCEFn`` with their plain versions).
- The trajectory: the port's ``run_training`` against the JAX package's
  real ``run_training`` (its fused ``epoch_fn``, aggressive while-loop
  included), both with ``use_pallas`` on at widths where both run f32
  (H <= 512, V < 1024), over 5 epochs that take the aggressive inner loop,
  the MI switch-off and one LR decay with rollback to the best parameters.

The port's draws come from a ``noise(i, site, shape)`` provider that
replays the JAX key schedule: per epoch ``fold_in(fold_in(PRNGKey(seed),
epoch), segment)``; per outer step ``split(key, 3)`` -> (carry, k_inner,
k_loss); ``vae.loss`` splits k_loss into (k_enc, k_dec), eps is
``normal(k_enc)``, the decoder splits k_dec into (key_in, key_out) and its
dropout keeps ``uniform(key) < keep`` (what ``bernoulli`` computes); an
inner sub-iteration splits its carry into (carry, k_pick, k_loss) and picks
``randint(k_pick, (), 0, num_batches)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vae_lagging_encoder_tpu.config import get_config as jax_get_config
from vae_lagging_encoder_tpu.data import BucketedPool as JaxPool
from vae_lagging_encoder_tpu.data import MonoTextData as JaxText
from vae_lagging_encoder_tpu.data.synthetic import generate_synthetic_corpus
from vae_lagging_encoder_tpu.models import (VAE as JaxVAE, GaussianLSTMEncoder as JaxEncoder,
                                            LSTMDecoder as JaxDecoder, build_text_vae as jax_build)
from vae_lagging_encoder_tpu.train import optim as jax_optim
from vae_lagging_encoder_tpu.train.aggressive import make_grad_on as jax_make_grad_on
from vae_lagging_encoder_tpu.train.checkpoint import load_checkpoint as jax_load
from vae_lagging_encoder_tpu.train.checkpoint import save_checkpoint as jax_save
from vae_lagging_encoder_tpu.train.epoch import make_loss_fn as jax_make_loss_fn
from vae_lagging_encoder_tpu.train.loop import run_training as jax_run_training
from vae_lagging_encoder_tpu_torch.config import get_config
from vae_lagging_encoder_tpu_torch.data import BucketedPool, MonoTextData
from vae_lagging_encoder_tpu_torch.models import (VAE, GaussianLSTMEncoder, LSTMDecoder,
                                                  build_text_vae)
from vae_lagging_encoder_tpu_torch.train import optim
from vae_lagging_encoder_tpu_torch.train.aggressive import grads_of, make_grad_on
from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
from vae_lagging_encoder_tpu_torch.train.epoch import make_loss_fn
from vae_lagging_encoder_tpu_torch.train.loop import run_training
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def loss_draw(k_loss):
    """The draws of ``vae.loss(params, k_loss, ..., train=True)``."""
    k_enc, k_dec = jax.random.split(k_loss)
    k_in, k_out = jax.random.split(k_dec)

    def draw(site, shape):
        if site == "eps":
            return _t(jax.random.normal(k_enc, shape, jnp.float32))
        return _t(jax.random.uniform(k_in if site == "keep_in" else k_out, shape, jnp.float32))

    return draw


# ------------------------------------------------------------------ optim
# f32 on both sides, elementwise updates in the same order of operations;
# only the clip's sum of squares is reduced in another order
OPT_ATOL, OPT_RTOL = 1e-6, 1e-5


def _trees(seed, bad=False):
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": {"c": rng.randn(7).astype(np.float32), "d": rng.randn(2, 2).astype(np.float32)}}
    grads = {"a": (rng.randn(5, 3) * 3).astype(np.float32),
             "b": {"c": (rng.randn(7) * 3).astype(np.float32),
                   "d": (rng.randn(2, 2) * 3).astype(np.float32)}}
    if bad:
        grads["b"]["d"][0, 1] = np.inf
    return params, grads


@pytest.mark.parametrize("bad", [False, True])
def test_clip_scale_matches_jax(bad):
    _, grads = _trees(0, bad)
    want = jax.device_get(jax_optim.clip_scale(jax.tree.map(jnp.asarray, grads), 5.0))
    got = optim.clip_scale({k: _t(v) for k, v in _flat(grads).items()}, 5.0)
    assert bool(got[2]) == bool(want[2]) == (not bad)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=OPT_RTOL)
    if not bad:
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=OPT_RTOL)
        assert float(got[0]) < 1.0  # the clip is active at norm ~ 3 * sqrt(26)


@pytest.mark.parametrize("name,momentum", [("sgd", 0.0), ("sgd", 0.9), ("adam", 0.0)])
def test_optimizer_steps_match_jax(name, momentum, tmp_path):
    params, _ = _trees(1)
    j_init, j_update = jax_optim.make_optimizer(name, momentum=momentum)
    p_init, p_update = optim.make_optimizer(name, momentum=momentum)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_init(jp)
    tp = {k: _t(v) for k, v in _flat(params).items()}
    ts = p_init(tp)
    for step in range(3):
        _, grads = _trees(10 + step, bad=step == 1)
        scale, _, finite = jax_optim.clip_scale(jax.tree.map(jnp.asarray, grads), 5.0)
        jp, js = j_update(jp, jax.tree.map(jnp.asarray, grads), js, jnp.float32(0.3),
                          scale=scale, finite=finite)
        tg = {k: _t(v) for k, v in _flat(grads).items()}
        t_scale, _, t_finite = optim.clip_scale(tg, 5.0)
        ts = p_update(tp, tg, ts, 0.3, scale=t_scale, finite=t_finite)
        for k, v in _flat(jax.device_get(jp)).items():
            np.testing.assert_allclose(tp[k].numpy(), v, atol=OPT_ATOL, rtol=OPT_RTOL,
                                       err_msg=f"step {step} {k}")
    # the state: in the JAX tree layout, and through a JAX-written checkpoint
    want = _flat(jax.device_get(js))
    got = _flat(optim.state_to_tree({"enc": ts})["enc"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=OPT_ATOL, rtol=OPT_RTOL, err_msg=k)
    jax_save(str(tmp_path / "ck"), params, {"opt_state": {"enc": jax.device_get(js)}})
    back = optim.state_from_tree(load_checkpoint(str(tmp_path / "ck"))[1]["opt_state"], "cpu")
    for k, v in _flat(optim.state_to_tree(back)["enc"]).items():
        np.testing.assert_allclose(v, want[k], atol=OPT_ATOL, rtol=OPT_RTOL, err_msg=k)


# ------------------------------------------------------------------- pool
def test_pool_coords_match_jax_sample_coords(tmp_path):
    rng = np.random.RandomState(0)
    lines = [f"0\t" + " ".join(f"w{j}" for j in rng.randint(0, 9, rng.randint(2, 40)))
             for _ in range(70)]
    (tmp_path / "c.txt").write_text("\n".join(lines) + "\n")
    # the JAX side reads the same sentences in Python: its native reader's
    # ctypes binding can read a small vocabulary blob after freeing it
    jtext = JaxText(sentences=[l.split("\t", 1)[1].split() for l in lines], labels=[0] * 70)
    jpool = JaxPool(jtext.create_data_batch(8, (16, 32, 48)))
    pool = BucketedPool(MonoTextData(str(tmp_path / "c.txt"), label=True)
                        .create_data_batch(8, (16, 32, 48)), "cpu")
    for s in range(12):
        key = jax.random.PRNGKey(s)
        flat = int(jax.random.randint(key, (), 0, jpool.num_batches))
        b, i = (int(x) for x in jpool.sample_coords(key))
        assert pool.coords(flat) == (b, i)
        for got, want in zip(pool.batch(flat), jpool.arrays[b]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[i]))
    with pytest.raises(IndexError):
        pool.coords(pool.num_batches)


# -------------------------------------------------------- one training step
V, NI, NH, NZ, B, T = 1100, 16, 128, 4, 8, 10
DROP_IN, DROP_OUT = 0.3, 0.4
# f32 on both sides (the CE's bf16 operands are rounded alike); sums in
# another order. Gradients and losses: as the JAX kernels' own grad checks
# (tests/test_pallas.py:92).
STEP_ATOL, STEP_RTOL = 3e-4, 1e-3


@pytest.mark.parametrize("kernel_route", [False, True])
def test_train_step_with_dropout_matches_jax(kernel_route):
    rng = np.random.RandomState(4)
    tokens = rng.randint(4, V, (B, T)).astype(np.int32)
    lens = rng.randint(3, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    tokens = np.where(mask > 0, tokens, 0).astype(np.int32)
    rw = np.ones(B, np.float32)
    rw[-1] = 0.0
    backend = "pallas" if kernel_route else "scan"
    key, kl_weight, lr, clip = jax.random.PRNGKey(3), 0.37, 0.8, 0.05
    with pltpu.force_tpu_interpret_mode():
        vae_j = JaxVAE(JaxEncoder(V, NI, NH, NZ, backend=backend),
                       JaxDecoder(V, NI, NH, NZ, dropout_in=DROP_IN, dropout_out=DROP_OUT,
                                  backend=backend))
        params = jax.device_get(vae_j.init(jax.random.PRNGKey(5)))
        params["enc"]["linear"] = (rng.randn(NH, 2 * NZ) * 0.3).astype(np.float32)
        pj = jax.tree.map(jnp.asarray, params)
        grad_on = jax.jit(jax_make_grad_on(jax_make_loss_fn(vae_j, nsamples=1, train=True)))
        grads_j, aux_j = grad_on(pj, key, (jnp.asarray(tokens), jnp.asarray(mask),
                                           jnp.asarray(rw)), jnp.float32(kl_weight))
        scale_j, _, finite_j = jax_optim.clip_scale(grads_j, clip)
        _, sgd = jax_optim.make_optimizer("sgd")
        new_j = {part: sgd(pj[part], grads_j[part], {}, jnp.float32(lr), scale=scale_j,
                           finite=finite_j)[0] for part in ("enc", "dec")}
        grads_j, aux_j, new_j = jax.device_get((grads_j, aux_j, new_j))

    vae = VAE(GaussianLSTMEncoder(V, NI, NH, NZ, kernel_route=kernel_route),
              LSTMDecoder(V, NI, NH, NZ, dropout_in=DROP_IN, dropout_out=DROP_OUT,
                          kernel_route=kernel_route))
    vae.load_state_dict(from_jax_params(params))
    aux = make_grad_on(vae, make_loss_fn(vae, nsamples=1, train=True))(
        (torch.from_numpy(tokens).long(), torch.from_numpy(mask), torch.from_numpy(rw)),
        loss_draw(key), kl_weight)
    for got, want, name in zip(aux, aux_j, ("loss_sum", "rec_sum", "kl_sum", "n_sents",
                                            "n_words")):
        np.testing.assert_allclose(float(got.detach()), float(want), atol=STEP_ATOL,
                                   rtol=STEP_RTOL, err_msg=name)
    named = dict(vae.named_parameters())
    grads = grads_of(named)
    want = _flat(grads_j)
    assert want.keys() == grads.keys()
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k], atol=STEP_ATOL, rtol=STEP_RTOL,
                                   err_msg=k)
    scale, _, finite = optim.clip_scale(grads, clip)
    assert bool(finite) and float(scale) < 1.0  # the clip is active
    _, sgd_t = optim.make_optimizer("sgd")
    for part, mod in (("enc", vae.enc), ("dec", vae.dec)):
        ps = dict(mod.named_parameters())
        sgd_t(ps, grads_of(ps), {}, lr, scale=scale, finite=finite)
    for k, v in _flat(new_j).items():
        np.testing.assert_allclose(named[k].detach().numpy(), v, atol=STEP_ATOL, rtol=STEP_RTOL,
                                   err_msg=k)


# ------------------------------------------------------------- trajectory
def jax_noise_for(seed):
    """``noise_for(stage, epoch)`` replaying the JAX ``run_training`` keys:
    training as in the module docstring (one segment per epoch here), the
    per-epoch val MI / val ELBO / test keys ``fold_in(master, 10_000 /
    20_000 / 30_000 + epoch)`` and the final evaluation's
    ``PRNGKey(seed + 1)`` schedule, each evaluator drawing per batch ``i``
    from ``split(fold_in(key, i))`` (see test_torch_port_slice.py)."""
    master, final = jax.random.PRNGKey(seed), jax.random.PRNGKey(seed + 1)

    def eval_noise(base, half):
        def noise(i, site, shape):
            k = jax.random.split(jax.random.fold_in(base, i))[half]
            if site.startswith("iw"):
                k = jax.random.fold_in(k, int(site[2:]))
            return _t(jax.random.normal(k, shape, jnp.float32))
        return noise

    def train_noise(epoch):
        key0 = jax.random.fold_in(jax.random.fold_in(master, epoch), 0)
        steps, inner = [], {}

        def step_keys(s):  # (carry, k_inner, k_loss) of outer step s
            while len(steps) <= s:
                steps.append(jax.random.split(steps[-1][0] if steps else key0, 3))
            return steps[s]

        def noise(i, site, shape):
            if isinstance(i, tuple):  # (step, sub): the inner loop's carry chain
                s, sub = i
                chain = inner.setdefault(s, [])
                while len(chain) <= sub:
                    chain.append(jax.random.split(chain[-1][0] if chain else step_keys(s)[1], 3))
                _, k_pick, k_loss = chain[sub]
                if site == "pick":
                    return int(jax.random.randint(k_pick, (), 0, shape[0]))
            else:
                k_loss = step_keys(i)[2]
            return loss_draw(k_loss)(site, shape)

        return noise

    def noise_for(stage, epoch):
        if stage == "train":
            return train_noise(epoch)
        if stage == "final":
            elbo, mi, iw = (eval_noise(final, 0), eval_noise(jax.random.fold_in(final, 1), 1),
                            eval_noise(jax.random.fold_in(final, 3), 1))
            return lambda i, site, shape: {"elbo": elbo, "mi": mi}.get(site, iw)(i, site, shape)
        off, half = {"val_mi": (10_000, 1), "val": (20_000, 0), "test": (30_000, 0)}[stage]
        return eval_noise(jax.random.fold_in(master, off + epoch), half)

    return noise_for


class _Capture:
    def __init__(self):
        self.lines, self.metrics = [], []

    def info(self, msg):
        self.lines.append(msg)

    def metric(self, **kv):
        kv.pop("ts", None)
        self.metrics.append(kv)


# Measured on this CPU: final parameter drift ~1e-6 and per-epoch losses
# equal to ~1e-7 relative. A semantic divergence (anneal order, plateau
# window, rollback, a wrong draw) moves both by far more; the discrete
# decisions (inner-loop counts, switch-off, decay) must agree exactly.
TRAJ_LOSS_RTOL, TRAJ_PARAM_ATOL = 1e-4, 1e-4


def test_aggressive_trajectory_with_lr_decay_matches_jax(tmp_path):
    sents, _ = generate_synthetic_corpus(num_sentences=96, vocab_size=20, min_len=4,
                                         max_len=12, seed=42)
    for split, ss in (("train", sents[:64]), ("valid", sents[64:80]), ("test", sents[80:])):
        (tmp_path / f"{split}.txt").write_text("".join(f"0\t{' '.join(s)}\n" for s in ss))
    over = dict(ni=16, enc_nh=24, dec_nh=24, nz=6, batch_size=8, use_pallas=True,
                dec_dropout_in=0.2, dec_dropout_out=0.2, warm_up=1, kl_start=0.1, lr=1.5,
                clip_grad=5.0, burn_max_iters=12, burn_window=3, length_buckets=(16,),
                epochs=5, decay_epoch=1, max_decay=2, aggressive=True, test_nepoch=0,
                iw_nsamples=10, iw_batch=5, seed=5, train_data=str(tmp_path / "train.txt"),
                val_data=str(tmp_path / "valid.txt"), test_data=str(tmp_path / "test.txt"))

    jcfg = jax_get_config("synthetic", **over, save_path=str(tmp_path / "jax.ckpt"))
    jtrain = JaxText(jcfg.train_data, label=True)
    jpool = lambda f: JaxPool(JaxText(f, label=True, vocab=jtrain.vocab)
                              .create_data_batch(jcfg.batch_size, jcfg.length_buckets))
    jvae = jax_build(jcfg, len(jtrain.vocab))
    params = jvae.init(jax.random.PRNGKey(7))
    jlog = _Capture()
    want = jax_run_training(jcfg, jvae, params, jpool(jcfg.train_data), jpool(jcfg.val_data),
                            jpool(jcfg.test_data), jlog)

    cfg = get_config("synthetic", **over, save_path=str(tmp_path / "port.ckpt"))
    train = MonoTextData(cfg.train_data, label=True)
    pool = lambda f: BucketedPool(MonoTextData(f, label=True, vocab=train.vocab)
                                  .create_data_batch(cfg.batch_size, cfg.length_buckets), "cpu")
    vae = build_text_vae(cfg, len(train.vocab), device="cpu")
    vae.load_state_dict(from_jax_params(jax.device_get(params)))
    log = _Capture()
    got = run_training(cfg, vae, pool(cfg.train_data), pool(cfg.val_data), pool(cfg.test_data),
                       log, noise_for=jax_noise_for(cfg.seed))

    # the run covers what it should: aggressive epochs, the switch-off, a decay
    epochs_j = [m for m in jlog.metrics if "val_loss" in m]
    assert epochs_j[0]["inner_iters"] > 0 and not epochs_j[-1]["aggressive"]
    assert any("aggressive OFF" in l for l in jlog.lines)
    assert any("rolled back to best" in l for l in jlog.lines)
    assert [l for l in log.lines if "plateau" in l] == [l for l in jlog.lines if "plateau" in l]
    epochs = [m for m in log.metrics if "val_loss" in m]
    assert len(epochs) == len(epochs_j) == 5
    for m, mj in zip(epochs, epochs_j):
        assert (m["inner_iters"], m["aggressive"], m["lr"]) == \
            (mj["inner_iters"], mj["aggressive"], mj["lr"]), (m, mj)
        for k in ("train_loss", "val_loss", "kl_weight"):
            np.testing.assert_allclose(m[k], mj[k], rtol=TRAJ_LOSS_RTOL, err_msg=k)
    for k in ("elbo_loss", "rec", "iw_nll", "best_val_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=TRAJ_LOSS_RTOL, err_msg=k)
    assert got["au"] == want["au"]
    # the best checkpoints: the same parameters and state, readable by both
    pj, ej = jax_load(str(tmp_path / "jax.ckpt"))
    pp, ep = load_checkpoint(str(tmp_path / "port.ckpt"))
    assert set(ep) == set(ej) and ep["epoch"] == ej["epoch"] and ep["lr"] == ej["lr"]
    fj, fp = _flat(pj), _flat(pp)
    assert fj.keys() == fp.keys()
    worst = max(float(np.abs(fj[k] - fp[k]).max()) for k in fj)
    assert worst < TRAJ_PARAM_ATOL, worst
