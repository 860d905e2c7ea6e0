"""The port's mid-epoch autosave and resume, and multi-sample training above
``iw_chunk``.

- A run stopped by the ``_stop_after_steps`` hook and resumed from its
  ``<save_path>.auto`` equals the uninterrupted run bit for bit on the CPU
  (every epoch's metrics, the final evaluation, the best checkpoint), for
  the text VAE without and with the aggressive loop and for the image VAE,
  through ``cli.text`` / ``cli.image`` with ``--autosave_niter``.
- On the JAX package's replayed noise (its key schedule with
  ``--epoch_segment 2``: a fresh split chain per two-step segment), the
  port's killed-and-resumed run matches the JAX package's killed-and-
  resumed run (``_stop_after_segments``) within the trajectory tolerances
  of tests/test_torch_port_train.py, and both autosaves hold the same
  position and counters.
- The port reads an autosave the JAX package wrote: it re-enters the epoch
  at its ``next_start`` with its sums and inner-iteration count, and says
  that it continues on its own draws.
- The three refusals of a mismatched autosave: another ``--seed``, another
  number of training batches, a missing best-val checkpoint.
- ``reconstruct_error`` in training mode with K above ``iw_chunk`` (25
  and 40 samples) on the scan route and on the kernel route's plain
  versions: loss and every gradient against the JAX package's on the same
  per-chunk dropout keys; chunked equals unchunked without dropout; the
  chunks' masks differ; gradients through ``torch.utils.checkpoint`` equal
  those without it.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_train import (STEP_ATOL, STEP_RTOL, TRAJ_LOSS_RTOL, TRAJ_PARAM_ATOL,
                                   _Capture, _flat, _t, jax_noise_for, loss_draw)
from vae_lagging_encoder_tpu.config import get_config as jax_get_config
from vae_lagging_encoder_tpu.data import BucketedPool as JaxPool
from vae_lagging_encoder_tpu.data import MonoTextData as JaxText
from vae_lagging_encoder_tpu.data.synthetic import generate_synthetic_corpus
from vae_lagging_encoder_tpu.models import LSTMDecoder as JaxDecoder
from vae_lagging_encoder_tpu.models import dec_lstm as jax_dec_lstm
from vae_lagging_encoder_tpu.ops import ce_pallas as jax_ce_pallas
from vae_lagging_encoder_tpu.ops import lstm_pallas as jax_lstm_pallas
from vae_lagging_encoder_tpu.models import build_text_vae as jax_build
from vae_lagging_encoder_tpu.train.checkpoint import load_checkpoint as jax_load
from vae_lagging_encoder_tpu.train.loop import run_training as jax_run_training
from vae_lagging_encoder_tpu_torch.cli import image as cli_image
from vae_lagging_encoder_tpu_torch.cli import text as cli_text
from vae_lagging_encoder_tpu_torch.config import DATASET_CONFIGS, get_config
from vae_lagging_encoder_tpu_torch.data import BucketedPool, MonoTextData
from vae_lagging_encoder_tpu_torch.models import LSTMDecoder, build_text_vae, dec_lstm
from vae_lagging_encoder_tpu_torch.train import loop
from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
from vae_lagging_encoder_tpu_torch.train.epoch import GeneratorNoise
from vae_lagging_encoder_tpu_torch.train.loop import run_training
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

SMALL = dict(ni=8, enc_nh=12, dec_nh=12, nz=3)
IMAGE_SMALL = dict(nz=3, enc_layers=(4, 4), dec_layers=2, dec_filters=4, dec_kernel_size=5)


# --------------------------------------------------- killed-and-resumed, port
def _text_files(d):
    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(26)]
    for split, n in (("train", 30), ("valid", 6), ("test", 8)):
        lines = [f"1\t" + " ".join(words[j] for j in rng.randint(0, 26, rng.randint(2, 12)))
                 for _ in range(n)]
        (d / f"{split}.txt").write_text("\n".join(lines) + "\n")
    return ["--train_data", str(d / "train.txt"), "--val_data", str(d / "valid.txt"),
            "--test_data", str(d / "test.txt")]


def _run_cli(main, argv, exp_dir, monkeypatch, stop=None):
    """``main(argv)``; with ``stop``, ``run_training`` stops after that many
    steps. Returns the per-epoch metrics and the final results (None when
    stopped)."""
    if stop is not None:
        monkeypatch.setattr(loop, "run_training",
                            lambda *a, **k: run_training(*a, **k, _stop_after_steps=stop))
    try:
        assert main.main([*argv, "--exp_dir", str(exp_dir)]) == 0
    finally:
        monkeypatch.setattr(loop, "run_training", run_training)
    recs = [json.loads(l) for l in (exp_dir / "log.metrics.jsonl").read_text().splitlines()]
    return ([r for r in recs if "val_loss" in r],
            next((r for r in recs if r.get("split") == "test"), None))


def autosave_steps(nb, seg, niter, epochs):
    """The global steps the autosaves fall on: at the end of a segment of
    ``seg`` steps (``pick_segment``; an epoch of ``nb`` steps ends one) once
    ``niter`` steps have passed since the last."""
    saves, step, last = [], 0, 0
    for _ in range(epochs):
        for lo in range(0, nb, seg):
            step += min(seg, nb - lo)
            if step - last >= niter:
                saves.append(step)
                last = step
    return saves


CASES = {
    # (CLI, flags, autosave_niter, steps before the stop); text: 4 batches of
    # 8, image: 3 batches of 8; each stop lands in epoch 1 after an autosave
    "text_plain": (cli_text, ["--aggressive", "0"], 3, 7),
    "text_aggressive": (cli_text, ["--aggressive", "1"], 3, 7),
    "image": (cli_image, ["--aggressive", "1"], 2, 5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_killed_and_resumed_equals_uninterrupted(tmp_path, monkeypatch, case):
    main, flags, niter, stop = CASES[case]
    if main is cli_text:
        data = _text_files(tmp_path)
        common = ["--dataset", "yahoo", *(f"--{k}={v}" for k, v in SMALL.items()), "--lr", "0.5",
                  "--momentum", "0.5", "--log_niter", "2", *data]
    else:
        monkeypatch.setitem(DATASET_CONFIGS, "omniglot",
                            DATASET_CONFIGS["omniglot"].replace(**IMAGE_SMALL))
        rng = np.random.RandomState(0)
        np.savez(tmp_path / "omni.npz", **{k: (rng.rand(n, 28, 28, 1) ** 3).astype(np.float32)
                                           for k, n in (("train", 24), ("val", 8), ("test", 8))})
        common = ["--dataset", "omniglot", "--train_data", str(tmp_path / "omni.npz")]
    common += ["--device", "cpu", "--batch_size", "8", "--iw_nsamples", "4", "--iw_batch", "2",
               "--warm_up", "1", "--epochs", "3", "--autosave_niter", str(niter), *flags]

    full, full_res = _run_cli(main, [*common, "--save_path", str(tmp_path / "full.ckpt")],
                              tmp_path / "full", monkeypatch)
    ck = tmp_path / "run.ckpt"
    _, none = _run_cli(main, [*common, "--save_path", str(ck)], tmp_path / "first",
                       monkeypatch, stop=stop)
    assert none is None
    _, extra = load_checkpoint(str(ck) + ".auto")
    mid = extra["mid_epoch"]
    assert mid["epoch"] == 1 and 0 < mid["next_start"] < mid["num_batches"]
    seg = min(niter, mid["num_batches"])  # pick_segment: the auto default capped by niter
    saves = autosave_steps(mid["num_batches"], seg, niter, 3)
    assert mid["seg"] == seg and mid["next_start"] % seg == 0
    assert mid["global_step"] == max(s for s in saves if s <= stop)
    assert loop.NOISE_STATE_KEY in extra
    assert sum(m["autosaves"] for m in full) == len(saves)
    assert all(m["autosave_seconds"] >= 0 for m in full)
    resumed, res = _run_cli(main, [*common, "--save_path", str(ck), "--resume", "--load_path",
                                   str(ck) + ".auto"], tmp_path / "resumed", monkeypatch)
    assert [m["epoch"] for m in resumed] == [1, 2]
    for got, want in zip(resumed, full[1:]):
        for k in ("train_loss", "val_loss", "val_kl", "kl_weight", "lr", "inner_iters",
                  "aggressive"):
            assert got[k] == want[k], (k, got[k], want[k])
    for k in ("elbo_loss", "rec", "kl", "mi", "au", "iw_nll"):
        assert res[k] == full_res[k], (k, res[k], full_res[k])
    pf, pr = (from_jax_params(load_checkpoint(str(p))[0]) for p in (tmp_path / "full.ckpt", ck))
    assert pf.keys() == pr.keys()
    for k in pf:
        np.testing.assert_array_equal(pr[k].numpy(), pf[k].numpy(), err_msg=k)


# ------------------------------------------------ killed-and-resumed, vs JAX
OVER = dict(ni=16, enc_nh=24, dec_nh=24, nz=6, batch_size=8, use_pallas=True,
            dec_dropout_in=0.2, dec_dropout_out=0.2, warm_up=1, kl_start=0.1, lr=1.5,
            clip_grad=5.0, burn_max_iters=12, burn_window=3, length_buckets=(16,), epochs=3,
            decay_epoch=1, max_decay=2, aggressive=True, test_nepoch=0, iw_nsamples=10,
            iw_batch=5, seed=5, epoch_segment=2, autosave_niter=2)
SEG, STOP_SEGMENTS = 2, 5  # 8 batches an epoch: the stop is epoch 1 after its first segment


def segmented_noise_for(seed, seg):
    """``jax_noise_for`` with the training keys of ``--epoch_segment seg``:
    segment ``s`` of an epoch starts its step chain from ``fold_in(fold_in(
    PRNGKey(seed), epoch), s)``."""
    master, base = jax.random.PRNGKey(seed), jax_noise_for(seed)

    def train_noise(epoch):
        chains, inner = {}, {}

        def step_keys(i):  # (carry, k_inner, k_loss) of outer step i
            s, j = divmod(i, seg)
            chain = chains.setdefault(s, [])
            while len(chain) <= j:
                chain.append(jax.random.split(chain[-1][0] if chain else jax.random.fold_in(
                    jax.random.fold_in(master, epoch), s), 3))
            return chain[j]

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
            return loss_draw(k_loss)(site, shape)

        return noise

    return lambda stage, epoch: train_noise(epoch) if stage == "train" else base(stage, epoch)


def _write_split_files(d):
    sents, _ = generate_synthetic_corpus(num_sentences=96, vocab_size=20, min_len=4,
                                         max_len=12, seed=42)
    for split, ss in (("train", sents[:64]), ("valid", sents[64:80]), ("test", sents[80:])):
        (d / f"{split}.txt").write_text("".join(f"0\t{' '.join(s)}\n" for s in ss))
    return dict(train_data=str(d / "train.txt"), val_data=str(d / "valid.txt"),
                test_data=str(d / "test.txt"))


@pytest.fixture(scope="module")
def jax_killed_and_resumed(tmp_path_factory):
    """The JAX package's run stopped after STOP_SEGMENTS segments and resumed
    from its autosave: (files, init params, autosave extra, autosave params,
    resumed results, log, best-checkpoint path)."""
    d = tmp_path_factory.mktemp("jax_run")
    files = _write_split_files(d)
    cfg = jax_get_config("synthetic", **OVER, **files, save_path=str(d / "jax.ckpt"))
    train = JaxText(cfg.train_data, label=True)
    pool = lambda f: JaxPool(JaxText(f, label=True, vocab=train.vocab)
                             .create_data_batch(cfg.batch_size, cfg.length_buckets))
    vae = jax_build(cfg, len(train.vocab))
    params = jax.device_get(vae.init(jax.random.PRNGKey(7)))
    r = jax_run_training(cfg, vae, jax.tree.map(jnp.asarray, params), pool(cfg.train_data),
                         pool(cfg.val_data), pool(cfg.test_data), _Capture(),
                         _stop_after_segments=STOP_SEGMENTS)
    assert r["interrupted"] and r["autosave_taken"]
    auto_params, extra = jax_load(r["autosave_path"])
    log = _Capture()
    res = jax_run_training(cfg, vae, jax.tree.map(jnp.asarray, auto_params), pool(cfg.train_data),
                           pool(cfg.val_data), pool(cfg.test_data), log, resume_state=extra)
    return files, params, extra, auto_params, res, log, str(d / "jax.ckpt")


def _port_pools(cfg):
    train = MonoTextData(cfg.train_data, label=True)
    pool = lambda f: BucketedPool(MonoTextData(f, label=True, vocab=train.vocab)
                                  .create_data_batch(cfg.batch_size, cfg.length_buckets), "cpu")
    return len(train.vocab), pool(cfg.train_data), pool(cfg.val_data), pool(cfg.test_data)


def test_killed_and_resumed_matches_jax(tmp_path, jax_killed_and_resumed):
    files, params, jextra, _, want, jlog, jck = jax_killed_and_resumed
    cfg = get_config("synthetic", **OVER, **files, save_path=str(tmp_path / "port.ckpt"))
    nv, tr, va, te = _port_pools(cfg)
    vae = build_text_vae(cfg, nv, device="cpu")
    vae.load_state_dict(from_jax_params(params))
    noise_for = segmented_noise_for(cfg.seed, SEG)
    r = run_training(cfg, vae, tr, va, te, _Capture(), noise_for=noise_for,
                     _stop_after_steps=STOP_SEGMENTS * SEG)
    assert r["interrupted"] and r["autosave_taken"]
    auto, extra = load_checkpoint(r["autosave_path"])
    mid, jmid = extra["mid_epoch"], jextra["mid_epoch"]
    for k in ("epoch", "next_start", "global_step", "inner_iters", "num_batches", "seed"):
        assert mid[k] == jmid[k], (k, mid[k], jmid[k])
    np.testing.assert_allclose(mid["sums"], jmid["sums"], rtol=TRAJ_LOSS_RTOL)
    vae.load_state_dict(from_jax_params(auto))
    log = _Capture()
    got = run_training(cfg, vae, tr, va, te, log, resume_state=extra, noise_for=noise_for)
    epochs, epochs_j = ([m for m in l.metrics if "val_loss" in m] for l in (log, jlog))
    assert [m["epoch"] for m in epochs] == [m["epoch"] for m in epochs_j] == [1, 2]
    for m, mj in zip(epochs, epochs_j):
        assert (m["inner_iters"], m["aggressive"], m["lr"]) == \
            (mj["inner_iters"], mj["aggressive"], mj["lr"]), (m, mj)
        for k in ("train_loss", "val_loss", "kl_weight"):
            np.testing.assert_allclose(m[k], mj[k], rtol=TRAJ_LOSS_RTOL, err_msg=k)
    for k in ("elbo_loss", "rec", "iw_nll", "best_val_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=TRAJ_LOSS_RTOL, err_msg=k)
    assert got["au"] == want["au"]
    fj, fp = _flat(jax_load(jck)[0]), _flat(load_checkpoint(cfg.save_path)[0])
    worst = max(float(np.abs(fj[k] - fp[k]).max()) for k in fj)
    assert worst < TRAJ_PARAM_ATOL, worst


def test_port_reads_jax_autosave(tmp_path, monkeypatch, jax_killed_and_resumed):
    files, _, jextra, auto, _, _, jck = jax_killed_and_resumed
    jmid = jextra["mid_epoch"]
    # a best-val checkpoint must exist (the JAX run's, written after epoch 0)
    cfg = get_config("synthetic", **OVER, **files, save_path=str(tmp_path / "best.ckpt"))
    shutil.copy(jck, cfg.save_path)
    seen = []
    make = loop.make_train_epoch

    def spy(*a, **k):
        epoch_fn, opt_init = make(*a, **k)

        def wrapped(*ea, **ek):
            seen.append((ek["start"], None if ek["sums"] is None else list(ek["sums"]),
                         ek["inner_iters"]))
            return epoch_fn(*ea, **ek)
        wrapped.steps = epoch_fn.steps
        return wrapped, opt_init

    monkeypatch.setattr(loop, "make_train_epoch", spy)
    nv, tr, va, te = _port_pools(cfg)
    vae = build_text_vae(cfg, nv, device="cpu")
    vae.load_state_dict(from_jax_params(auto))
    log = _Capture()
    res = run_training(cfg, vae, tr, va, te, log, resume_state=jextra)
    assert seen[0] == (jmid["next_start"], [float(x) for x in jmid["sums"]],
                       jmid["inner_iters"])
    assert all(s[0] == 0 for s in seen[1:])  # later epochs from their start
    assert any(f"from epoch {jmid['epoch']} step {jmid['global_step']}" in l for l in log.lines)
    assert any("on this run's own draws" in l for l in log.lines)
    assert [m["epoch"] for m in log.metrics if "val_loss" in m][0] == jmid["epoch"]
    assert np.isfinite(res["iw_nll"])


@pytest.mark.parametrize("change", ["seed", "num_batches", "best_checkpoint"])
def test_mismatched_autosave_is_refused(tmp_path, monkeypatch, change):
    data = _text_files(tmp_path)
    common = ["--dataset", "yahoo", *(f"--{k}={v}" for k, v in SMALL.items()), "--device", "cpu",
              "--batch_size", "8", "--iw_nsamples", "4", "--iw_batch", "2", "--warm_up", "1",
              "--epochs", "2", "--autosave_niter", "2", *data]
    ck = tmp_path / "run.ckpt"
    _run_cli(cli_text, [*common, "--save_path", str(ck)], tmp_path / "first", monkeypatch, stop=7)
    assert load_checkpoint(str(ck) + ".auto")[1]["mid_epoch"]["epoch"] == 1
    resume = [*common, "--resume", "--load_path", str(ck) + ".auto", "--exp_dir",
              str(tmp_path / "resumed"), "--save_path", str(ck)]
    if change == "seed":
        resume += ["--seed", "6"]
        match = "--seed 783435 but this run uses --seed 6"
    elif change == "num_batches":
        lines = (tmp_path / "train.txt").read_text().splitlines()[:20]
        (tmp_path / "short.txt").write_text("\n".join(lines) + "\n")
        resume += ["--train_data", str(tmp_path / "short.txt")]
        match = "expects 4 train batches but the pool has 3"
    else:
        ck.unlink()
        match = "best-val checkpoint"
    with pytest.raises(SystemExit, match=match):
        cli_text.main(resume)


# ------------------------------------------------ training above iw_chunk
V, NI, NH, NZ, B, T = 1100, 16, 128, 4, 4, 8
DROP_IN, DROP_OUT = 0.3, 0.4


def _batch(seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(4, V, (B, T)).astype(np.int32)
    lens = rng.randint(3, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    return np.where(mask > 0, tokens, 0).astype(np.int32), mask


def chunk_draw(key, n_chunks):
    """The per-chunk dropout draws of the JAX decoder's chunked training:
    chunk ``c`` splits ``split(key, n_chunks)[c]`` into (key_in, key_out)."""
    keys = jax.random.split(key, n_chunks)

    def draw(site, shape):
        c = int(site.lstrip("keep_inout"))
        k_in, k_out = jax.random.split(keys[c])
        return _t(jax.random.uniform(k_in if site.startswith("keep_in") else k_out, shape,
                                     jnp.float32))

    return draw


def jax_lstm_reference(xw, mask, wh, h0, c0):
    """``lstm_seq_fused``'s plain reference (tests/test_pallas.py::scan_oracle
    with the kernel's operand rule: h cast to wh's type, f32 accumulation)."""
    def step(carry, inp):
        h, c = carry
        xw_t, m_t = inp
        a = xw_t + jax.lax.dot_general(h.astype(wh.dtype), wh, (((1,), (0,)), ((), ())),
                                       preferred_element_type=jnp.float32)
        i, f, g, o = jnp.split(a, 4, axis=-1)
        c_raw = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h_raw = jax.nn.sigmoid(o) * jnp.tanh(c_raw)
        m = m_t[:, None]
        h_k, c_k = m * h_raw + (1 - m) * h, m * c_raw + (1 - m) * c
        return (h_k, c_k), h_k

    (hT, cT), hs = jax.lax.scan(step, (h0, c0), (xw, mask))
    return hs, hT, cT


@jax.custom_vjp
def _ce_plain(h, w, targets):
    return _ce_plain_fwd(h, w, targets)[0]


def _ce_plain_fwd(h, w, targets):
    """The CE kernel's forward in plain jnp: bf16 operands, f32 logits;
    logp from them, and the spill (bf16 logits) with its logsumexp."""
    logits = jax.lax.dot_general(h.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                                 (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
    logp = (jnp.take_along_axis(logits, targets[:, None], 1)[:, 0]
            - jax.nn.logsumexp(logits, axis=-1))
    spill = logits.astype(jnp.bfloat16)
    lse = jax.nn.logsumexp(spill.astype(jnp.float32), axis=-1)
    return logp, (h, w, targets, lse, spill)


_ce_plain.defvjp(_ce_plain_fwd, lambda res, g: jax_ce_pallas._fused_ce_bwd(
    None, None, jnp.bfloat16, None, res, g))


def jax_ce_reference(h, w, targets, **_):
    """``fused_ce_logp`` with its Pallas forward replaced by the plain
    version above and the JAX package's own backward (``_fused_ce_bwd``)."""
    return _ce_plain(h, w, targets)


@pytest.mark.parametrize("K", [25, 40])
@pytest.mark.parametrize("kernel_route", [False, True])
def test_chunked_training_matches_jax(kernel_route, K, monkeypatch):
    """On the kernel route the JAX side runs its Pallas kernels' plain
    references: ``jax.checkpoint`` cannot rematerialize the interpret
    mode's callbacks, so the chunked path does not run there in interpret
    mode. Tolerances: the one-step check's (tests/test_torch_port_train.py)."""
    if kernel_route:
        monkeypatch.setattr(jax_lstm_pallas, "lstm_seq_fused", jax_lstm_reference)
        monkeypatch.setattr(jax_dec_lstm, "fused_ce_logp", jax_ce_reference)
    tokens, mask = _batch(K)
    rng = np.random.RandomState(K + 1)
    z = rng.randn(B, K, NZ).astype(np.float32)
    w = rng.rand(B, K).astype(np.float32)
    key = jax.random.PRNGKey(K)
    dec = LSTMDecoder(V, NI, NH, NZ, dropout_in=DROP_IN, dropout_out=DROP_OUT,
                      kernel_route=kernel_route)
    assert dec.iw_chunk == (20 if kernel_route else 10) < K
    jdec = JaxDecoder(V, NI, NH, NZ, dropout_in=DROP_IN, dropout_out=DROP_OUT,
                      backend="pallas" if kernel_route else "scan", iw_chunk=dec.iw_chunk)
    params = jax.device_get(jdec.init(jax.random.PRNGKey(2)))

    def loss(p, zz):
        rec = jdec.reconstruct_error(p, jnp.asarray(tokens), jnp.asarray(mask), zz,
                                     key=key, train=True)
        return jnp.sum(rec * w), rec

    with pltpu.force_tpu_interpret_mode():  # the Pallas routes stay taken
        (lj, recj), (gj, gzj) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(z))
    lj, recj, gj, gzj = jax.device_get((lj, recj, gj, gzj))
    dec.load_state_dict(from_jax_params(params))
    zt = torch.from_numpy(z).requires_grad_()
    rec = dec.reconstruct_error(torch.from_numpy(tokens).long(), torch.from_numpy(mask), zt,
                                draw=chunk_draw(key, -(-K // dec.iw_chunk)))
    l = torch.sum(rec * torch.from_numpy(w))
    l.backward()
    assert rec.shape == (B, K)
    np.testing.assert_allclose(float(l.detach()), float(lj), rtol=STEP_RTOL)
    np.testing.assert_allclose(rec.detach().numpy(), recj, atol=STEP_ATOL, rtol=STEP_RTOL)
    np.testing.assert_allclose(zt.grad.numpy(), gzj, atol=STEP_ATOL, rtol=STEP_RTOL)
    want = _flat(gj)
    got = {k: p.grad.numpy() for k, p in dec.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=STEP_ATOL, rtol=STEP_RTOL, err_msg=k)


def _tiny_dec(dropout, chunk, seed=3):
    dec = LSTMDecoder(30, 6, 8, 2, dropout_in=dropout, dropout_out=dropout)
    dec.reset_parameters(torch.Generator().manual_seed(seed))
    dec.iw_chunk = chunk
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(4, 30, (3, 7))).long()
    mask = torch.ones(3, 7)
    mask[2, 5:] = 0
    return dec, tokens, mask


# the chunked and the unchunked forward sum the same per-sample terms: equal
# up to the order of f32 reductions over rows (measured exact on this CPU)
CHUNK_ATOL = 1e-5


@pytest.mark.parametrize("train", [False, True])
def test_chunked_equals_unchunked_without_dropout(train):
    dec, tokens, mask = _tiny_dec(0.0, 3)
    z = torch.from_numpy(np.random.RandomState(6).randn(3, 10, 2).astype(np.float32))
    draw = (lambda site, shape: pytest.fail(f"drew {site} at dropout 0")) if train else None
    outs = []
    for chunk in (3, 100):  # K 10 > 3: four chunks, the last padded
        dec.iw_chunk = chunk
        dec.zero_grad()
        rec = dec.reconstruct_error(tokens, mask, z, draw=draw)
        rec.sum().backward()
        outs.append((rec.detach(), {k: p.grad.clone() for k, p in dec.named_parameters()}))
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(), atol=CHUNK_ATOL)
    for k in outs[0][1]:
        np.testing.assert_allclose(outs[0][1][k].numpy(), outs[1][1][k].numpy(), atol=CHUNK_ATOL,
                                   err_msg=k)


def test_chunked_dropout_masks_differ_per_chunk():
    dec, tokens, mask = _tiny_dec(0.5, 2)
    z = torch.from_numpy(np.repeat(np.random.RandomState(11).randn(3, 1, 2), 6, axis=1)
                         .astype(np.float32))  # the same z in all three chunks
    noise = GeneratorNoise(9, "cpu")
    sites = []

    def draw(site, shape):
        sites.append(site)
        return noise(0, site, shape)

    with torch.no_grad():
        chunks = dec.reconstruct_error(tokens, mask, z, draw=draw).reshape(3, 3, 2).numpy()
    assert sites == ["keep_in0", "keep_out0", "keep_in1", "keep_out1", "keep_in2", "keep_out2"]
    assert not np.allclose(chunks[:, 0], chunks[:, 1]), "chunks 0 and 1 share dropout masks"
    assert not np.allclose(chunks[:, 1], chunks[:, 2]), "chunks 1 and 2 share dropout masks"
    with torch.no_grad():  # evaluation (no dropout) stays chunk-invariant
        rec = dec.reconstruct_error(tokens, mask, z).numpy()
    np.testing.assert_allclose(rec, np.broadcast_to(rec[:, :1], rec.shape), atol=CHUNK_ATOL)


def test_checkpointed_gradients_equal_plain(monkeypatch):
    """The checkpoint's recompute sees the masks drawn before it: the same
    gradients (bit for bit on the CPU) as the chunks without checkpoint."""
    dec, tokens, mask = _tiny_dec(0.4, 2)
    z = torch.from_numpy(np.random.RandomState(12).randn(3, 5, 2).astype(np.float32))
    draws = {}

    def draw(site, shape):
        if site not in draws:
            draws[site] = torch.rand(shape, generator=torch.Generator().manual_seed(len(draws)))
        return draws[site]

    def grads():
        dec.zero_grad()
        zz = z.clone().requires_grad_()
        dec.reconstruct_error(tokens, mask, zz, draw=draw).pow(2).sum().backward()
        return [zz.grad] + [p.grad.clone() for p in dec.parameters()]

    with_ckpt = grads()
    calls = []

    def no_checkpoint(fn, *args, **kw):
        calls.append(kw)
        return fn(*args)

    monkeypatch.setattr(dec_lstm, "checkpoint", no_checkpoint)
    plain = grads()
    assert len(calls) == 3 and all(c["use_reentrant"] is False for c in calls)
    for a, b in zip(with_ckpt, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
