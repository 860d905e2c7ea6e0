"""``--epoch_segment`` and ``--loop_unroll`` in the port, and the training
step as a static step (train/graphs.py).

- ``pick_segment`` equals the JAX package's on every combination of
  ``epoch_segment``, ``log_niter``, ``autosave_niter`` and the aggressive
  flag; both CLIs parse the two flags to the JAX CLI's config values.
- The static-step epoch equals the epoch loop it replaced (kept below as
  ``old_epoch``, with the out-of-place optimizer updates ``old_optimizer``)
  bit for bit: parameters, optimizer state, KL weight, sums and inner
  iterations, for the text VAE (two bucket shapes, dropout, momentum SGD)
  and the image VAE (Adam), plain and aggressive, called eagerly and
  through the graph path with the capture emulated (``graphs.capture``
  returns the steps instead of capturing them: everything but the CUDA
  graph itself runs, the static buffers, the recorded noise sites, the
  live optimizer state and the counts). Segments change nothing but where
  the host reads; ``loop_unroll`` 3 equals 1 on 7 steps, one replay a step
  either way (the counterpart of
  tests/test_train.py::test_epoch_fn_loop_unroll_bit_exact).
- ``run_training`` with ``--epoch_segment`` 2 and 4 (autosave at each
  segment), killed and resumed, against the JAX package's killed-and-
  resumed run on its replayed keys, at tests/test_torch_port_lifecycle.py's
  tolerances; ``mid_epoch["seg"]`` is the real segment, and a resume on
  another segment grid is refused with the JAX package's message.
- The in-place Adam and momentum updates equal the out-of-place ones bit
  for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_lifecycle import (OVER, _port_pools, _write_split_files,
                                       segmented_noise_for)
from test_torch_port_train import TRAJ_LOSS_RTOL, TRAJ_PARAM_ATOL, _Capture, _flat
from vae_lagging_encoder_tpu.cli.common import build_parser as jax_build_parser
from vae_lagging_encoder_tpu.cli.common import config_from_args as jax_config_from_args
from vae_lagging_encoder_tpu.config import get_config as jax_get_config
from vae_lagging_encoder_tpu.data import BucketedPool as JaxPool
from vae_lagging_encoder_tpu.data import MonoTextData as JaxText
from vae_lagging_encoder_tpu.models import build_text_vae as jax_build
from vae_lagging_encoder_tpu.train.checkpoint import load_checkpoint as jax_load
from vae_lagging_encoder_tpu.train.loop import pick_segment as jax_pick_segment
from vae_lagging_encoder_tpu.train.loop import run_training as jax_run_training
from vae_lagging_encoder_tpu_torch.cli import image as cli_image
from vae_lagging_encoder_tpu_torch.cli import text as cli_text
from vae_lagging_encoder_tpu_torch.config import get_config
from vae_lagging_encoder_tpu_torch.data import BucketedPool, ImagePool, MonoTextData
from vae_lagging_encoder_tpu_torch.models import build_image_vae, build_text_vae
from vae_lagging_encoder_tpu_torch.ops.build import GRAPHS, reset_launches
from vae_lagging_encoder_tpu_torch.train import graphs, optim
from vae_lagging_encoder_tpu_torch.train.aggressive import grads_of, make_grad_on
from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
from vae_lagging_encoder_tpu_torch.train.epoch import (GeneratorNoise, make_image_loss_fn,
                                                       make_loss_fn, make_train_epoch)
from vae_lagging_encoder_tpu_torch.train.loop import pick_segment, run_training
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params


# ------------------------------------------------------------ pick_segment
@pytest.mark.parametrize("aggressive", [False, True])
@pytest.mark.parametrize("autosave_niter", [0, 10, 64])
@pytest.mark.parametrize("log_niter", [0, 50])
@pytest.mark.parametrize("epoch_segment", [None, 0, 1, 40, 200])
def test_pick_segment_matches_jax(epoch_segment, log_niter, autosave_niter, aggressive):
    over = dict(epoch_segment=epoch_segment, log_niter=log_niter, autosave_niter=autosave_niter)
    cfg, jcfg = get_config("yahoo", **over), jax_get_config("yahoo", **over)
    for nb in (7, 100, 1000):
        assert pick_segment(cfg, aggressive, nb) == jax_pick_segment(jcfg, aggressive, nb), nb


@pytest.mark.parametrize("argv", [[], ["--epoch_segment", "40", "--loop_unroll", "3"],
                                  ["--epoch_segment", "0", "--loop_unroll", "1"]])
def test_clis_parse_segment_flags_as_jax(argv):
    for cli, dataset in ((cli_text, "yahoo"), (cli_image, "omniglot")):
        cfg, _ = cli.init_config(["--dataset", dataset, *argv])
        want = jax_config_from_args(jax_build_parser(dataset).parse_args(
            ["--dataset", dataset, *argv]))
        assert (cfg.epoch_segment, cfg.loop_unroll) == (want.epoch_segment, want.loop_unroll)


# ------------------------------------------- the epoch loop this replaced
def old_optimizer(name, momentum=0.0, b1=0.9, b2=0.999, eps=1e-8):
    """``train/optim.py::make_optimizer``'s update before it wrote its state
    in place: new state tensors every call."""
    eff = optim._eff_grad
    if name == "sgd" and momentum:
        @torch.no_grad()
        def update_fn(params, grads, state, lr, scale=None, finite=None):
            v = {k: momentum * state["v"][k] + eff(grads[k], scale, finite) for k in params}
            for k, p in params.items():
                p.copy_(p - lr * v[k])
            return {"v": v}
    elif name == "sgd":
        @torch.no_grad()
        def update_fn(params, grads, state, lr, scale=None, finite=None):
            for k, p in params.items():
                p.copy_(p - lr * eff(grads[k], scale, finite))
            return state
    else:
        @torch.no_grad()
        def update_fn(params, grads, state, lr, scale=None, finite=None):
            t = state["t"] + 1
            e = {k: eff(grads[k], scale, finite) for k in params}
            m = {k: b1 * state["m"][k] + (1 - b1) * e[k] for k in params}
            v = {k: b2 * state["v"][k] + (1 - b2) * e[k] * e[k] for k in params}
            tf = t.to(torch.float32)
            mhat_scale = 1.0 / (1.0 - b1 ** tf)
            vhat_scale = 1.0 / (1.0 - b2 ** tf)
            for k, p in params.items():
                p.copy_(p - lr * (m[k] * mhat_scale) / (torch.sqrt(v[k] * vhat_scale) + eps))
            return {"m": m, "v": v, "t": t}
    return update_fn


def old_epoch(vae, pool, cfg, loss_fn, opt_state, noise, kl_weight, lr, order, aggressive):
    """The epoch loop and the aggressive inner loop as they were before the
    static step: every step launched from the host, ``kl_weight`` and ``lr``
    Python floats, the sums a device tensor."""
    grad_on = make_grad_on(vae, loss_fn)
    update = old_optimizer(cfg.optim, cfg.momentum)
    params = dict(vae.named_parameters())
    enc, dec = dict(vae.enc.named_parameters()), dict(vae.dec.named_parameters())
    anneal_rate = np.float32((1.0 - cfg.kl_start) / (cfg.warm_up * pool.num_batches))
    sums, inner_iters = torch.zeros(5), 0
    for i in range(len(order)):
        kl_weight = np.minimum(np.float32(1.0), np.float32(kl_weight) + anneal_rate)
        if aggressive:
            pre, cur, words, sub = float("inf"), torch.zeros(()), torch.zeros(()), 0
            while sub < cfg.burn_max_iters:
                draw = lambda site, shape, i=i, sub=sub: noise((i, sub), site, shape)
                flat = int(draw("pick", (pool.num_batches,)))
                loss_sum, _, _, _, n_words = grad_on(pool.batch(flat), draw, float(kl_weight))
                scale, _, finite = optim.clip_scale(grads_of(params), cfg.clip_grad)
                opt_state = dict(opt_state, enc=update(enc, grads_of(enc), opt_state["enc"], lr,
                                                       scale=scale, finite=finite))
                sub += 1
                cur, words = cur + loss_sum.detach(), words + n_words
                if sub % cfg.burn_window == 0:
                    avg = float(cur / torch.clamp(words, min=1.0))
                    if pre < avg:
                        break
                    pre, cur, words = avg, torch.zeros(()), torch.zeros(())
            inner_iters += sub
        aux = grad_on(pool.batch(int(order[i])), lambda site, shape, i=i: noise(i, site, shape),
                      float(kl_weight))
        scale, _, finite = optim.clip_scale(grads_of(params), cfg.clip_grad)
        for part, ps in (("enc", enc), ("dec", dec)):
            if part == "enc" and aggressive:
                continue
            opt_state = dict(opt_state, **{part: update(ps, grads_of(ps), opt_state[part], lr,
                                                        scale=scale, finite=finite)})
        sums = sums + torch.stack([a.detach() for a in aux])
    return opt_state, kl_weight, sums, inner_iters


TEXT = dict(ni=8, enc_nh=12, dec_nh=12, nz=3, batch_size=4, length_buckets=(8, 16),
            dec_dropout_in=0.2, dec_dropout_out=0.2, burn_max_iters=6, burn_window=2,
            momentum=0.5, lr=0.5, warm_up=1, kl_start=0.1, use_pallas=True)
IMAGE = dict(nz=3, enc_layers=(4, 4), dec_layers=2, dec_filters=4, dec_kernel_size=5,
             batch_size=4, burn_max_iters=4, burn_window=2, warm_up=1, kl_start=0.1)


def _setup(kind, tmp_path, **over):
    """(cfg, pool, make_vae, loss_fn_of): the text model on two bucket
    shapes (7 batches) or the image model (7 batches)."""
    if kind == "text":
        cfg = get_config("synthetic", **TEXT, **over)
        rng = np.random.RandomState(0)
        lines = [" ".join(f"w{j}" for j in rng.randint(0, 20, rng.randint(2, 13)))
                 for _ in range(26)]
        (tmp_path / "train.txt").write_text("".join(f"0\t{l}\n" for l in lines))
        data = MonoTextData(str(tmp_path / "train.txt"), label=True)
        pool = BucketedPool(data.create_data_batch(cfg.batch_size, cfg.length_buckets), "cpu")
        assert len(pool.lengths) == 2
        make_vae = lambda: build_text_vae(cfg, len(data.vocab), device="cpu",
                                          generator=torch.Generator().manual_seed(3))
        loss_of = lambda vae: make_loss_fn(vae, nsamples=1, train=True)
    else:
        cfg = get_config("omniglot", **IMAGE, **over)
        imgs = (np.random.RandomState(1).rand(28, 28, 28, 1) ** 3).astype(np.float32)
        pool = ImagePool(imgs, cfg.batch_size, "cpu")
        make_vae = lambda: build_image_vae(cfg, device="cpu",
                                           generator=torch.Generator().manual_seed(3))
        loss_of = lambda vae: make_image_loss_fn(vae, nsamples=1, train=True)
    assert pool.num_batches == 7
    return cfg, pool, make_vae, loss_of


@pytest.fixture
def emulated_capture(monkeypatch):
    """The graph path on the CPU: ``capture`` hands back the steps it was
    given (run at each replay), and graphs count as on."""
    monkeypatch.setattr(graphs, "capture", lambda fn, mempool: fn)
    monkeypatch.setattr(graphs, "off_reason", lambda dev, mesh, on: None if on else "off")


def _state_equal(a, b):
    la, lb = list(graphs._leaves(a)), list(graphs._leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), path


def _params_equal(a, b):
    for (k, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), k


@pytest.mark.parametrize("path", ["eager", "graphs"])
@pytest.mark.parametrize("aggressive", [False, True])
@pytest.mark.parametrize("kind", ["text", "image"])
def test_static_step_epoch_equals_old_epoch(kind, aggressive, path, tmp_path, request):
    if path == "graphs":
        request.getfixturevalue("emulated_capture")
    cfg, pool, make_vae, loss_of = _setup(kind, tmp_path)
    # aggressive: 3 outer steps, each with its inner loop
    order = np.random.RandomState(2).permutation(pool.num_batches)[:3 if aggressive else None]
    want_vae, vae = make_vae(), make_vae()
    want = old_epoch(want_vae, pool, cfg, loss_of(want_vae),
                     make_train_epoch(want_vae, pool, cfg, loss_fn=loss_of(want_vae))[1](),
                     GeneratorNoise(9, "cpu"), np.float32(cfg.kl_start), cfg.lr, order,
                     aggressive)
    reset_launches()
    epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=loss_of(vae))
    got = epoch_fn(opt_init(), GeneratorNoise(9, "cpu"), np.float32(cfg.kl_start), cfg.lr,
                   order, aggressive)
    _params_equal(vae, want_vae)
    _state_equal(got[0], want[0])
    assert got[1] == want[1] and got[3] == want[3]
    assert got[2].dtype == torch.float64 and got[2].tolist() == want[2].tolist()
    stats = epoch_fn.steps.stats
    steps = len(order) + got[3]
    assert stats["eager_steps"] + stats["graph_steps"] == steps
    if path == "graphs":
        assert epoch_fn.steps.off is None
        # one eager warm-up per (mode, shape) seen; every other step replays
        shapes = {b[0].shape for b in pool}
        assert stats["eager_steps"] <= len(shapes) * (2 if aggressive else 1)
        assert GRAPHS["replays"] == stats["graph_steps"] > 0
        assert 0 < GRAPHS["captured"] <= stats["eager_steps"]
    else:
        assert epoch_fn.steps.off and GRAPHS == {"captured": 0, "replays": 0}
        assert stats["graph_steps"] == 0


@pytest.mark.parametrize("aggressive", [False, True])
def test_segments_change_only_the_reads(aggressive, tmp_path, emulated_capture):
    """seg 3 over 7 steps: three segments, one read each, the same
    parameters as one segment; the sums are the f64 sums of the segments'."""
    cfg, pool, make_vae, loss_of = _setup("text", tmp_path)
    order = np.random.RandomState(4).permutation(pool.num_batches)
    runs = []
    for seg in (None, 3):
        vae = make_vae()
        epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=loss_of(vae))
        seen = []
        out = epoch_fn(opt_init(), GeneratorNoise(5, "cpu"), np.float32(0.1), cfg.lr, order,
                       aggressive, seg=seg, on_segment=lambda *a: seen.append(a))
        runs.append((vae, out, seen))
    (vae1, out1, seen1), (vae3, out3, seen3) = runs
    _params_equal(vae1, vae3)
    _state_equal(out1[0], out3[0])
    assert [(s[0], s[1]) for s in seen1] == [(7, 7)]
    assert [(s[0], s[1]) for s in seen3] == [(3, 3), (6, 3), (7, 1)]
    total = np.zeros(5)
    for s in seen3:
        total = total + np.asarray(s[3], dtype=np.float64)
        assert s[5] == list(total)  # the running sums handed to on_segment
    assert out3[2].tolist() == list(total)
    np.testing.assert_allclose(out3[2].numpy(), out1[2].numpy(), rtol=1e-6)
    assert out1[3] == out3[3] and out1[1] == out3[1]


def test_max_steps_stops_inside_a_segment(tmp_path, emulated_capture):
    cfg, pool, make_vae, loss_of = _setup("image", tmp_path)
    vae = make_vae()
    epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=loss_of(vae))
    seen = []
    epoch_fn(opt_init(), GeneratorNoise(5, "cpu"), np.float32(0.1), cfg.lr,
             np.arange(pool.num_batches), False, seg=3, on_segment=lambda *a: seen.append(a[0]),
             max_steps=5)
    assert seen == [3]  # the stop at step 5 is inside the second segment: no read there
    stats = epoch_fn.steps.stats
    assert stats["eager_steps"] + stats["graph_steps"] == 5


@pytest.mark.parametrize("kind", ["text", "image"])
def test_loop_unroll_is_bit_exact(kind, tmp_path, emulated_capture):
    """loop_unroll 3 on 7 plain steps equals 1: the knob is accepted and
    each step stays one replay."""
    # text: the flat order, 3 batches of one shape then 4 of the other
    order = np.arange(7) if kind == "text" else np.random.RandomState(6).permutation(7)
    runs = {}
    for unroll in (1, 3):
        cfg, pool, make_vae, loss_of = _setup(kind, tmp_path, loop_unroll=unroll)
        vae = make_vae()
        reset_launches()
        epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=loss_of(vae))
        out = epoch_fn(opt_init(), GeneratorNoise(7, "cpu"), np.float32(0.1), cfg.lr, order,
                       False)
        runs[unroll] = (vae, out, dict(GRAPHS), dict(epoch_fn.steps.stats))
    (v1, o1, g1, s1), (v3, o3, g3, s3) = runs[1], runs[3]
    _params_equal(v1, v3)
    _state_equal(o1[0], o3[0])
    assert o1[1] == o3[1] and o1[2].tolist() == o3[2].tolist()
    assert s1["graph_steps"] == s3["graph_steps"] and s1["eager_steps"] == s3["eager_steps"]
    assert g1 == g3 and g1["replays"] == s1["graph_steps"]
    if kind == "image":  # one shape: a warm-up, a capture, then a replay a step
        assert (s3["eager_steps"], g3["replays"], g3["captured"]) == (1, 6, 1)


def test_live_state_takes_a_new_state_in_place(tmp_path, emulated_capture):
    """A rollback's fresh state (or a resume's) is copied into the tensors
    the graphs were captured with."""
    cfg, pool, make_vae, loss_of = _setup("image", tmp_path)
    vae = make_vae()
    epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=loss_of(vae))
    live = epoch_fn(opt_init(), GeneratorNoise(5, "cpu"), np.float32(0.1), cfg.lr,
                    np.arange(3), False)[0]
    addresses = [t.data_ptr() for _, t in graphs._leaves(live)]
    fresh = opt_init()
    out = epoch_fn(fresh, GeneratorNoise(6, "cpu"), np.float32(0.1), cfg.lr, np.arange(1),
                   False)[0]
    assert out is live and [t.data_ptr() for _, t in graphs._leaves(out)] == addresses
    assert int(out["enc"]["t"]) == 1  # the fresh state's count, then one step


# --------------------------------------------------- in-place optimizers
@pytest.mark.parametrize("name,momentum", [("sgd", 0.0), ("sgd", 0.9), ("adam", 0.0)])
def test_in_place_updates_equal_out_of_place(name, momentum):
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,), "c.d": (2, 2, 2)}
    params = {k: torch.from_numpy(rng.randn(*s).astype(np.float32)) for k, s in shapes.items()}
    ref = {k: v.clone() for k, v in params.items()}
    init, update = optim.make_optimizer(name, momentum=momentum)
    old = old_optimizer(name, momentum)
    state, ref_state = init(params), init(ref)
    leaves = [t for _, t in graphs._leaves(state)]
    for step in range(4):
        grads = {k: torch.from_numpy((rng.randn(*s) * 3).astype(np.float32))
                 for k, s in shapes.items()}
        if step == 2:
            grads["b"][1] = float("inf")  # a non-finite norm zeroes the step
        scale, _, finite = optim.clip_scale(grads, 5.0)
        lr = [0.3, torch.tensor(0.3)][step % 2]  # a float or a 0-dim tensor
        out = update(params, grads, state, lr, scale=scale, finite=finite)
        ref_state = old(ref, grads, ref_state, 0.3, scale=scale, finite=finite)
        assert out is state and [t for _, t in graphs._leaves(out)] == leaves
        for k in params:
            assert torch.equal(params[k], ref[k]), (step, k)
        _state_equal(state, ref_state)


# ----------------------------------------- segmented run_training vs JAX
SEG_CASES = {2: 5, 4: 3}  # seg -> JAX segments before the stop (epoch 1, first segment)


@pytest.fixture(scope="module", params=sorted(SEG_CASES))
def jax_segmented(request, tmp_path_factory):
    """The JAX package's run with ``--epoch_segment seg --autosave_niter seg``
    stopped after SEG_CASES[seg] segments and resumed from its autosave."""
    seg = request.param
    d = tmp_path_factory.mktemp(f"jax_seg{seg}")
    files = _write_split_files(d)
    over = dict(OVER, epoch_segment=seg, autosave_niter=seg)
    cfg = jax_get_config("synthetic", **over, **files, save_path=str(d / "jax.ckpt"))
    train = JaxText(cfg.train_data, label=True)
    pool = lambda f: JaxPool(JaxText(f, label=True, vocab=train.vocab)
                             .create_data_batch(cfg.batch_size, cfg.length_buckets))
    vae = jax_build(cfg, len(train.vocab))
    params = jax.device_get(vae.init(jax.random.PRNGKey(7)))
    r = jax_run_training(cfg, vae, jax.tree.map(jnp.asarray, params), pool(cfg.train_data),
                         pool(cfg.val_data), pool(cfg.test_data), _Capture(),
                         _stop_after_segments=SEG_CASES[seg])
    auto_params, extra = jax_load(r["autosave_path"])
    log = _Capture()
    res = jax_run_training(cfg, vae, jax.tree.map(jnp.asarray, auto_params),
                           pool(cfg.train_data), pool(cfg.val_data), pool(cfg.test_data), log,
                           resume_state=extra)
    return seg, over, files, params, extra, res, log, str(d / "jax.ckpt")


def test_segmented_killed_and_resumed_matches_jax(tmp_path, jax_segmented):
    seg, over, files, params, jextra, want, jlog, jck = jax_segmented
    cfg = get_config("synthetic", **over, **files, save_path=str(tmp_path / "port.ckpt"))
    nv, tr, va, te = _port_pools(cfg)
    vae = build_text_vae(cfg, nv, device="cpu")
    vae.load_state_dict(from_jax_params(params))
    noise_for = segmented_noise_for(cfg.seed, seg)
    first = _Capture()
    r = run_training(cfg, vae, tr, va, te, first, noise_for=noise_for,
                     _stop_after_steps=SEG_CASES[seg] * seg)
    assert r["interrupted"]
    auto, extra = load_checkpoint(r["autosave_path"])
    mid, jmid = extra["mid_epoch"], jextra["mid_epoch"]
    for k in ("epoch", "seg", "next_start", "global_step", "inner_iters", "num_batches",
              "steps_since_log"):
        assert mid[k] == jmid[k], (k, mid[k], jmid[k])
    assert mid["seg"] == seg and mid["epoch"] == 1
    np.testing.assert_allclose(mid["sums"], jmid["sums"], rtol=TRAJ_LOSS_RTOL)
    # the logs and autosaves of the first run fall on the segment grid
    saves = [int(l.split()[2]) for l in first.lines if l.startswith("[autosave] step")]
    assert saves == list(range(seg, mid["global_step"] + 1, seg))
    vae.load_state_dict(from_jax_params(auto))
    log = _Capture()
    got = run_training(cfg, vae, tr, va, te, log, resume_state=extra, noise_for=noise_for)
    epochs, epochs_j = ([m for m in l.metrics if "val_loss" in m] for l in (log, jlog))
    assert [m["epoch"] for m in epochs] == [m["epoch"] for m in epochs_j] == [1, 2]
    for m, mj in zip(epochs, epochs_j):
        assert (m["inner_iters"], m["aggressive"], m["lr"]) == \
            (mj["inner_iters"], mj["aggressive"], mj["lr"]), (m, mj)
        assert m["segment"] == seg
        for k in ("train_loss", "val_loss", "kl_weight"):
            np.testing.assert_allclose(m[k], mj[k], rtol=TRAJ_LOSS_RTOL, err_msg=k)
    for k in ("elbo_loss", "rec", "iw_nll", "best_val_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=TRAJ_LOSS_RTOL, err_msg=k)
    fj, fp = _flat(jax_load(jck)[0]), _flat(load_checkpoint(cfg.save_path)[0])
    worst = max(float(np.abs(fj[k] - fp[k]).max()) for k in fj)
    assert worst < TRAJ_PARAM_ATOL, worst


def test_resume_on_another_segment_grid_is_refused_as_jax(tmp_path):
    files = _write_split_files(tmp_path)
    over = dict(OVER, epoch_segment=2, autosave_niter=2, aggressive=False)
    cfg = get_config("synthetic", **over, **files, save_path=str(tmp_path / "port.ckpt"))
    nv, tr, va, te = _port_pools(cfg)
    vae = build_text_vae(cfg, nv, device="cpu")
    r = run_training(cfg, vae, tr, va, te, _Capture(), _stop_after_steps=6)
    auto, extra = load_checkpoint(r["autosave_path"])
    assert (extra["mid_epoch"]["seg"], extra["mid_epoch"]["next_start"]) == (2, 6)
    other = dict(epoch_segment=4, autosave_niter=4)
    with pytest.raises(SystemExit) as port:
        run_training(cfg.replace(**other), build_text_vae(cfg, nv, device="cpu"), tr, va, te,
                     _Capture(), resume_state=extra)
    jcfg = jax_get_config("synthetic", **dict(over, **other), **files,
                          save_path=str(tmp_path / "jax.ckpt"))
    train = JaxText(jcfg.train_data, label=True)
    pool = lambda f: JaxPool(JaxText(f, label=True, vocab=train.vocab)
                             .create_data_batch(jcfg.batch_size, jcfg.length_buckets))
    with pytest.raises(SystemExit) as jax_exit:
        jax_run_training(jcfg, jax_build(jcfg, nv), jax.tree.map(jnp.asarray, auto),
                         pool(jcfg.train_data), pool(jcfg.val_data), pool(jcfg.test_data),
                         _Capture(), resume_state=extra)
    assert str(port.value) == str(jax_exit.value)
    assert "seg=4; autosave was written with seg=2" in str(port.value)
    json.dumps(extra["mid_epoch"])  # the record stays JSON, as the JAX package writes it
