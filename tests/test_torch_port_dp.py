"""The port's data parallelism (parallel/dp.py, parallel/launch.py and the
``mesh`` paths of train/) against the JAX package's and against the port's
single-process oracle.

Ranks are CPU processes over ``gloo``; they import only
tests/torch_port_ranks.py and the port.

- the joint DP step at D 2 against JAX's ``make_dp_train_step`` with
  JAX's per-shard draws handed over (tests/test_parallel.py:24, atol 2e-5);
- the aggressive fused epoch at D 2, text and image, against the port's
  single-process emulated-DP oracle (``emulated_dp_loss`` with each
  shard on its rank's draws): equal inner-iteration counts and KL weight,
  parameters within 1e-5, sums within 1e-5 (test_parallel.py:93, 215);
- the evaluators at D 2 on a pool of 11 batches against one process
  (test_parallel.py:135: 1e-5; MI 1e-4);
- autosave and ``--resume`` under ``--dp_devices 2`` bit for bit equal to
  the uninterrupted run; a resume with another ``--dp_devices`` refused;
- the launcher: a failed rank fails the run (``SystemExit`` keeps its
  message), a hung run ends at its timeout, ``Pool.shard`` keeps each
  rank's rows, and a batch that does not divide is refused before any
  rank starts; an image ``--eval --tp_devices 2`` folds tp into dp.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from test_torch_port_tp import RANK_TIMEOUT, TINY, WIDTHS, _corpus
from test_torch_port_tp import (_eval_batches, _flat, _setup, _trained_params, dp_draws,
                                short_burn)
from vae_lagging_encoder_tpu.config import get_config as jax_get_config
from vae_lagging_encoder_tpu.models import build_image_vae as jax_build_image
from vae_lagging_encoder_tpu.models import build_text_vae as jax_build_text
from vae_lagging_encoder_tpu.parallel import make_dp_train_step as jax_dp_step
from vae_lagging_encoder_tpu.parallel import make_mesh as jax_make_mesh
from vae_lagging_encoder_tpu.parallel import shard_batch as jax_shard_batch
from vae_lagging_encoder_tpu_torch.cli import text as cli_text
from vae_lagging_encoder_tpu_torch.config import get_config
from vae_lagging_encoder_tpu_torch.data import BucketedPool, ImagePool
from vae_lagging_encoder_tpu_torch.data.text import TextBatch
from vae_lagging_encoder_tpu_torch.parallel import (EmulatedNoise, Mesh, emulated_dp_loss,
                                                    run_ranks)
from vae_lagging_encoder_tpu_torch.train import loop
from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
from vae_lagging_encoder_tpu_torch.train.epoch import (GeneratorNoise, make_image_loss_fn,
                                                       make_loss_fn, make_train_epoch)

DP_STEP = (0.3, 9, 1.0, 0.4)  # dropout, seed, kl weight, lr
EPOCH_TEXT = dict(ni=8, enc_nh=16, dec_nh=16, nz=2, dec_dropout_in=0.2, dec_dropout_out=0.2,
                  batch_size=16, warm_up=1, burn_max_iters=4, burn_window=2)
EPOCH_IMAGE = dict(nz=2, enc_layers=(4, 6), dec_layers=2, dec_filters=8, dec_kernel_size=3,
                   batch_size=16, warm_up=1, burn_max_iters=2, burn_window=1, optim="sgd",
                   lr=0.1)
EPOCH_SEED = 21


def _text_epoch_data():
    """The batches (buckets 8, 16 of 16 rows) of a 96-sentence synthetic
    corpus, read by the port's reader, and its vocabulary size."""
    import tempfile

    from vae_lagging_encoder_tpu.data.synthetic import generate_synthetic_corpus
    from vae_lagging_encoder_tpu_torch.data import MonoTextData

    sents, _ = generate_synthetic_corpus(num_sentences=96, vocab_size=20, min_len=4,
                                         max_len=12, seed=5)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/corpus.txt"
        with open(path, "w") as fh:
            fh.write("".join(" ".join(s) + "\n" for s in sents))
        data = MonoTextData(path)
    batches = data.create_data_batch(16, (8, 16))
    return [(b.tokens, b.mask, b.row_weight) for b in batches], len(data.vocab)


def _epoch_params(kind, vocab=None):
    if kind == "text":
        vae = jax_build_text(jax_get_config("synthetic", **EPOCH_TEXT), vocab)
    else:
        vae = jax_build_image(jax_get_config("omniglot", **EPOCH_IMAGE))
    return jax.device_get(vae.init(jax.random.PRNGKey(0)))


def _images():
    return np.random.RandomState(3).rand(64, 28, 28, 1).astype(np.float32)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One start of two ranks: the DP step, the fused epochs (text, image),
    the evaluators at D 2."""
    dropout, seed, klw, lr = DP_STEP
    _, params, batch = _setup(dropout, seed)
    text_data, vocab = _text_epoch_data()
    cases = [("step", dict(mesh_shape=(2, 1), widths=dict(WIDTHS, drop=dropout), params=params,
                           batch=batch, draws=dp_draws(jax.random.PRNGKey(seed + 100), 2),
                           kl_weight=klw, lr=lr, clip=5.0)),
             ("epoch", dict(mesh_shape=(2, 1), cfg_over=EPOCH_TEXT,
                            params=_epoch_params("text", vocab), data=text_data,
                            seed=EPOCH_SEED, vocab=vocab)),
             ("epoch", dict(mesh_shape=(2, 1), cfg_over=EPOCH_IMAGE,
                            params=_epoch_params("image"), data=_images(), seed=EPOCH_SEED,
                            kind="image", lr=0.1)),
             ("evaluators", dict(mesh_shape=(2, 1), widths=WIDTHS, params=_trained_params(),
                                 batches=_eval_batches(7, 11), seed=13, nsamples=10, ns=5))]
    out = run_ranks(ranks.run_cases, 2, "cpu", args=(cases,),
                    workdir=str(tmp_path_factory.mktemp("dp2")), timeout=RANK_TIMEOUT)
    return [o.result for o in out]


def test_dp_step_matches_jax(two_ranks):
    dropout, seed, klw, lr = DP_STEP
    vae, params, (tokens, mask, rw) = _setup(dropout, seed)
    mesh = jax_make_mesh(2)
    step = jax_dp_step(vae, type("C", (), dict(nsamples=1, clip_grad=5.0)), mesh)
    new_p, aux = step(jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(seed + 100),
                      *jax_shard_batch(mesh, tokens, mask, rw), jnp.float32(klw),
                      jnp.float32(lr))
    want = _flat(jax.device_get(new_p))
    for r in two_ranks:
        np.testing.assert_allclose(r[0]["aux"], [float(a) for a in aux], rtol=1e-5, atol=2e-5)
        got = _flat(r[0]["params"])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=k)


def _oracle_epoch(kind):
    """The port's single-process emulated-DP oracle of ``case_epoch``."""
    if kind == "text":
        data, vocab = _text_epoch_data()
        cfg = get_config("synthetic", **EPOCH_TEXT)
        vae = ranks.text_vae(dict(vocab=vocab, ni=cfg.ni, nh=cfg.enc_nh, nz=cfg.nz,
                                  drop=cfg.dec_dropout_in), _epoch_params("text", vocab))
        pool = BucketedPool([TextBatch(*b) for b in data], "cpu")
        loss_fn, lr = make_loss_fn(vae, nsamples=1, train=True), 0.3
    else:
        cfg = get_config("omniglot", **EPOCH_IMAGE)
        vae = ranks.image_vae(EPOCH_IMAGE, _epoch_params("image"))
        pool = ImagePool(_images(), cfg.batch_size, "cpu")
        loss_fn, lr = make_image_loss_fn(vae, nsamples=1, train=True), 0.1
    epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=emulated_dp_loss(loss_fn, 2))
    noise = EmulatedNoise([GeneratorNoise(EPOCH_SEED, "cpu", d) for d in range(2)])
    _, klw, sums, inner = epoch_fn(opt_init(), noise, np.float32(0.5), lr,
                                   np.arange(pool.num_batches), True)
    return (ranks.to_jax_params(vae.state_dict()), sums.tolist(), int(inner), float(klw))


@pytest.mark.parametrize("kind,case", [("text", 1), ("image", 2)])
def test_dp_fused_epoch_matches_emulated_oracle(kind, case, two_ranks):
    params, sums, inner, klw = _oracle_epoch(kind)
    assert inner > 0
    for r in two_ranks:
        got = r[case]
        assert got["inner"] == inner and got["kl_weight"] == klw
        np.testing.assert_allclose(got["sums"], sums, rtol=1e-5, atol=1e-6)
        want, have = _flat(params), _flat(got["params"])
        for k in want:
            np.testing.assert_allclose(have[k], want[k], atol=1e-5, err_msg=k)


def test_dp_evaluators_match_one_process(two_ranks):
    want = ranks.case_evaluators("cpu", None, widths=WIDTHS, params=_trained_params(),
                                 batches=_eval_batches(7, 11), seed=13, nsamples=10, ns=5)
    for r in two_ranks:
        got = r[3]
        for k in want["ev"]:
            assert got["ev"][k] == pytest.approx(want["ev"][k], rel=1e-5), k
        assert got["mi"] == pytest.approx(want["mi"], rel=1e-4, abs=1e-6)
        assert got["au"] == want["au"]
        np.testing.assert_allclose(got["var"], want["var"], rtol=1e-5)
        assert got["iw"]["nll"] == pytest.approx(want["iw"]["nll"], rel=1e-5)
        assert got["iw"]["ppl"] == pytest.approx(want["iw"]["ppl"], rel=1e-4)


def test_dp_autosave_resume_is_exact(tmp_path, monkeypatch):
    """``--dp_devices 2 --autosave_niter 3``: stopped after 5 steps (the last
    autosave 2 steps behind) and resumed from ``<save_path>.auto``, the run
    ends where the uninterrupted run ends: parameters and results equal,
    bit for bit. The autosave holds both dp ranks' noise states; a resume
    under another ``--dp_devices`` is refused."""
    short_burn(monkeypatch)
    files = _corpus(tmp_path, 130, 6)
    common = TINY + files + ["--epochs", "1", "--aggressive", "1", "--dec_dropout_in", "0.3",
                             "--dec_dropout_out", "0.3", "--dp_devices", "2",
                             "--autosave_niter", "3"]
    full, part = str(tmp_path / "full.ckpt"), str(tmp_path / "part.ckpt")
    assert cli_text.main(common + ["--save_path", full, "--exp_dir", str(tmp_path / "f")]) == 0
    monkeypatch.setattr(loop, "run_training",
                        functools.partial(loop.run_training, _stop_after_steps=5))
    assert cli_text.main(common + ["--save_path", part, "--exp_dir", str(tmp_path / "p")]) == 0
    monkeypatch.setattr(loop, "run_training", loop.run_training.func)
    auto = load_checkpoint(part + ".auto")[1]
    assert np.asarray(auto["torch_noise_state"]["device"]).shape[0] == 2
    assert auto["mid_epoch"]["global_step"] == 3
    with pytest.raises(SystemExit, match="dp ranks"):
        cli_text.main(TINY + files + ["--epochs", "1", "--aggressive", "1", "--autosave_niter",
                                      "3", "--save_path", part, "--resume", "--load_path",
                                      part + ".auto", "--exp_dir", str(tmp_path / "r1")])
    assert cli_text.main(common + ["--save_path", part, "--resume", "--load_path",
                                   part + ".auto", "--exp_dir", str(tmp_path / "r")]) == 0
    a, b = [load_checkpoint(p)[0] for p in (full, part)]
    for k, v in _flat(a).items():
        np.testing.assert_array_equal(_flat(b)[k], v, err_msg=k)
    final = [next(r for r in (json.loads(l) for l in (tmp_path / n / "log.metrics.jsonl")
                              .read_text().splitlines()) if r.get("split") == "test")
             for n in ("f", "r")]
    for k in ("elbo_loss", "rec", "kl", "mi", "au", "iw_nll"):
        assert final[0][k] == final[1][k], k


def _mesh(dp, d):
    return Mesh(dp=dp, tp=1, rank=d, dp_index=d, tp_index=0, dp_group=None, tp_group=None,
                device=torch.device("cpu"))


def test_pool_shard_keeps_each_ranks_rows():
    data, _ = _text_epoch_data()
    whole = BucketedPool([TextBatch(*b) for b in data], "cpu")
    for d in range(2):
        pool = BucketedPool([TextBatch(*b) for b in data], "cpu").shard(_mesh(2, d))
        assert pool.num_batches == whole.num_batches
        for i in range(whole.num_batches):
            for got, full in zip(pool.batch(i), whole.batch(i)):
                torch.testing.assert_close(got, full[d * 8:(d + 1) * 8], rtol=0, atol=0)


def test_failed_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks(ranks.fail_on_rank, 2, "cpu", args=(1, "error"),
                  workdir=str(tmp_path / "a"), timeout=RANK_TIMEOUT)
    with pytest.raises(SystemExit, match="refused on rank 1"):
        run_ranks(ranks.fail_on_rank, 2, "cpu", args=(1, "exit"),
                  workdir=str(tmp_path / "b"), timeout=RANK_TIMEOUT)
    with pytest.raises(TimeoutError):
        run_ranks(ranks.fail_on_rank, 2, "cpu", args=(1, "hang"),
                  workdir=str(tmp_path / "c"), timeout=5)


def test_cli_image_eval_folds_tp_into_dp(tmp_path, monkeypatch):
    """A standalone image ``--eval --tp_devices 2``: the image model has no
    vocabulary to shard, so the two ranks split the test batches as dp
    ranks (the JAX package's fold); the results are one process's, the sums
    in another order."""
    from vae_lagging_encoder_tpu_torch.cli import image as cli_image
    from vae_lagging_encoder_tpu_torch.config import DATASET_CONFIGS

    monkeypatch.setitem(DATASET_CONFIGS, "omniglot", DATASET_CONFIGS["omniglot"].replace(
        nz=3, enc_layers=(4, 4), dec_layers=2, dec_filters=4, dec_kernel_size=5))
    rng = np.random.RandomState(2)
    np.savez(tmp_path / "omni.npz", **{k: (rng.rand(n, 28, 28, 1) ** 3).astype(np.float32)
                                       for k, n in (("train", 16), ("val", 8), ("test", 24))})
    common = ["--dataset", "omniglot", "--device", "cpu", "--train_data",
              str(tmp_path / "omni.npz"), "--batch_size", "8", "--iw_nsamples", "4",
              "--iw_batch", "2", "--eval"]
    results = {}
    for tag, extra in (("one", []), ("folded", ["--tp_devices", "2"])):
        assert cli_image.main(common + extra + ["--exp_dir", str(tmp_path / tag)]) == 0
        recs = [json.loads(l) for l in (tmp_path / tag / "log.metrics.jsonl").read_text()
                .splitlines()]
        results[tag] = next(r for r in recs if r.get("split") == "test")
    assert "folding --tp_devices 2" in (tmp_path / "folded" / "log.txt").read_text()
    for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "iw_ppl"):
        assert results["folded"][k] == pytest.approx(results["one"][k], rel=1e-5), k
    assert results["folded"]["au"] == results["one"]["au"]


def test_batch_not_divisible_is_refused_before_spawning(tmp_path):
    files = _corpus(tmp_path, 52, 1)
    with pytest.raises(SystemExit, match="divisible by --dp_devices 3"):
        cli_text.main(TINY + files + ["--dp_devices", "3", "--exp_dir", str(tmp_path / "e")])
