"""The port's tensor parallelism (parallel/tp.py) against the JAX package's.

Ranks are CPU processes over ``gloo`` (parallel/launch.py); the JAX side
runs ``shard_map`` on its 8 emulated CPU devices. The ranks import only
tests/torch_port_ranks.py and the port; the references, weights, batches
and each dp rank's JAX draws are computed here and handed to them.

- ``tp_token_logp`` (the distributed logsumexp) and its hand-written
  backward at T 2 and 4 against JAX's under ``shard_map`` and against the
  port's dense plain CE (tests/test_tp.py:90-93: 1e-6 on the value, 1e-5
  on the gradients);
- the joint train step at (dp, tp) (1, 2) and (2, 2) against JAX's
  ``make_tp_train_step``, dropout on (test_tp.py:96, 114: aux 1e-4,
  parameters 1e-5); the eval step against ``make_tp_eval_step`` (137);
- the guards: a non-finite gradient zeroes the step (157); a vocab that
  does not divide raises (176); tp on the image model is refused (377);
  shard -> gather is bit for bit (397);
- the evaluators at (1, 2) against one process (test_tp.py:286: 1e-5);
- the CLI: ``--dp_devices 2 --tp_devices 2`` against ``--dp_devices 2``
  (test_tp.py:242) and a standalone ``--eval --tp_devices 2`` against one
  process (342).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_port_ranks as ranks
from vae_lagging_encoder_tpu.models import VAE as JaxVAE
from vae_lagging_encoder_tpu.models import GaussianLSTMEncoder as JaxEncoder
from vae_lagging_encoder_tpu.models import LSTMDecoder as JaxDecoder
from vae_lagging_encoder_tpu.parallel import make_tp_eval_step as jax_tp_eval_step
from vae_lagging_encoder_tpu.parallel import make_tp_mesh as jax_tp_mesh
from vae_lagging_encoder_tpu.parallel import make_tp_train_step as jax_tp_train_step
from vae_lagging_encoder_tpu.parallel import shard_params as jax_shard_params
from vae_lagging_encoder_tpu.parallel import tp_token_logp as jax_tp_token_logp
from vae_lagging_encoder_tpu_torch.cli import image as cli_image
from vae_lagging_encoder_tpu_torch.cli import text as cli_text
from vae_lagging_encoder_tpu_torch.config import DATASET_CONFIGS, get_config
from vae_lagging_encoder_tpu_torch.data import ImagePool
from vae_lagging_encoder_tpu_torch.models import build_image_vae
from vae_lagging_encoder_tpu_torch.ops.ce_cuda import ce_logp_plain
from vae_lagging_encoder_tpu_torch.parallel import Mesh, run_ranks, shard_model, tp_token_logp
from vae_lagging_encoder_tpu_torch.parallel.launch import choose_backend
from vae_lagging_encoder_tpu_torch.train.loop import check_layout, run_training
from vae_lagging_encoder_tpu_torch.utils.exp_utils import Logger

V, NI, NH, NZ, B, T = 48, 8, 12, 3, 8, 10
WIDTHS = dict(vocab=V, ni=NI, nh=NH, nz=NZ)
CLIP = 5.0
# a spawned test fails instead of hanging the suite
RANK_TIMEOUT = 240


def _setup(dropout, seed):
    vae = JaxVAE(JaxEncoder(V, NI, NH, NZ),
                 JaxDecoder(V, NI, NH, NZ, dropout_in=dropout, dropout_out=dropout))
    params = jax.device_get(vae.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, V, (B, T)).astype(np.int32)
    mask = (np.arange(T)[None] < rng.randint(4, T + 1, (B, 1))).astype(np.float32)
    rw = np.ones((B,), np.float32)
    return vae, params, (tokens, mask, rw)


def dp_draws(key, dp):
    """Each dp rank's draws of ``vae.loss(..., train=True)`` on its B/dp rows:
    the JAX step folds the dp index into the key, then splits it as
    ``vae.loss`` does (tests/test_torch_port_train.py::loss_draw)."""
    out = []
    b = B // dp
    for d in range(dp):
        k_enc, k_dec = jax.random.split(jax.random.fold_in(key, d))
        k_in, k_out = jax.random.split(k_dec)
        out.append({"eps": np.asarray(jax.random.normal(k_enc, (b, 1, NZ), jnp.float32)),
                    "keep_in": np.asarray(jax.random.uniform(k_in, (b, T - 1, NI))),
                    "keep_out": np.asarray(jax.random.uniform(k_out, (b, T - 1, NH)))})
    return out


def _flat(tree, prefix=""):
    """``name -> array`` of a parameter tree (dicts and lists)."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _logp_inputs():
    rng = np.random.RandomState(1)
    N = 16
    return (rng.randn(N, NH).astype(np.float32), rng.randn(NH, V).astype(np.float32),
            rng.randint(0, V, (N,)).astype(np.int64), rng.randn(N).astype(np.float32))


def _jax_logp(ntp):
    """JAX's value, dh and dpred of sum(tp_token_logp * w) on a 1 x ntp mesh."""
    h, pred, tgt, w = _logp_inputs()
    mesh = jax_tp_mesh(1, ntp)

    def local(h, pred_l, tgt, w):
        def f(h, pred_l):
            return jnp.sum(jax_tp_token_logp(h, pred_l, tgt, V) * w)
        val, (dh, dpred_l) = jax.value_and_grad(f, argnums=(0, 1))(h, pred_l)
        return val, dh, dpred_l

    val, dh, dpred = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P(None, "tp"), P(), P()),
        out_specs=(P(), P(), P(None, "tp")), check_vma=False))(
            jnp.asarray(h), jnp.asarray(pred), jnp.asarray(tgt, jnp.int32), jnp.asarray(w))
    return float(val), np.asarray(dh), np.asarray(dpred)


STEP_KEYS = {(1, 2): (0.5, 7, 0.8, 0.5), (2, 2): (0.3, 2, 1.0, 0.4)}  # dropout, seed, klw, lr


def _step_case(shape, scale_pred=1.0):
    dropout, seed, klw, lr = STEP_KEYS[shape]
    _, params, batch = _setup(dropout, seed)
    return ("step", dict(mesh_shape=shape, widths=dict(WIDTHS, drop=dropout), params=params,
                         batch=batch, draws=dp_draws(jax.random.PRNGKey(seed + 100), shape[0]),
                         kl_weight=klw, lr=lr, clip=CLIP, scale_pred=scale_pred))


def _eval_batches(seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = rng.randint(4, V, (B, T)).astype(np.int32)
        mask = (np.arange(T)[None] < rng.randint(3, T + 1, (B, 1))).astype(np.float32)
        rw = (rng.rand(B) < 0.9).astype(np.float32)
        out.append((np.where(mask > 0, tokens, 0).astype(np.int32), mask, rw))
    return out


def _trained_params():
    """JAX init moved off its init scale so that KL, MI and AU are not trivial."""
    _, params, _ = _setup(0.0, 8)
    rng = np.random.RandomState(3)
    params["enc"]["linear"] = (rng.randn(NH, 2 * NZ) * 0.5).astype(np.float32)
    return params


EVAL_CASE = dict(widths=WIDTHS, params=None, batches=_eval_batches(5, 5), seed=11,
                 nsamples=50, ns=25)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One start of two ranks: logp at T 2, the (1, 2) step, the
    non-finite step, the round trip, the evaluators at (1, 2)."""
    _, params, _ = _setup(0.0, 6)
    opt = {"enc": {"v": {"emb": np.ones((V, NI), np.float32)}},
           "dec": {"v": {"pred": np.arange(NH * V, dtype=np.float32).reshape(NH, V),
                         "emb": np.zeros((V, NI), np.float32)}}}
    h, pred, tgt, w = _logp_inputs()
    cases = [("logp", dict(mesh_shape=(1, 2), h=h, pred=pred, tgt=tgt, w=w)),
             _step_case((1, 2)), _step_case((1, 2), scale_pred=1e38),
             ("roundtrip", dict(mesh_shape=(1, 2), params=params,
                                opt_state={"dec": {"v": {"pred": torch.from_numpy(
                                    opt["dec"]["v"]["pred"])}}})),
             ("evaluators", dict(EVAL_CASE, mesh_shape=(1, 2), params=_trained_params()))]
    out = run_ranks(ranks.run_cases, 2, "cpu", args=(cases,),
                    workdir=str(tmp_path_factory.mktemp("ranks2")), timeout=RANK_TIMEOUT)
    return [o.result for o in out], params


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One start of four ranks: logp at T 4, the (2, 2) step and eval."""
    h, pred, tgt, w = _logp_inputs()
    _, params, batch = _setup(0.0, 3)
    cases = [("logp", dict(mesh_shape=(1, 4), h=h, pred=pred, tgt=tgt, w=w)),
             _step_case((2, 2)),
             ("tp_eval", dict(mesh_shape=(2, 2), widths=WIDTHS, params=params, batch=batch,
                              draws=dp_draws(jax.random.PRNGKey(11), 2)))]
    out = run_ranks(ranks.run_cases, 4, "cpu", args=(cases,),
                    workdir=str(tmp_path_factory.mktemp("ranks4")), timeout=RANK_TIMEOUT)
    return [o.result for o in out]


@pytest.mark.parametrize("ntp", [2, 4])
def test_tp_token_logp_and_vjp_match_jax(ntp, two_ranks, four_ranks):
    per_rank = [r[0] for r in (two_ranks[0] if ntp == 2 else four_ranks)]
    val, dh, dpred = _jax_logp(ntp)
    h, pred, tgt, w = _logp_inputs()
    logp_dense, _ = ce_logp_plain(torch.from_numpy(h), torch.from_numpy(pred),
                                  torch.from_numpy(tgt), None)
    per = V // ntp
    for r in per_rank:
        np.testing.assert_allclose(r["val"], val, rtol=1e-6)
        np.testing.assert_allclose(r["dh"], dh, atol=1e-5)
        t = r["tp_index"]
        np.testing.assert_allclose(r["dpred"], dpred[:, t * per:(t + 1) * per], atol=1e-5)
        np.testing.assert_allclose(r["logp"], logp_dense.numpy(), rtol=1e-6, atol=1e-6)


def _jax_step(shape):
    """JAX's ``make_tp_train_step`` on a dp x tp mesh: (aux, params)."""
    dropout, seed, klw, lr = STEP_KEYS[shape]
    vae, params, (tokens, mask, rw) = _setup(dropout, seed)
    mesh = jax_tp_mesh(*shape)
    step = jax_tp_train_step(vae, type("C", (), dict(nsamples=1, clip_grad=CLIP)), mesh)
    new_p, aux = step(jax_shard_params(mesh, jax.tree.map(jnp.asarray, params)),
                      jax.random.PRNGKey(seed + 100), jnp.asarray(tokens), jnp.asarray(mask),
                      jnp.asarray(rw), jnp.float32(klw), jnp.float32(lr))
    return [float(a) for a in aux], _flat(jax.device_get(new_p))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tp_step_matches_jax(shape, two_ranks, four_ranks):
    results = [r[1] for r in two_ranks[0]] if shape == (1, 2) else [r[1] for r in four_ranks]
    aux_j, params_j = _jax_step(shape)
    for r in results:
        np.testing.assert_allclose(r["aux"], aux_j, atol=1e-4)
        got = _flat(r["params"])
        assert got.keys() == params_j.keys()
        for k in params_j:
            np.testing.assert_allclose(got[k], params_j[k], atol=1e-5, err_msg=k)


def test_tp_eval_step_matches_jax(four_ranks):
    vae, params, (tokens, mask, rw) = _setup(0.0, 3)
    mesh = jax_tp_mesh(2, 2)
    aux_j = jax_tp_eval_step(vae, mesh)(jax_shard_params(mesh, params), jax.random.PRNGKey(11),
                                        jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(rw),
                                        jnp.float32(1.0))
    for r in four_ranks:
        np.testing.assert_allclose(r[2], [float(a) for a in aux_j], atol=1e-4)


def test_tp_clip_zeroes_nonfinite_grads(two_ranks):
    """An overflowing batch zeroes the step (parameters unchanged, finite)."""
    _, params, _ = _setup(*STEP_KEYS[(1, 2)][:2])
    before = _flat(params)
    before["dec.pred"] = np.float32(before["dec.pred"] * np.float32(1e38))
    for r in two_ranks[0]:
        got = _flat(r[2]["params"])
        for k, v in got.items():
            assert np.isfinite(v).all(), k
            np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_clip_tp_guards_and_matches_the_dense_clip():
    """``clip_tp`` on one shard (its all-reduce a no-op): the dense clip's
    scale and norm, pred's squares added last; a non-finite gradient
    zeroes every leaf."""
    from vae_lagging_encoder_tpu_torch.parallel import clip_tp
    from vae_lagging_encoder_tpu_torch.train.optim import clip_scale

    mesh = Mesh(dp=1, tp=1, rank=0, dp_index=0, tp_index=0, dp_group=None, tp_group=None,
                device=torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    grads = {"enc.emb": torch.randn(5, 3, generator=g) * 4,
             "dec.pred": torch.randn(4, 6, generator=g) * 4,
             "dec.trans": torch.randn(2, 4, generator=g)}
    clipped, norm = clip_tp(grads, 5.0, mesh)
    scale, want_norm, _ = clip_scale(grads, 5.0)
    assert float(norm) == pytest.approx(float(want_norm), rel=1e-6) and float(scale) < 1.0
    for k, v in grads.items():
        torch.testing.assert_close(clipped[k], v * scale, rtol=1e-6, atol=0)
    grads["dec.pred"][1, 2] = float("inf")
    clipped, _ = clip_tp(grads, 5.0, mesh)
    assert all(bool((v == 0).all()) for v in clipped.values())


def test_vocab_not_divisible_raises():
    mesh = Mesh(dp=1, tp=4, rank=0, dp_index=0, tp_index=1, dp_group=None, tp_group=None,
                device=torch.device("cpu"))
    vae = ranks.text_vae(dict(WIDTHS, vocab=50))
    with pytest.raises(ValueError, match="vocab 50"):
        shard_model(mesh, vae)
    with pytest.raises(ValueError, match="vocab 50"):
        tp_token_logp(torch.zeros(3, NH), torch.zeros(NH, 25), torch.zeros(3, dtype=torch.long),
                      50)
    with pytest.raises(SystemExit, match="divisible by --tp_devices 4"):
        check_layout(get_config("synthetic", tp_devices=4), image=False, vocab=50)


def test_tp_image_model_rejected(tmp_path):
    over = dict(nz=2, enc_layers=(4, 4), dec_layers=2, dec_filters=4, dec_kernel_size=3,
                batch_size=8, epochs=1)
    cfg = get_config("omniglot", tp_devices=2, **over)
    vae = build_image_vae(cfg, device="cpu")
    pool = ImagePool(np.random.RandomState(0).rand(16, 28, 28, 1).astype(np.float32), 8, "cpu")
    with pytest.raises(SystemExit, match="image"):
        run_training(cfg, vae, pool, pool, pool, Logger(), loss_fn=object(),
                     eval_loss_fn=object())
    with pytest.raises(SystemExit, match="image"):  # refused before any rank starts
        cli_image.main(["--dataset", "omniglot", "--device", "cpu", "--tp_devices", "2",
                        "--exp_dir", str(tmp_path / "exp")])


def test_shard_gather_round_trip_is_exact(two_ranks):
    results, params = two_ranks
    want = ranks.from_jax_params(params)
    for r in results:
        rt = r[3]
        assert rt["pred_shape"] == (NH, V // 2)
        for k, v in want.items():
            np.testing.assert_array_equal(rt["params"][k], v.numpy(), err_msg=k)
        np.testing.assert_array_equal(rt["opt"]["dec"]["v"]["pred"].numpy(),
                                      np.arange(NH * V, dtype=np.float32).reshape(NH, V))


def test_tp_evaluators_match_one_process(two_ranks):
    want = ranks.case_evaluators("cpu", None, **dict(EVAL_CASE, params=_trained_params()))
    for r in two_ranks[0]:
        got = r[4]
        for k in want["ev"]:
            assert got["ev"][k] == pytest.approx(want["ev"][k], rel=1e-5), k
        for k in want["iw"]:
            assert got["iw"][k] == pytest.approx(want["iw"][k], rel=1e-5), k
        assert got["mi"] == pytest.approx(want["mi"], rel=1e-5, abs=1e-7)
        assert got["au"] == want["au"]
        np.testing.assert_allclose(got["var"], want["var"], rtol=1e-5)


def test_backend_follows_the_layout(monkeypatch):
    assert choose_backend(4, "cpu") == ("gloo", ["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert choose_backend(2, "cuda") == ("gloo", ["cuda:0", "cuda:0"])  # ranks share a card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert choose_backend(2, "cuda") == ("nccl", ["cuda:0", "cuda:1"])  # a card per rank
    assert choose_backend(8, "cuda")[0] == "gloo"


# --------------------------------------------------------------------- CLI
def _corpus(root, n, seed):
    from vae_lagging_encoder_tpu.data.synthetic import generate_synthetic_corpus

    sents, topics = generate_synthetic_corpus(num_sentences=n, vocab_size=30, min_len=4,
                                              max_len=20, seed=seed)
    cut = {"train": slice(0, n * 10 // 13), "valid": slice(n * 10 // 13, n * 23 // 26),
           "test": slice(n * 23 // 26, n)}
    paths = []
    for split, sl in cut.items():
        (root / f"{split}.txt").write_text(
            "".join(f"{t}\t{' '.join(s)}\n" for t, s in zip(topics[sl], sents[sl])))
        paths += [f"--{'val' if split == 'valid' else split}_data", str(root / f"{split}.txt")]
    return paths


TINY = ["--dataset", "synthetic", "--device", "cpu", "--ni", "8", "--enc_nh", "16",
        "--dec_nh", "16", "--nz", "2", "--batch_size", "16", "--iw_nsamples", "10",
        "--iw_batch", "5", "--test_nepoch", "0", "--log_niter", "0"]


def _results(exp):
    return next(r for r in (json.loads(l) for l in (exp / "log.metrics.jsonl").read_text()
                            .splitlines()) if r.get("split") == "test")


def short_burn(monkeypatch):
    """The synthetic config with an inner loop of at most 4 sub-iterations,
    tested every 2 (the CLI has no flag for them; the ranks get the parsed
    config)."""
    monkeypatch.setitem(DATASET_CONFIGS, "synthetic",
                        DATASET_CONFIGS["synthetic"].replace(burn_max_iters=4, burn_window=2))


def test_cli_dp_tp_matches_dp(tmp_path, monkeypatch):
    """2 x 2 ranks against 2 dp ranks through the CLI: one aggressive epoch
    (the inner loop, its plateau stops on all-reduced sums) and its final
    evaluation. The two differ in the order of the CE's sums only."""
    short_burn(monkeypatch)
    files = _corpus(tmp_path, 130, 2)
    common = TINY + files + ["--epochs", "1", "--aggressive", "1", "--decay_epoch", "5"]
    for tag, extra in (("dp", ["--dp_devices", "2"]),
                       ("tp", ["--dp_devices", "2", "--tp_devices", "2"])):
        assert cli_text.main(common + extra + ["--save_path", str(tmp_path / f"{tag}.ckpt"),
                                               "--exp_dir", str(tmp_path / tag)]) == 0
    r_dp, r_tp = _results(tmp_path / "dp"), _results(tmp_path / "tp")
    for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "iw_ppl"):
        assert r_tp[k] == pytest.approx(r_dp[k], rel=2e-5, abs=2e-5), k
    assert r_tp["au"] == r_dp["au"]
    ranks_rec = [json.loads(l) for l in (tmp_path / "tp" / "log.metrics.jsonl").read_text()
                 .splitlines() if '"ranks"' in l][0]["ranks"]
    assert [r["backend"] for r in ranks_rec] == ["gloo"] * 4
    # the dense best checkpoint loads in one process
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    params, extra = load_checkpoint(str(tmp_path / "tp.ckpt"))
    assert params["dec"]["pred"].shape == (16, 34) and "opt_state" in extra
    assert extra["opt_state"]["dec"] == {}  # plain SGD: no moments


def test_cli_eval_only_tp_devices(tmp_path):
    """A standalone ``--eval --dp_devices 1 --tp_devices 2`` of a checkpoint
    equals one process's ``--eval`` (the same per-batch draws; the
    distributed logsumexp reassociates)."""
    files = _corpus(tmp_path, 104, 4)
    ck = str(tmp_path / "m.ckpt")
    assert cli_text.main(TINY + files + ["--epochs", "1", "--save_path", ck,
                                         "--exp_dir", str(tmp_path / "train")]) == 0
    for tag, extra in (("one", []), ("tp", ["--tp_devices", "2"])):
        assert cli_text.main(TINY + files + ["--eval", "--load_path", ck, *extra,
                                             "--exp_dir", str(tmp_path / tag)]) == 0
    r1, r2 = _results(tmp_path / "one"), _results(tmp_path / "tp")
    for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "iw_ppl"):
        assert r2[k] == pytest.approx(r1[k], rel=1e-5), k
    assert r2["au"] == r1["au"]
