"""The published OmniGlot model (``image_arch="published"``: jxhe's ResNet
encoder with batch norm and the 13-kernel bottleneck PixelCNN with direct
connections) against the plain reference ``port_bench/reference/
image_vae.py``, on the CPU at a small size, on seeded random weights whose
batch-norm scales and shifts are not the identity.

- A training step: the logits and each image's loss, every leaf's
  gradient, and the batch norms' running statistics after it.
- Evaluation: the IW-NLL on the running statistics, which the evaluators
  leave as they are; in training mode the answer would differ.
- An aggressive call of ``make_train_epoch`` (its sub-iterations to the
  plateau and its outer step, with Adam and the clip), as the benchmark
  compares it (``port_bench/train.py``).
- Checkpoints: parameters and batch-norm buffers round-trip exactly; the
  image CLI trains with ``--image_arch published``, resumes exactly as the
  uninterrupted run went on, and ``--eval`` of its best checkpoint gives
  the training run's final evaluation.
- The spans ``resnet`` and ``pixelcnn`` nest under the step and under the
  IW chunk, and leave every answer as it was.
- Generation runs the dense sampler in evaluation mode; what the published
  model refuses (the cached sampler, bf16, more z-samples than a chunk in
  training, ranks) raises, and ``get_config("omniglot")`` still builds the
  JAX package's stack.

Tolerances: the port and the reference run the same f32 operations on the
CPU, the port's convolutions through ``aten.convolution_backward``, the
reference's through ``torch.nn.grad``: sums of up to a few thousand terms
in another order, so agreement to ~1e-6 of a tensor's largest element;
each check allows 1e-5 (1e-4 for gradients, whose batch-norm backward
subtracts nearly equal sums). Imports neither JAX nor the JAX package.
"""
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from port_bench.reference import image_vae as ref
from port_bench.reference.numerics import Products
from vae_lagging_encoder_tpu_torch.cli import image as cli_image
from vae_lagging_encoder_tpu_torch.config import DATASET_CONFIGS, get_config
from vae_lagging_encoder_tpu_torch.models import (BottleneckPixelCNNDecoder, PixelCNNDecoderV2,
                                                  build_image_vae)
from vae_lagging_encoder_tpu_torch.models.modes import module_mode
from vae_lagging_encoder_tpu_torch.ops.conv import conv2d_nchw, to_nchw
from vae_lagging_encoder_tpu_torch.train import loop
from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from vae_lagging_encoder_tpu_torch.train.epoch import (IndexedNoise, binarize_prep,
                                                      make_image_loss_fn, make_iwnll_fn)
from vae_lagging_encoder_tpu_torch.utils import profiling
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params, to_jax_params

SMALL = dict(image_arch="published", img_size=(12, 12, 1), enc_layers=(8, 8), enc_head=16,
             dec_kernels=(5, 3, 5, 3, 3, 3), dec_hidden=8, dec_bottleneck=4, latent_maps=2,
             nz=3)
REF = {"enc_layers": [8, 8], "dec_kernels": [5, 3, 5, 3, 3, 3], "latent_maps": 2, "nz": 3}
B = 6
TOL = 1e-5


def _model(seed=0, **kw):
    cfg = get_config("omniglot", **{**SMALL, **kw})
    vae = build_image_vae(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for k, p in vae.named_parameters():
            if k.endswith(".weight"):   # batch-norm scales 1 + U(-0.2, 0.2)
                p.add_(torch.rand(p.shape, generator=g) * 0.4 - 0.2)
            elif k.endswith(".bias"):   # and shifts U(-0.2, 0.2)
                p.copy_(torch.rand(p.shape, generator=g) * 0.4 - 0.2)
    return cfg, vae


def _batch(seed=3, n=B, size=12):
    g = torch.Generator().manual_seed(seed)
    probs = torch.rand(n, size, size, 1, generator=g) ** 2
    noise = {"bin": torch.rand(n, size, size, 1, generator=g),
             "eps": torch.randn(n, 1, SMALL["nz"], generator=g)}
    return (probs, torch.ones(n)), noise


def _weights(vae):
    return {k: p.detach().clone().requires_grad_() for k, p in vae.named_parameters()}


def _stats(vae):
    return {k: v.detach().clone() for k, v in vae.state_dict().items() if ".running_" in k}


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp(min=1e-30))


def test_logits_and_per_image_loss_match_the_reference():
    _, vae = _model()
    (probs, rw), noise = _batch()
    x = (noise["bin"] < probs).float()
    w = _weights(vae)
    with torch.no_grad(), module_mode(vae, True):
        z = torch.randn(B, 1, SMALL["nz"], generator=torch.Generator().manual_seed(9))
        logits = vae.dec.decode(x, z)[:, 0]
        loss, rec, kl = vae.loss(x, None, rw, kl_weight=0.3, eps=noise["eps"])
        ref_logits = ref.Net(w, REF, Products(), True).logits(ref.nchw(x), z[:, 0])
        _, ref_loss = ref.train_loss(w, REF, (probs, rw), noise, 0.3, Products())
    assert _rel(logits, ref_logits.permute(0, 2, 3, 1)) < TOL
    assert _rel(loss, ref_loss) < TOL
    assert torch.all(kl > 0) and torch.all(rec > 0)


def test_a_training_step_s_gradients_and_running_statistics():
    _, vae = _model()
    batch, noise = _batch()
    w = _weights(vae)
    stats0 = _stats(vae)
    ref_stats = {k: v.clone() for k, v in stats0.items()}
    vae.train()
    mean, _ = make_image_loss_fn(vae, 1, train=True)(batch, lambda s, shape: noise[s], 0.3)
    mean.backward()
    ref_mean, _ = ref.train_loss(w, REF, batch, noise, 0.3, Products(), ref_stats)
    grads = dict(zip(w, torch.autograd.grad(ref_mean, list(w.values()))))
    assert float(mean) == pytest.approx(float(ref_mean), rel=TOL)
    for k, p in vae.named_parameters():
        assert _rel(p.grad, grads[k]) < 1e-4, k
    got = _stats(vae)
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in vae.modules())
    assert set(got) == set(ref_stats) and len(got) == 2 * n_bn == 2 * 36
    for k in got:
        assert not torch.equal(got[k], stats0[k]), k
        assert _rel(got[k], ref_stats[k]) < TOL, k
    # every batch norm counted the step once: no block runs twice a forward
    tracked = {k: int(v) for k, v in vae.state_dict().items() if k.endswith("batches_tracked")}
    assert len(tracked) == n_bn and set(tracked.values()) == {1}


def test_the_decoder_runs_jxhe_s_direct_connection_loop():
    """``PixelCNN.forward`` of jxhe's ``dec_pixelcnn_v2.py`` as written,
    on the port's blocks: block A and the main chain in ``blocks``, one
    direct block for each i in ``range(1, num_blocks - 1)`` with kernel
    ``k[i]``, each block's output queued and popped three blocks later, the
    last direct block its own, on the queue's head at the end."""
    _, vae = _model()
    dec, ks = vae.dec, SMALL["dec_kernels"]
    assert [b.k for b in dec.main] == list(ks[1:])
    assert [b.k for b in dec.direct] == list(ks[1:-1])
    (probs, _), noise = _batch()
    x = (noise["bin"] < probs).float()
    z = noise["eps"][:, 0]
    N, H, W, _ = x.shape

    def block_a(h):
        return F.elu(dec.bn_a(conv2d_nchw(h, dec.conv_a * dec.mask_a, padding=ks[0] // 2)))

    with torch.no_grad(), module_mode(vae, False):
        zf = (z @ dec.z_w.T + dec.z_b).view(N, SMALL["latent_maps"], H, W)
        inp = torch.cat([to_nchw(x), zf], dim=1)
        direct_inputs = []
        for i, layer in enumerate([block_a] + list(dec.main)):
            if i > 2:
                inp = inp + dec.direct[i - 3](direct_inputs.pop(0))
            inp = layer(inp)
            direct_inputs.append(inp)
        assert len(direct_inputs) == 3
        out = inp + dec.direct[-1](direct_inputs.pop(0))
        want = conv2d_nchw(F.elu(dec.bn_out(conv2d_nchw(out, dec.out_hidden))), dec.out)
        assert torch.equal(dec._logits(x, z), want.permute(0, 2, 3, 1))


def _trained(seed=0):
    """A model after two training steps: running statistics of its own."""
    cfg, vae = _model(seed)
    vae.train()
    for s in (3, 4):
        batch, noise = _batch(s)
        vae.zero_grad()
        mean, _ = make_image_loss_fn(vae, 1, train=True)(batch, lambda k, shape: noise[k], 0.5)
        mean.backward()
    return cfg, vae


def test_eval_mode_iw_nll_uses_the_running_statistics():
    from vae_lagging_encoder_tpu_torch.data import ImagePool

    cfg, vae = _trained()
    probs = _batch(7, n=10)[0][0]
    pool = ImagePool(probs.numpy(), 5, "cpu")
    stats = _stats(vae)
    noise = IndexedNoise(11, "cpu")
    nsamples, ns = 8, 4
    got = make_iwnll_fn(vae, pool, nsamples=nsamples, ns=ns, prep=binarize_prep)(noise)
    assert all(torch.equal(v, stats[k]) for k, v in _stats(vae).items())  # left as they were
    assert vae.training  # the evaluator's mode is restored after it
    w = {k: p.detach() for k, p in vae.named_parameters()}
    total = 0.0
    for i in range(pool.num_batches):
        p, rw = pool.batch(i)
        x = (noise(i, "iw_bin", tuple(p.shape)) < p).float()
        eps = [noise(i, f"iw{j}", (5, ns, SMALL["nz"])) for j in range(nsamples // ns)]
        total += float(ref.nll_iw(w, REF, x, eps, Products(), stats).sum())
    assert got["nll"] == pytest.approx(total / 10, rel=TOL)
    # in training mode (batch statistics) the same draws give another answer
    with module_mode(vae, True), torch.no_grad():
        p, _ = pool.batch(0)
        x = (noise(0, "iw_bin", tuple(p.shape)) < p).float()
        train_mode = vae.nll_iw(x, None, nsamples, ns,
                                noise=lambda j, shape: noise(0, f"iw{j}", shape))
    with module_mode(vae, False), torch.no_grad():
        eval_mode = vae.nll_iw(x, None, nsamples, ns,
                               noise=lambda j, shape: noise(0, f"iw{j}", shape))
    assert _rel(train_mode, eval_mode) > 1e-3


def _tiny_cell():
    from port_bench import manifest

    cell = manifest.load_cell("omniglot.train_aggressive",
                              manifest.load_json(manifest.find_manifest()))
    cell.config.update(img_size=[12, 12, 1], enc_layers=[8, 8], enc_head=16,
                       dec_kernels=[5, 3, 3, 3, 3, 3], dec_hidden=8, dec_bottleneck=4,
                       latent_maps=2, nz=3, batch_size=6, train_images=40, burn_max_iters=20,
                       burn_window=5)
    return cell


def test_an_aggressive_call_follows_the_reference():
    """The benchmark's comparison of a whole first call of ``epoch_fn``
    (``port_bench/train.py``: the first three static steps, the rest of the
    sub-iterations to the plateau and the outer step), with Adam."""
    from port_bench.train import TrainCell

    torch.manual_seed(0)
    c = TrainCell(_tiny_cell(), 2 ** 31 + 5, torch.device("cpu"))
    assert c.cfg.optim == "adam" and c.aggressive
    c.calibration_run(0.0)
    assert c.steps_ref[-1][0] == "outer" and len(c.steps_ref) > 5
    c.free()
    nums = c.check()
    assert set(nums) == {"grad", "change", "outer_grad", "outer_loss"}
    assert max(nums.values()) < TOL, nums


def test_checkpoint_round_trip_keeps_parameters_and_batch_norm_buffers(tmp_path):
    cfg, vae = _trained()
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, to_jax_params(vae.state_dict()), {"epoch": 0})
    params, extra = load_checkpoint(path)
    fresh = build_image_vae(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    fresh.load_state_dict(from_jax_params(params))
    before, after = vae.state_dict(), fresh.state_dict()
    assert set(before) == set(after) and any(".running_var" in k for k in before)
    for k in before:
        assert before[k].dtype == after[k].dtype and torch.equal(before[k], after[k]), k


def test_cli_trains_resumes_and_evaluates_the_published_model(tmp_path, monkeypatch):
    small = {k: v for k, v in SMALL.items() if k != "img_size"}
    monkeypatch.setitem(DATASET_CONFIGS, "omniglot",
                        DATASET_CONFIGS["omniglot"].replace(**{**small, "image_arch": "stack"}))
    rng = np.random.RandomState(0)
    np.savez(tmp_path / "omni.npz", **{k: (rng.rand(n, 28, 28, 1) ** 3).astype(np.float32)
                                       for k, n in (("train", 21), ("val", 8), ("test", 8))})
    common = ["--dataset", "omniglot", "--device", "cpu", "--image_arch", "published",
              "--train_data", str(tmp_path / "omni.npz"), "--batch_size", "8",
              "--iw_nsamples", "4", "--iw_batch", "2", "--warm_up", "1", "--aggressive", "1"]

    def run(name, *extra):
        assert cli_image.main([*common, "--exp_dir", str(tmp_path / name), *extra]) == 0
        recs = [json.loads(line) for line in
                (tmp_path / name / "log.metrics.jsonl").read_text().splitlines()]
        return [r for r in recs if "val_loss" in r], next(r for r in recs
                                                          if r.get("split") == "test")

    full, _ = run("full", "--epochs", "2", "--save_path", str(tmp_path / "full.ckpt"))
    # the aggressive loop's permanent switch-off at the MI plateau, after epoch 1
    assert [m["aggressive"] for m in full] == [True, False]
    ck = tmp_path / "first.ckpt"
    first, res = run("first", "--epochs", "1", "--save_path", str(ck))
    assert first[0]["inner_iters"] > 0
    for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "iw_ppl"):
        assert math.isfinite(res[k]), (k, res)
    params, _ = load_checkpoint(str(ck))
    flat = from_jax_params(params)
    assert "dec.main.0.bn_conv.running_mean" in flat and "enc.head" in flat
    resumed, _ = run("resumed", "--epochs", "2", "--save_path", str(tmp_path / "r.ckpt"),
                     "--load_path", str(ck), "--resume")
    assert [m["epoch"] for m in resumed] == [1]
    for k in ("train_loss", "val_loss", "kl_weight", "lr", "inner_iters", "aggressive"):
        assert resumed[0][k] == full[1][k], (k, resumed[0][k], full[1][k])
    # --eval scores the best checkpoint on its running statistics, as the
    # training run's final evaluation did
    _, ev = run("eval", "--eval", "--load_path", str(ck))
    for k in ("elbo_loss", "rec", "kl", "mi", "au", "iw_nll"):
        assert ev[k] == res[k], (k, ev[k], res[k])


def test_the_train_pool_keeps_its_last_batch_unpadded():
    from vae_lagging_encoder_tpu_torch.data import ImagePool

    imgs = np.random.RandomState(0).rand(23, 12, 12, 1).astype(np.float32)
    pool = ImagePool(imgs, 5, "cpu", pad=False)
    assert pool.counts == [4, 1] and pool.batch(4)[0].shape[0] == 3
    assert torch.equal(torch.cat([pool.batch(i)[0] for i in range(5)]), torch.from_numpy(imgs))
    assert ImagePool(imgs, 5, "cpu").counts == [5]   # the stack's pools pad it
    assert ImagePool(imgs[:20], 5, "cpu", pad=False).counts == [4]


def test_spans_nest_without_changing_an_answer():
    from vae_lagging_encoder_tpu_torch.train.epoch import GeneratorNoise, make_train_epoch
    from vae_lagging_encoder_tpu_torch.data import ImagePool

    imgs = (np.random.RandomState(1).rand(18, 12, 12, 1) ** 2).astype(np.float32)
    runs = {}
    profiling.take()
    for traced in (False, True):
        cfg, vae = _model(aggressive=True, burn_window=2, burn_max_iters=4)
        pool = ImagePool(imgs, 6, "cpu", pad=False)
        epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=make_image_loss_fn(
            vae, 1, train=True))
        iw = make_iwnll_fn(vae, pool, nsamples=4, ns=2, prep=binarize_prep)
        args = (opt_init(), GeneratorNoise(4, "cpu"), np.float32(0.1), 1e-3, [0, 1], True)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                out = epoch_fn(*args)
                nll = iw(IndexedNoise(3, "cpu"))
        else:
            out = epoch_fn(*args)
            nll = iw(IndexedNoise(3, "cpu"))
        runs[traced] = (out[2].tolist(), out[3], nll, vae.state_dict())
    (s0, i0, n0, p0), (s1, i1, n1, p1) = runs[False], runs[True]
    assert s0 == s1 and i0 == i1 and n0 == n1
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    spans = profiling.take()["spans"]
    names = [s["name"] for s in spans]
    steps = names.count("step")
    assert steps == 2 + i1
    assert names.count("resnet") == steps + 2 * pool.num_batches
    assert names.count("pixelcnn") == steps + 2 * pool.num_batches
    for s in spans:
        if s["name"] in ("resnet", "pixelcnn"):
            assert spans[s["parent"]]["name"] in ("step", "iw_chunk"), s


def test_generation_runs_in_evaluation_mode_and_the_refusals():
    cfg, vae = _trained()
    stats = _stats(vae)
    z = torch.randn(2, SMALL["nz"], generator=torch.Generator().manual_seed(1))
    imgs = vae.dec.sample(z, generator=torch.Generator().manual_seed(2))
    assert imgs.shape == (2, 12, 12, 1) and set(imgs.unique().tolist()) <= {0.0, 1.0}
    assert all(torch.equal(v, stats[k]) for k, v in _stats(vae).items())
    x = (torch.rand(2, 12, 12, 1, generator=torch.Generator().manual_seed(3)) < 0.5).float()
    rec = vae.reconstruct(x, generator=torch.Generator().manual_seed(4))
    assert rec.shape == x.shape and vae.training
    with pytest.raises(ValueError, match="incremental sampler"):
        vae.dec.sample(z, fast=True)
    with pytest.raises(ValueError, match="iw_chunk"):
        vae.loss(x, None, None, nsamples=vae.dec.iw_chunk + 1,
                 eps=torch.zeros(2, vae.dec.iw_chunk + 1, SMALL["nz"]))
    with pytest.raises(ValueError, match="float32"):
        build_image_vae(cfg.replace(compute_dtype="bfloat16"), device="cpu")
    with pytest.raises(SystemExit, match="one process"):
        loop.train_image(cfg.replace(dp_devices=2), device="cpu")
    assert isinstance(build_image_vae(get_config("omniglot", dec_layers=2, dec_filters=4),
                                      device="cpu").dec, PixelCNNDecoderV2)
    assert isinstance(vae.dec, BottleneckPixelCNNDecoder)
