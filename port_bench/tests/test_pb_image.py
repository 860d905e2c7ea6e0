"""The published OmniGlot configuration (``omniglot``, model type
``image_vae``) on the CPU at a tiny size: its reference against the port's
CPU path on the benchmark's own weights, batches and draws; the cell as the
loader finds it; its data and FLOP arithmetic; and whole runs of
``omniglot.train_aggressive`` on the cell's own limits, sound (correct) and
with faults planted in the port (not correct): a step that leaves its
state unchanged and half of the batch left out, each in every step and in
the outer step alone, and the batch norms in evaluation mode during a
training step."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from port_bench import flops_image, manifest, models
from port_bench.models.image_vae import stroke_images
from port_bench.run import run_cell
from port_bench.tests.test_pb_faults import (_half_batch, _in_outer_steps, _outer_half_batch,
                                             _unchanged)

CELL = "omniglot.train_aggressive"
TINY = dict(img_size=[12, 12, 1], enc_layers=[8, 8], enc_head=16, dec_kernels=[5, 3, 5, 3, 3, 3],
            dec_hidden=8, dec_bottleneck=4, latent_maps=2, nz=3, batch_size=6, train_images=40,
            burn_max_iters=20, burn_window=5)


def _cell():
    cell = manifest.load_cell(CELL, manifest.load_json(manifest.find_manifest()))
    cell.config.update(TINY)
    return cell


def test_the_cell_loads_with_its_files():
    cell = manifest.load_cell(CELL, manifest.load_json(manifest.find_manifest()))
    c = cell.config
    assert c["model"] == "image_vae" and c["reduced"] == [] and c["batch_size"] == 50
    assert c["dec_kernels"] == [7] * 5 + [5] * 4 + [3] * 4 and c["train_images"] == 24345
    assert cell.traffic["entry"] == "train" and cell.traffic["aggressive"]
    assert set(cell.limits) == {"grad", "change", "outer_grad", "outer_loss"}
    assert {m["name"] for m in cell.end_to_end} == {"train_steps_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "gemm_ms_per_step.train", "idle_share.train", "launch_calls_per_step.train",
        "mfu.train", "starved_share.train", "reads_per_step.train",
        "pointwise_ms_per_step.train"}
    # the port's ExperimentConfig takes the file's fields; the new widths go
    # through the model type's build, not through PORT_FIELDS
    assert not {"dec_kernel_size", "dec_layers", "dec_filters"} & set(c)
    cfg = models.port_config(c, {})
    assert cfg.batch_size == 50 and cfg.optim == "adam" and cfg.enc_layers == (64, 64, 64)


def test_the_reference_matches_the_port_on_the_benchmark_s_inputs():
    from vae_lagging_encoder_tpu_torch.train.epoch import make_image_loss_fn

    c = dict(_cell().config)
    m = models.model_for(c, {})
    cfg = models.port_config(c, {})
    dev = torch.device("cpu")
    w = m.weights(3, dev, c["init"])
    assert all(float(w[k].min()) > 0.85 for k in w if k.endswith(".weight"))
    vae = m.build(cfg, w, dev)
    groups = m.batches("train", 3, models.TRAIN_STREAM)
    assert [len(bs) for _, bs in groups] == [6, 1] and groups[1][0] == 4
    batch = m.ref_batch(groups[0][1][2], dev)
    g = torch.Generator().manual_seed(5)
    noise = {"bin": torch.rand(6, 12, 12, 1, generator=g),
             "eps": torch.randn(6, 1, 3, generator=g)}
    vae.train()
    mean, _ = make_image_loss_fn(vae, 1, train=True)(batch, lambda s, shape: noise[s], 0.3)
    mean.backward()
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    ref, _ = m.ref_loss(leaves, batch, noise, 0.3, models.products(c))
    grads = dict(zip(leaves, torch.autograd.grad(ref, list(leaves.values()))))
    assert float(mean.detach()) == pytest.approx(float(ref.detach()), rel=1e-6)
    for k, p in vae.named_parameters():
        assert float((p.grad - grads[k]).abs().max()) <= 1e-4 * float(grads[k].abs().max()), k


def test_the_stroke_images_are_the_seed_s():
    a, b, c = (stroke_images(50, 28, s, 11) for s in (7, 7, 8))
    assert a.shape == (50, 28, 28, 1) and torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) == 1.0
    assert 0.05 < float(a.mean()) < 0.4  # strokes on a blank page


def test_the_image_flops_and_the_pointwise_reader():
    c = manifest.load_json(manifest.HERE / "configs" / "omniglot.json")
    f = flops_image.image_forward_flops(c)
    assert f["enc"] == pytest.approx(0.0259328e9) and f["dec"] == pytest.approx(1.230716928e9)
    assert flops_image.image_train_flops(c, 50) == pytest.approx(3 * 50 * (f["enc"] + f["dec"]))
    reader = manifest.load_reader("pointwise_ms_per_step.train")
    run = SimpleNamespace(kind="train", steps=10, busy_s=0.1, gemm_s=0.06,
                          family_s={"lstm": 0.0, "ce": 0.01})
    assert reader.read(run) == pytest.approx(3.0)
    assert reader.read(SimpleNamespace(**{**vars(run), "gemm_s": 0.1})) is None
    assert reader.read(SimpleNamespace(**{**vars(run), "kind": "iwnll"})) is None


def _run():
    torch.manual_seed(0)
    out = run_cell(_cell(), 2 ** 31 + 11, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert out["attempted"] > 0 and list(out)[-1] == "check"
    assert set(out["check"]) == {"grad", "change", "outer_grad", "outer_loss"}
    return out


def test_a_sound_run_is_correct():
    assert _run()["correct"]


def _outer_unchanged(monkeypatch):
    """The outer step leaves its state unchanged: no optimizer update, so
    the decoder and Adam's moments stay as they were. (Reading the
    learning rate as 0, as ``test_pb_faults.py`` plants it for SGD, would
    still move Adam's moments, from which ``outer_grad`` reads an Adam
    cell's update: PERF.md §7.)"""
    from vae_lagging_encoder_tpu_torch.train import epoch

    make, outer = epoch.make_optimizer, []

    def frozen_in_outer(*a, **k):
        init, update = make(*a, **k)

        def maybe(params, grads, state, lr, scale=None, finite=None):
            return state if outer else update(params, grads, state, lr, scale=scale,
                                              finite=finite)

        return init, maybe

    monkeypatch.setattr(epoch, "make_optimizer", frozen_in_outer)

    def fault(steps, batch):
        outer.append(True)
        return batch, outer.clear

    _in_outer_steps(monkeypatch, fault)


def _bn_eval(monkeypatch):
    """The training step with the batch norms on their running statistics."""
    from vae_lagging_encoder_tpu_torch.train import epoch

    mode = epoch.module_mode
    monkeypatch.setattr(epoch, "module_mode", lambda module, training: mode(module, False))


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _outer_unchanged, _outer_half_batch,
                                   _bn_eval],
                         ids=["unchanged", "half_batch", "outer_unchanged", "outer_half_batch",
                              "bn_eval"])
def test_a_broken_training_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not _run()["correct"]
