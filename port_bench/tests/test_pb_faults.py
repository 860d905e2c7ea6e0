"""A run of each cell, past the harness's look for a chip, on the CPU at a
tiny size with the cell's own limits: sound, it comes out correct; with
the timed path broken underneath, not: a step that returns its state
unchanged, half of the batch left out with the mean taken over the rest
(training: in every step, and in the aggressive cells' outer steps alone),
an answer altered where it is produced (IW)."""
from __future__ import annotations

import time

import pytest
import torch

from port_bench.run import run_cell
from port_bench.tests.tiny import tiny_cell

TRAIN = ["yahoo.train_aggressive", "yahoo.train_plain"]


def _run(name, **config):
    torch.manual_seed(0)
    out = run_cell(tiny_cell(name, config=config), 2 ** 31 + 11, 0.3, False,
                   torch.device("cpu"), time.perf_counter())
    assert out["attempted"] > 0 and list(out)[-1] == "check"
    assert all(v["value"] is not None and v["limit"] is not None for v in out["check"].values())
    return out


@pytest.mark.parametrize("name", TRAIN + ["yahoo.iwnll"])
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"]
    if name == "yahoo.train_aggressive":  # the outer step is compared too
        assert {"grad", "change", "outer_grad", "outer_loss"} == set(out["check"])


def _unchanged(monkeypatch):
    from vae_lagging_encoder_tpu_torch.train import epoch

    make = epoch.make_optimizer

    def frozen(*a, **k):
        init, _ = make(*a, **k)
        return init, lambda params, grads, state, lr, scale=None, finite=None: state

    monkeypatch.setattr(epoch, "make_optimizer", frozen)


def _half_batch(monkeypatch):
    from vae_lagging_encoder_tpu_torch.train import epoch

    def halved(make):
        def wrapped(*a, **k):
            loss = make(*a, **k)

            def half(batch, draw, kl_weight=1.0):
                *rest, rw = batch
                rw = rw.clone()
                rw[rw.shape[0] // 2:] = 0.0
                return loss((*rest, rw), draw, kl_weight)

            return half
        return wrapped

    monkeypatch.setattr(epoch, "make_loss_fn", halved(epoch.make_loss_fn))


def _in_outer_steps(monkeypatch, fault):
    """``fault(steps, batch) -> (batch, restore)`` planted in the static
    steps of mode OUTER alone (the aggressive loop's decoder update)."""
    from vae_lagging_encoder_tpu_torch.train import epoch

    class Faulty(epoch.graphs_mod.StaticSteps):
        def run(self, mode, batch, kl, draw):
            if mode != epoch.OUTER:
                return super().run(mode, batch, kl, draw)
            batch, restore = fault(self, batch)
            super().run(mode, batch, kl, draw)
            restore()

    monkeypatch.setattr(epoch.graphs_mod, "StaticSteps", Faulty)


def _outer_unchanged(monkeypatch):
    """The outer step leaves the decoder as it was (its lr read as 0)."""
    def fault(steps, batch):
        lr = steps.lr.clone()
        steps.lr.zero_()
        return batch, lambda: steps.lr.copy_(lr)

    _in_outer_steps(monkeypatch, fault)


def _outer_half_batch(monkeypatch):
    def fault(steps, batch):
        *rest, rw = batch
        rw = rw.clone()
        rw[rw.shape[0] // 2:] = 0.0
        return (*rest, rw), lambda: None

    _in_outer_steps(monkeypatch, fault)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_training_step_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("fault", [_outer_unchanged, _outer_half_batch],
                         ids=["outer_unchanged", "outer_half_batch"])
def test_a_broken_outer_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run("yahoo.train_aggressive")
    assert not out["correct"]
    # the sub-iterations are sound: only the outer step's numbers fail
    lim = tiny_cell("yahoo.train_aggressive").limits
    assert out["check"]["grad"]["value"] <= lim["grad"]["limit"]
    assert out["check"]["outer_grad"]["value"] > lim["outer_grad"]["limit"]


@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch],
                         ids=["sound", "unchanged", "half_batch"])
@pytest.mark.parametrize("name", TRAIN)
def test_adam_runs_are_judged_alike(name, fault, monkeypatch):
    """The harness's Adam path (first moments as the gradient, a step count
    per leaf) on the same cells with ``optim`` adam."""
    if fault is not None:
        fault(monkeypatch)
    assert _run(name, optim="adam", lr=1e-3)["correct"] == (fault is None)


def test_an_altered_answer_is_not_correct(monkeypatch):
    from vae_lagging_encoder_tpu_torch.models.vae import VAE

    nll_iw = VAE.nll_iw

    def altered(self, *a, **k):
        out = nll_iw(self, *a, **k)
        return out + torch.nn.functional.one_hot(torch.tensor(0), out.shape[0]).to(out)

    monkeypatch.setattr(VAE, "nll_iw", altered)
    assert not _run("yahoo.iwnll")["correct"]
