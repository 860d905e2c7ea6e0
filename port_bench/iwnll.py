"""The IW-NLL cells: ``make_iwnll_fn``'s ``iwnll_fn`` (``VAE.nll_iw``:
``iw_nsamples`` z-samples per sentence in chunks of ``iw_batch``, each
chunk encoding the batch again; the decoder and the CE forward per
sample), as the final evaluation runs it, eagerly, one read of the device
per call.

Each test batch gets a pool and an evaluator of its own, so that the
window can end between batches and every batch's answer (its mean IW-NLL)
can be held against the reference. Call ``k`` of the run draws its noise
for chunk ``j`` from a generator of its own, seeded by (seed, k, "iw<j>"),
so the reference draws the same. Set-up evaluates one batch of every
bucket (the window's shapes); the window takes the batches in the cell's
order until ``--seconds`` have passed.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from . import compare, inputs, models
from .reference.numerics import exact_f32

ORDER_STREAM, CHECK_STREAM = 31, 32


@dataclass
class Window:
    seconds: float = 0.0
    steps: int = 0
    failed: int = 0
    examples: float = 0.0
    answers: List[tuple] = field(default_factory=list)  # (call, flat index, mean nll)


class IWCell:
    def __init__(self, cell, seed: int, dev):
        from vae_lagging_encoder_tpu_torch.train.epoch import make_iwnll_fn

        self.cell, self.seed, self.dev = cell, seed, dev
        tr = cell.traffic
        self.model = m = models.model_for(cell.config, tr)
        self.cfg = models.port_config(cell.config, {})
        self.init = {**cell.config["init"], **tr.get("init", {})}
        self.groups = m.batches(tr["pool"], seed, models.TEST_STREAM)
        self.flat = models.flat_batches(self.groups)
        self.counts = models.counts_of(self.groups)
        w0 = m.weights(seed, dev, self.init)
        self.vae = m.build(self.cfg, w0, dev)
        del w0
        self.vae.eval()
        self.fns = [make_iwnll_fn(self.vae, m.port_pool([(0, [b])], dev),
                                  nsamples=self.cfg.iw_nsamples, ns=self.cfg.iw_batch)
                    for b in self.flat]
        self.order = inputs.schedule(self.counts, seed, ORDER_STREAM)
        self.calls = 0

    def _noise(self, k: int):
        return lambda i, site, shape: inputs.indexed_noise(self.seed, k, site, shape, self.dev)

    def _call(self, f: int) -> tuple:
        k = self.calls
        self.calls += 1
        res = self.fns[f](self._noise(k))
        return k, f, res

    def setup(self) -> None:
        self.warm_up()

    def calibration_run(self, seconds: float) -> None:
        """What the check needs: a window of ``seconds`` (calibrate.py)."""
        self.warm_up()
        self.window(seconds)

    def faults(self) -> Dict[str, Dict[str, float]]:
        return {}  # the control is the upper reading (an altered answer: the CPU tests)

    def warm_up(self) -> None:
        """One batch of every bucket."""
        start = 0
        for c in self.counts:
            self._call(start)
            start += c

    def window(self, seconds: float) -> Window:
        w = Window()
        t0 = time.perf_counter()
        while True:
            k, f, res = self._call(next(self.order))
            w.steps += 1
            w.examples += res["n_sents"]
            w.failed += 0 if math.isfinite(res["nll"]) else 1
            w.answers.append((k, f, res["nll"]))
            if time.perf_counter() - t0 >= seconds:
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        w.seconds = time.perf_counter() - t0
        self.last = w
        return w

    def iw_chunk(self) -> int:
        return self.vae.dec.iw_chunk

    def free(self) -> None:
        self.fns = None
        self.vae = None

    def check(self) -> Dict[str, float]:
        """The reference's mean IW-NLL of a sample of the window's batches
        (``check_batches`` of them, drawn from the seed, the longest among
        them) against the program's answers."""
        picked = self._sample()
        ref = self._reference(picked, control=False)
        return {"nll": max(compare.rel_gap(a[2], r) for a, r in zip(picked, ref))}

    def control(self) -> Dict[str, float]:
        """The control: the reference one precision step down (``Products``)
        in the program's place."""
        picked = self._sample()
        ref = self._reference(picked, control=False)
        low = self._reference(picked, control=True)
        return {"nll": max(compare.rel_gap(a, r) for a, r in zip(low, ref))}

    def _sample(self) -> list:
        answers = self.last.answers
        n = int(self.cell.traffic["check_batches"])
        longest = max(range(len(answers)),
                      key=lambda i: self.model.shape_of(self.flat[answers[i][1]]))
        return [answers[i] for i in
                models.sample(answers, min(n, len(answers)), self.seed, CHECK_STREAM, longest)]

    def _reference(self, picked, control: bool) -> list:
        """The reference's mean IW-NLL of each picked (call, batch)."""
        m = self.model
        w = m.weights(self.seed, self.dev, self.init)
        prods = models.products(m.c, control)
        out = []
        with exact_f32():
            for k, f, _ in picked:
                batch = m.ref_batch(self.flat[f], self.dev)
                rw = batch[-1].double()
                nll = m.ref_nll_iw(w, batch, lambda site, shape, k=k: inputs.indexed_noise(
                    self.seed, k, site, shape, self.dev), self.cfg, prods)
                out.append(float((nll.double() * rw).sum() / rw.sum()))
        return out

    def counts_of(self, w: Window, iw_chunk: int):
        c = self.cfg
        total, launches = 0.0, []
        for _, f, _ in w.answers:
            b = self.flat[f]
            total += self.model.iw_flops(b, c.iw_nsamples, c.iw_batch)
            launches += self.model.iw_launches(b, c.iw_nsamples, c.iw_batch, iw_chunk)
        return total, launches
