"""The training cells: ``epoch_fn`` of the port's ``make_train_epoch``
(graphed static steps, the aggressive inner loop, the clip, the encoder's
and the decoder's optimizers), driven as its training loop drives it.

Set-up: kernels from the checkout's cache, the pool and the weights made
from the seed, the port's model and epoch built on them; then the first
call of ``epoch_fn`` itself, whose steps the check compares: its first
three static steps take three distinct batches of the largest bucket (the
first eager, the second captured, the third a replay), and the parameters
(and Adam's first moments) are copied to the host at the start of the
second and the fourth step; in an aggressive cell the call runs on to its
plateau and its outer step, and the parameters are copied before the
outer step and after it. Every draw of the call, and every batch it
picked, is kept for the reference, which follows the whole call from the
same weights. Then every (mode, bucket) the window uses runs twice as a
static step, so that each is captured before the window. The window calls
``epoch_fn`` on the cell's order (``outer_per_call`` outer steps a call,
one segment, as the loop's segment ends in one read of the device) until
``--seconds`` have passed; a step is an outer step or an aggressive
sub-iteration.
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from . import compare, inputs, models
from .reference.numerics import exact_f32

ORDER_STREAM, PICK_STREAM, FIRST_STREAM = 21, 22, 23
ADAM_B1 = 0.9


@dataclass
class Window:
    seconds: float = 0.0
    steps: int = 0
    failed: int = 0
    batches: List[tuple] = field(default_factory=list)  # (mode, flat index) per step


def anneal_rate(cfg, num_batches: int) -> np.float32:
    return np.float32((1.0 - cfg.kl_start) / (cfg.warm_up * num_batches)
                      if cfg.warm_up > 0 else 0.0)


def anneal(kl, rate):
    return np.minimum(np.float32(1.0), np.float32(kl) + rate)


class TrainCell:
    def __init__(self, cell, seed: int, dev):
        from vae_lagging_encoder_tpu_torch.train import epoch as port_epoch

        self.cell, self.seed, self.dev = cell, seed, dev
        tr = cell.traffic
        self.model = m = models.model_for(cell.config, tr)
        self.aggressive = bool(tr["aggressive"])
        self.cfg = models.port_config(cell.config, {"aggressive": self.aggressive,
                                                    "nsamples": m.K})
        self.init = {**cell.config["init"], **tr.get("init", {})}
        self.groups = m.batches(tr["pool"], seed, models.TRAIN_STREAM)
        self.flat = models.flat_batches(self.groups)
        self.counts = models.counts_of(self.groups)
        w0 = m.weights(seed, dev, self.init)
        self.vae = m.build(self.cfg, w0, dev)
        del w0
        self.pool = m.port_pool(self.groups, dev)
        self.epoch_fn, opt_init = port_epoch.make_train_epoch(
            self.vae, self.pool, self.cfg, loss_fn=m.loss_fn(self.vae, self.cfg))
        self.opt = opt_init()
        self.modes = ((port_epoch.SUB, port_epoch.OUTER) if self.aggressive
                      else (port_epoch.PLAIN,))
        self.first = inputs.first_of_largest(self.counts, 3, seed, FIRST_STREAM)
        order = inputs.schedule(self.counts, seed, ORDER_STREAM)
        picks = inputs.schedule(self.counts, seed, PICK_STREAM)
        if self.aggressive:
            picks = itertools.chain(self.first, picks)
        else:
            order = itertools.chain(self.first, order)
        self.order = order
        self.noise = inputs.Noise(seed, dev, picks)
        self.kl = np.float32(self.cfg.kl_start)
        self.rate = anneal_rate(self.cfg, len(self.flat))
        self.calls = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        self.first_steps()
        self.warm_up()

    def calibration_run(self, seconds: float) -> None:
        """What the check needs, without the window's warm-up (calibrate.py)."""
        self.first_steps()

    def first_steps(self) -> None:
        """The first call of ``epoch_fn``, observed (module doc)."""
        params = dict(self.vae.named_parameters())
        self.snaps: Dict[object, Dict[str, torch.Tensor]] = {}
        outer_at = []

        def on_step(n, key):
            if n in (1, 3):
                self.snaps[n] = self._snapshot(params)
            if self.aggressive and not isinstance(key[-1], tuple):  # the outer step's key
                outer_at.append(n)
                self.snaps["pre"] = self._snapshot(params)

        self.noise.on_step, self.noise.record, self.noise.picked = on_step, {}, []
        kl = anneal(self.kl, self.rate)
        if self.aggressive:
            outer = next(self.order)
            sums, inner = self._call([outer])
            self.snaps["post"] = self._snapshot(params)
            if outer_at != [inner] or len(self.noise.picked) != inner:
                raise RuntimeError(f"the first outer step came at {outer_at} after {inner} "
                                   f"sub-iterations on {len(self.noise.picked)} picks")
            self.steps_ref = [("sub", f, kl) for f in self.noise.picked] + [("outer", outer, kl)]
            self.losses = {inner: float(sums[0]) / max(float(sums[3]), 1.0)}
        else:
            order = [next(self.order) for _ in range(4)]
            kls = list(itertools.accumulate(range(2), lambda k, _: anneal(k, self.rate),
                                            initial=kl))
            parts: List[list] = []
            self._call(order, seg=1,
                       on_segment=lambda end, n, kl, part, *rest: parts.append(part))
            self.steps_ref = [("plain", f, k) for f, k in zip(order, kls)]
            self.losses = {s: p[0] / max(p[3], 1.0) for s, p in enumerate(parts[:3])}
        if 3 not in self.snaps:
            raise RuntimeError("set-up ran fewer than four static steps")
        self.drawn = [{site: t for (n, site), t in self.noise.record.items() if n == s}
                      for s in range(len(self.steps_ref))]
        self.noise.on_step = self.noise.record = self.noise.picked = None

    def _snapshot(self, params) -> Dict[str, torch.Tensor]:
        """The parameters (and Adam's first moments, ``m:<leaf>``), copied to
        the host, out of the device's peak."""
        out = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
        if self.cfg.optim == "adam":
            out.update({f"m:{part}.{k}": v.to("cpu", copy=True)
                        for part, s in self.opt.items() for k, v in s["m"].items()})
        return out

    def warm_up(self) -> None:
        """Every (mode, bucket) of the window's steps twice, as static steps."""
        steps = self.epoch_fn.steps
        starts = np.concatenate([[0], np.cumsum(self.counts)])[:-1]
        for mode in self.modes:
            for f in starts:
                for _ in range(2):
                    key = ("warm", self.noise.steps)
                    steps.run(mode, self.pool.batch(int(f)), self.kl,
                              lambda site, shape, key=key: self.noise(key, site, shape))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # ------------------------------------------------------------ window
    def _call(self, order, **kw):
        self.calls += 1
        self.opt, self.kl, sums, inner = self.epoch_fn(
            self.opt, self.noise.tagged(self.calls), self.kl, self.cfg.lr, order,
            self.aggressive, **kw)
        return sums, inner

    def window(self, seconds: float) -> Window:
        w = Window()
        per = int(self.cell.traffic["outer_per_call"])
        mode = "outer" if self.aggressive else "plain"
        t0 = time.perf_counter()
        while True:
            order = [next(self.order) for _ in range(per)]
            self.noise.picked = picked = []
            sums, inner = self._call(order)
            n = len(order) + inner
            if len(picked) != inner:
                raise RuntimeError(f"{inner} sub-iterations ran on {len(picked)} picks")
            w.steps += n
            w.failed += 0 if math.isfinite(float(sums[0])) else n
            w.batches += [("sub", f) for f in picked] + [(mode, f) for f in order]
            if time.perf_counter() - t0 >= seconds:
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        w.seconds = time.perf_counter() - t0
        self.noise.picked = None
        return w

    def free(self) -> None:
        """Drop the program's state (its graphs, pool, optimizer, model)."""
        for k in ("epoch_fn", "opt", "vae", "pool"):
            setattr(self, k, None)

    # ------------------------------------------------------------ check
    def check(self) -> Dict[str, float]:
        """The program's compared steps against the reference's."""
        w0 = self._w0()
        got = {n: {k: v.to(self.dev) for k, v in snap.items()} for n, snap in self.snaps.items()}
        got["losses"] = self.losses
        return self._gaps(w0, got, self._full(w0))

    def control(self) -> Dict[str, float]:
        """The control: the reference one precision step down (``Products``)
        in the program's place."""
        w0 = self._w0()
        return self._gaps(w0, self._reference(w0, control=True), self._full(w0))

    def faults(self) -> Dict[str, Dict[str, float]]:
        """The faults planted in the reference put in the program's place:
        half of the rows of each of the first three steps' batches left out,
        the mean taken over the rest (``half_batch``); in an aggressive cell
        the same of the outer step's batch alone (``half_outer``)."""
        w0 = self._w0()
        out = {"half_batch": self._gaps(w0, self._reference(w0, half={0, 1, 2}), self._full(w0))}
        if self.aggressive:
            out["half_outer"] = self._gaps(
                w0, self._reference(w0, half={len(self.steps_ref) - 1}), self._full(w0))
        return out

    def _w0(self):
        return self.model.weights(self.seed, self.dev, self.init)

    def _full(self, w0) -> dict:
        if getattr(self, "_full_ref", None) is None:
            self._full_ref = self._reference(w0)
        return self._full_ref

    @staticmethod
    def leaves(mode: str, names) -> List[str]:
        """The leaves a step of ``mode`` updates: a sub-iteration the
        encoder's, the outer step the decoder's, a plain step all."""
        return sorted(k for k in names if mode == "plain" or k.startswith(
            "enc." if mode == "sub" else "dec."))

    def _grad(self, before, after, leaves) -> Dict[str, torch.Tensor]:
        """A step's gradient as the optimizer got it, worked out from the
        state around it: SGD's change of the parameters over lr; Adam's
        first moment over 1 - b1 (the leaves' first update)."""
        if self.cfg.optim == "adam":
            return {k: after["m:" + k].double() / (1.0 - ADAM_B1) for k in leaves}
        return {k: (before[k].double() - after[k].double()) / self.cfg.lr for k in leaves}

    def _gaps(self, w0, got, ref) -> Dict[str, float]:
        upd = self.leaves(self.steps_ref[0][0], w0)
        out = {"grad": compare.leaf_gap(self._grad(w0, got[1], upd), self._grad(w0, ref[1], upd),
                                        upd)}
        moved = compare.moved_leaves({k: ref["raw"][k] for k in upd})
        out["change"] = compare.leaf_gap(
            {k: got[3][k].double() - w0[k].double() for k in moved},
            {k: ref[3][k].double() - w0[k].double() for k in moved}, moved)
        if self.aggressive:
            last = len(self.steps_ref) - 1
            dec = self.leaves("outer", w0)
            out["outer_grad"] = compare.leaf_gap(self._grad(got["pre"], got["post"], dec),
                                                 self._grad(ref["pre"], ref["post"], dec), dec)
            out["outer_loss"] = compare.rel_gap(got["losses"][last], ref["losses"][last])
        else:
            out["loss"] = max(compare.rel_gap(got["losses"][s], ref["losses"][s])
                              for s in range(3))
        return out

    def _reference(self, w0, control: bool = False, half=frozenset()) -> dict:
        prods = models.products(self.model.c, control)
        with exact_f32():
            return self.reference(w0, prods, half)

    def reference(self, w0, prods, half=frozenset()) -> dict:
        """The reference over the compared steps (``steps_ref``) from ``w0``:
        the weights after the first step (``1``; Adam: with its first
        moments) and after three (``3``), the first step's raw gradient
        (``raw``), each step's mean loss, and in an aggressive cell the
        decoder around the outer step (``pre``, ``post``). The steps in
        ``half`` leave out half of their batch's rows (a fault)."""
        m, cfg = self.model, self.cfg
        names = sorted(w0)
        w = {k: v.clone() for k, v in w0.items()}
        state = {k: (torch.zeros_like(v), torch.zeros_like(v), [0]) for k, v in w.items()}
        out: dict = {"losses": {}}
        for s, (mode, f, kl) in enumerate(self.steps_ref):
            upd = self.leaves(mode, names)
            if mode == "outer":
                out["pre"] = {k: w[k].clone() for k in upd}
            leaves = {k: w[k].detach().requires_grad_() for k in names}
            batch = m.ref_batch(self.flat[f], self.dev)
            if s in half:
                rw = batch[-1].clone()
                rw[rw.shape[0] // 2:] = 0.0
                batch = (*batch[:-1], rw)
            drawn = {site: t.to(self.dev) for site, t in self.drawn[s].items()}
            mean, _ = m.ref_loss(leaves, batch, drawn, float(kl), prods)
            grads = dict(zip(names, torch.autograd.grad(mean, [leaves[k] for k in names])))
            out["losses"][s] = float(mean.detach())
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(torch.square(grads[k])) for k in names))
                finite = torch.isfinite(norm)
                scale = torch.where(finite, torch.clamp(cfg.clip_grad / (norm + 1e-6), max=1.0),
                                    torch.zeros_like(norm))
                for k in upd:
                    eff = torch.where(finite, grads[k] * scale, torch.zeros_like(grads[k]))
                    w[k] = self._update(w[k], eff, state[k])
            if s == 0:
                out["raw"] = grads
                out[1] = self._ref_snap(w, state, upd)
            if s == 2:
                out[3] = {k: w[k].clone() for k in names}
            if mode == "outer":
                out["post"] = self._ref_snap(w, state, upd)
        return out

    def _ref_snap(self, w, state, leaves) -> Dict[str, torch.Tensor]:
        out = {k: w[k].clone() for k in leaves}
        if self.cfg.optim == "adam":
            out.update({"m:" + k: state[k][0].clone() for k in leaves})
        return out

    def _update(self, p, g, mvt):
        """The port's optimizer step, operation for operation (Adam's step
        count is the leaf's own: an encoder-only step leaves the decoder's)."""
        cfg = self.cfg
        if cfg.optim == "sgd":
            return p - cfg.lr * g
        b1, b2, eps = ADAM_B1, 0.999, 1e-8
        m, v, count = mvt
        count[0] += 1
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        tf = torch.tensor(float(count[0]), device=p.device)
        mhat, vhat = 1.0 / (1.0 - b1 ** tf), 1.0 / (1.0 - b2 ** tf)
        return p - cfg.lr * (m * mhat) / (torch.sqrt(v * vhat) + eps)

    # ------------------------------------------------------------ counts
    def counts_of(self, w: Window, iw_chunk: int):
        """Model FLOPs and the port's launches with their bounds over the
        window's steps."""
        total, launches = 0.0, []
        for _, f in w.batches:
            b = self.flat[f]
            total += self.model.step_flops(b)
            launches += self.model.step_launches(b, iw_chunk)
        return total, launches

    def iw_chunk(self) -> int:
        return getattr(self.vae.dec, "iw_chunk", 1)
