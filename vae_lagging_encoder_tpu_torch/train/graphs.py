"""The training step as replays of captured CUDA graphs.

The JAX package runs a segment of an epoch as one jitted ``fori_loop``:
the host dispatches once per segment. The counterpart on the card is a
CUDA graph of the step: its kernels captured once and replayed, one launch
a step in place of the hundreds to thousands that autograd, the clip and
the per-leaf optimizer launch. ``StaticSteps`` splits a step into

- a host part, run eagerly before each replay: the step's batch is copied
  from the pool into static buffers, its ``kl_weight`` filled into a 0-dim
  device tensor, and its noise drawn from the caller's provider, site by
  site in the order the step's first (eager) run drew them, into static
  buffers;
- the static step, ``body(mode, batch, draw, kl_weight)`` (train/epoch.py):
  forward, backward, clip, the optimizer update in place and the sums,
  with no host read. It reads only static buffers, the parameters and the
  live optimizer state, whose addresses never change.

The first step of each (mode, batch shape) runs the static step eagerly
(the warm-up: the kernels are built and loaded, the noise sites recorded;
it is a real step of the epoch); every later step replays the graph of its
(mode, shape), captured at its first use. All graphs of one
``StaticSteps`` share one memory pool: what a graph leaves behind (the
gradients) is read by nothing outside it, and every input and output it
shares with the host lives outside the pool.

The kernel wrappers count ``ops/build.py::LAUNCHES`` when they launch,
which a replay does not pass through: the counts a capture adds are taken
back and added again at every replay, so ``LAUNCHES`` still counts the
kernels that ran (chip_smoke.py's phase 9 holds these counts against the
kernels in a profiler trace). ``GRAPHS`` counts captures and replays.
Under a profiler a step is the span ``step`` (its mode, the batch's
shape, its path: eager, capture or replay) and a graphed step's children
``fill`` (the host part) and ``replay`` (with its device time); see
utils/profiling.py.

Graphs are off (the static step is called eagerly, through the same host
part) on the CPU, under a mesh (its ``gloo`` collectives go through the
host and cannot be captured) and when the caller asks (``graphs=False``,
chip_smoke.py's eager comparison); ``off_reason`` says which. On the card
a capture or a replay that fails raises: there is no eager fallback.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops.build import GRAPHS, LAUNCHES
from ..utils.profiling import NO_SPAN, span, tracing

def off_reason(dev: torch.device, mesh, graphs: bool) -> Optional[str]:
    """Why the training step runs eagerly here, or None on the card."""
    if not graphs:
        return "graphs=False (the eager comparison)"
    if mesh is not None:
        return "a mesh: its gloo collectives go through the host and cannot be captured"
    if dev.type != "cuda":
        return f"the {dev.type} runs the static step eagerly"
    return None


def capture(fn: Callable[[], None], mempool) -> Callable[[], None]:
    """``fn``'s device work captured into one CUDA graph in ``mempool``
    (nothing runs); returns the graph's replay. Python's cyclic garbage
    collector is run first and held off during the capture: it would
    otherwise free unreachable graphs (a finished run's) at any allocation,
    and destroying a graph is not permitted while a stream captures (the
    capture is invalidated)."""
    g = torch.cuda.CUDAGraph()
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(g, pool=mempool):
            fn()
    finally:
        if was_enabled:
            gc.enable()
    return g.replay


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


class _Slot:
    """One step's static inputs: batch, ``kl_weight``, noise per site."""

    def __init__(self, batch: Sequence[torch.Tensor], sites, dev):
        self.batch = tuple(torch.empty_like(b, device=dev) for b in batch)
        self.kl = torch.zeros((), device=dev)
        self.noise = {site: torch.empty(shape, dtype=dt, device=dev)
                      for site, shape, dt in sites}

    def fill(self, batch, kl, draw, sites) -> None:
        for buf, b in zip(self.batch, batch):
            buf.copy_(b)
        self.kl.fill_(float(kl))
        for site, shape, _ in sites:
            self.noise[site].copy_(draw(site, shape))

    def draw(self, site: str, shape) -> torch.Tensor:
        buf = self.noise[site]
        if tuple(buf.shape) != tuple(shape):
            raise ValueError(f"noise site {site!r}: shape {tuple(shape)} differs from the "
                             f"warm-up's {tuple(buf.shape)}")
        return buf


class StaticSteps:
    """Runs static steps (module docstring). ``body(mode, batch, draw,
    kl_weight)`` is the static step; ``lr`` the 0-dim device tensor it
    reads the learning rate from; ``state`` the live optimizer state
    (``bind``). ``stats``: eager steps, steps run as replays, capture
    seconds, since construction."""

    def __init__(self, body: Callable, dev: torch.device, reason: Optional[str]):
        self.body, self.dev, self.off = body, dev, reason
        self.lr = torch.zeros((), device=dev)
        self.kl = torch.zeros((), device=dev)  # the eager steps' kl_weight
        self.state = None
        self.sites: Dict[tuple, list] = {}     # (mode, shape) -> [(site, shape, dtype)]
        # (mode, shape) -> (slot, replay, launches)
        self.graphs: Dict[tuple, tuple] = {}
        self.mempool = None
        self.stats = {"eager_steps": 0, "graph_steps": 0, "capture_seconds": 0.0}

    def bind(self, opt_state):
        """The live optimizer state: the first state seen; a later state
        made elsewhere (a rollback's fresh one, a resume's loaded one) is
        copied into it, so the captured graphs' addresses stay valid."""
        if self.state is None:
            self.state = opt_state
        elif opt_state is not self.state:
            live, new = list(_leaves(self.state)), list(_leaves(opt_state))
            if [p for p, _ in live] != [p for p, _ in new]:
                raise ValueError("optimizer state of another structure than the live one")
            with torch.no_grad():
                for (_, a), (_, b) in zip(live, new):
                    if a is not b:
                        a.copy_(b)
        return self.state

    def run(self, mode: str, batch, kl, draw: Callable) -> None:
        """One step: eagerly when graphs are off or for the warm-up of its
        (mode, batch shape), else as a replay of that shape's graph (the
        span ``step``, its children ``fill`` and ``replay``)."""
        key = (mode, tuple(tuple(b.shape) for b in batch))
        path = ("eager" if self.off is not None or key not in self.sites
                else "replay" if key in self.graphs else "capture")
        # the attrs are built only while tracing is on
        with (span("step", mode=mode, shape=key[1][0], path=path) if tracing() else NO_SPAN):
            if path == "eager":
                self._eager(key, batch, kl, draw)
                return
            if path == "capture":
                self.graphs[key] = self._capture(mode, _Slot(batch, self.sites[key], self.dev))
            slot, replay, launches = self.graphs[key]
            with span("fill"):
                slot.fill(batch, kl, draw, self.sites[key])
            with span("replay", device=True):
                replay()
        for name, n in launches.items():
            LAUNCHES[name] += n
        GRAPHS["replays"] += 1
        self.stats["graph_steps"] += 1

    def _eager(self, key: tuple, batch, kl, draw: Callable) -> None:
        self.kl.fill_(float(kl))
        if self.off is None:  # the warm-up: record the noise sites
            sites = []

            def recording(site, shp):
                t = draw(site, shp)
                sites.append((site, tuple(shp), t.dtype))
                return t

            self.body(key[0], batch, recording, self.kl)
            self.sites[key] = sites
        else:
            self.body(key[0], batch, draw, self.kl)
        self.stats["eager_steps"] += 1

    def _capture(self, mode: str, slot: _Slot):
        if self.mempool is None and self.dev.type == "cuda":
            self.mempool = torch.cuda.graph_pool_handle()
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        replay = capture(lambda: self.body(mode, slot.batch, slot.draw, slot.kl), self.mempool)
        self.stats["capture_seconds"] += time.perf_counter() - t0
        launches = {name: LAUNCHES[name] - before[name] for name in LAUNCHES}
        LAUNCHES.update(before)  # nothing ran: the replays count
        GRAPHS["captured"] += 1
        return slot, replay, launches
