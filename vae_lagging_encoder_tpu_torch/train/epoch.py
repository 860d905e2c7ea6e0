"""Training epoch and the evaluators over a pool: ELBO, MI, active units,
importance-weighted NLL.

Counterparts of ``vae_lagging_encoder_tpu/train/epoch.py``:
``make_loss_fn`` (text) and ``make_image_loss_fn`` (images: a fresh
Bernoulli binarization, then the same loss), each in training and
evaluation mode, the eval binarization ``binarize_prep``, the step body of
``make_train_epoch``, and the evaluators ``make_eval_fn``, ``make_mi_fn``,
``make_au_fn``, ``make_iwnll_fn``. Where the JAX package compiles one fused
program per epoch segment, a training epoch here runs its segments as
replays of CUDA graphs of the step (train/graphs.py), one read of the
device at each segment's end. Where it compiles one per evaluator, each
evaluator here is a host loop over batches that accumulates on the device
and reads the sums back once at the end, so nothing waits on the host
between batches and there is no dispatch to bound (the JAX package's
``EVAL_SEGMENT`` has no counterpart); they run eagerly.
A batch is ``(tokens, mask, row_weight)`` for text and ``(probs,
row_weight)`` for images; the MI, AU and IW evaluators take a ``prep``
that turns it into ``(x, mask, row_weight)`` (``unpack`` for text,
``binarize_prep`` for images), and the unit of the PPL is a predicted
word for text, a pixel for images (``unit_count``).

Noise comes from a ``noise(i, site, shape)`` provider. Evaluators pass the
flat batch index ``i`` and sites ``"elbo"`` (eps [B, nsamples, nz]),
``"mi"`` ([B, 1, nz]) and ``"iw<j>"`` for IW chunk ``j`` ([B, ns, nz]), and
for images the binarization uniforms ``"elbo_bin"``, ``"mi_bin"``,
``"au_bin"`` (one draw per batch that both AU passes use) and ``"iw_bin"``
([B, H, W, C]). A training epoch passes the step's index ``i`` for the
outer step and ``(i, sub)`` for sub-iteration ``sub`` of its aggressive
inner loop, with sites ``"eps"`` (normal [B, nsamples, nz]), ``"bin"``
(images: the binarization uniforms), ``"keep_in"`` / ``"keep_out"``
(uniform [0, 1) dropout draws) and, in the inner loop, ``"pick"``: an int
uniform in ``[0, shape[0])``, the flat index of the sub-iteration's batch.
With more z-samples than the decoder's ``iw_chunk``, training draws its
dropout per chunk ``c`` (sites ``"keep_in<c>"``, ``"keep_out<c>"``; see
models/dec_lstm.py). ``GeneratorNoise`` draws from seeded ``torch.Generator``s
(picks on the host, so that choosing a batch never waits for the device)
whose states it can read and restore; ``IndexedNoise``, the evaluators'
default, draws each ``(i, site)`` from its own seeded generator, so that a
batch's noise does not depend on which batches were drawn before it; a
test can instead hand in the JAX package's exact draws. A binarization
is ``uniform < probs``, which is what the JAX package's ``bernoulli(key,
probs)`` computes.

Under a ``mesh`` (parallel/dp.py) the training epoch takes this rank's
rows of every batch and sums every gradient over dp (``make_grad_on``),
with a tp group its loss is vocab-sharded (parallel/tp.py), and each
evaluator takes whole batches (``_my_batches``) and sums over dp once at
the end.
"""
from __future__ import annotations

import math
import zlib
from functools import partial
from typing import Callable, Dict, Tuple

import torch

import numpy as np

from ..data.pool import Pool
from ..models.vae import VAE
from . import graphs as graphs_mod
from .aggressive import grads_of, make_aggressive_inner, make_grad_on
from .optim import clip_scale, make_optimizer

# the static step's modes: a plain step (encoder and decoder update), an
# aggressive outer step (decoder only) and an inner sub-iteration (encoder only)
PLAIN, OUTER, SUB = "plain", "outer", "sub"

Noise = Callable[[object, str, Tuple[int, ...]], object]


def stream_seed(seed: int, *stream) -> int:
    """A generator seed for the stream ``stream`` (ints and strings) of
    ``seed``, independent of the other streams' draws."""
    ids = [zlib.crc32(x.encode()) if isinstance(x, str) else int(x) for x in stream]
    state = np.random.SeedSequence([int(seed), *ids]).generate_state(1, dtype=np.uint64)[0]
    return int(state >> np.uint64(1))


def _draw(g: torch.Generator, device, site: str, shape: Tuple[int, ...]):
    """Uniforms for ``"keep*"`` and the ``"*bin"`` sites, normals otherwise."""
    if site.startswith("keep") or site.endswith("bin"):
        return torch.rand(shape, generator=g, device=device)
    return torch.randn(shape, generator=g, device=device)


class GeneratorNoise:
    """A ``noise(i, site, shape)`` provider drawing in call order from two
    generators: normals for the eps sites and uniforms for ``"keep*"`` and
    the ``"*bin"`` sites from one on ``device``, the int of ``"pick"`` from
    one on the host, both seeded with ``seed``. With ``fold`` (a dp rank's
    index under data parallelism, parallel/dp.py) the device generator
    draws the ``(seed, fold)`` stream instead; fold 0 keeps ``seed``'s, so
    dp rank 0 draws what one process would, and the host's picks never
    fold. ``get_state`` / ``set_state`` read and restore both generators,
    so that a mid-epoch autosave can carry them."""

    def __init__(self, seed: int, device, fold: int = 0):
        self.device = device
        self.g = torch.Generator(device=device).manual_seed(
            stream_seed(seed, fold) if fold else seed)
        self.g_host = torch.Generator().manual_seed(seed)

    def __call__(self, i, site: str, shape: Tuple[int, ...]):
        if site == "pick":
            return int(torch.randint(shape[0], (), generator=self.g_host))
        return _draw(self.g, self.device, site, shape)

    def get_state(self) -> Dict[str, np.ndarray]:
        """Both generators' states as uint8 numpy arrays."""
        return {"device": self.g.get_state().numpy().copy(),
                "host": self.g_host.get_state().numpy().copy()}

    def set_state(self, state: Dict[str, np.ndarray]) -> None:
        self.g.set_state(torch.from_numpy(np.asarray(state["device"], dtype=np.uint8)))
        self.g_host.set_state(torch.from_numpy(np.asarray(state["host"], dtype=np.uint8)))


class IndexedNoise:
    """A ``noise(i, site, shape)`` provider whose every ``(i, site)`` draws
    from a generator of its own, seeded from ``(seed, i, site)``: a draw
    does not depend on the draws made before it (the JAX package's
    ``fold_in(key, i)`` per batch). The evaluators' provider: split over dp
    ranks by batch, each rank draws batch ``i``'s noise as one process
    would."""

    def __init__(self, seed: int, device):
        self.seed, self.device = seed, device

    def __call__(self, i, site: str, shape: Tuple[int, ...]):
        g = torch.Generator(device=self.device).manual_seed(stream_seed(self.seed, i, site))
        return _draw(g, self.device, site, shape)


def _safe_exp(x: float) -> float:
    try:
        return math.exp(x)
    except OverflowError:
        return float("inf")


def unit_count(x, mask, row_weight) -> torch.Tensor:
    """Units of the PPL: predicted words for text, pixels for images."""
    if mask is not None:
        return (mask[:, 1:] * row_weight[:, None]).sum()
    return row_weight.sum() * float(np.prod(x.shape[1:]))


def unpack(batch, uniform):
    """Eval prep of text batches: ``(tokens, mask, row_weight)`` as they are."""
    return batch


def binarize_prep(batch, uniform):
    """Eval prep of image batches: ``(probs, row_weight)`` -> ``(x, None,
    row_weight)``, x a fresh binarization ``uniform(probs.shape) < probs``."""
    probs, row_weight = batch
    return (uniform(tuple(probs.shape)) < probs).to(probs.dtype), None, row_weight


def make_loss_fn(vae: VAE, nsamples: int = 1, train: bool = False) -> Callable:
    """``loss_fn(batch, draw, kl_weight=1.0) -> (mean_loss, (loss_sum,
    rec_sum, kl_sum, n_sents, n_words))`` for ``batch = (x, mask,
    row_weight)``; mean_loss, the objective, is per real sentence (image).
    ``draw(site, shape)`` gives the step's draws: in training mode all of
    them (eps and the dropout uniforms), in evaluation mode eps only."""

    def loss_fn(batch, draw, kl_weight=1.0):
        x, mask, row_weight = batch
        if train:
            noise = dict(draw=draw)
        else:
            noise = dict(eps=draw("eps", (x.shape[0], nsamples, vae.nz)))
        loss, rec, kl = vae.loss(x, mask, row_weight, kl_weight=kl_weight,
                                 nsamples=nsamples, **noise)
        n_sents = row_weight.sum()
        loss_sum = loss.sum()
        return loss_sum / torch.clamp(n_sents, min=1.0), (
            loss_sum, rec.sum(), kl.sum(), n_sents, unit_count(x, mask, row_weight))

    return loss_fn


def make_image_loss_fn(vae: VAE, nsamples: int = 1, train: bool = False) -> Callable:
    """``make_loss_fn`` for ``batch = (probs, row_weight)``: the images are
    binarized afresh on every call from ``draw("bin", probs.shape)``; the
    "words" of the aux sums are pixels."""
    loss_fn = make_loss_fn(vae, nsamples, train)

    def image_loss_fn(batch, draw, kl_weight=1.0):
        return loss_fn(binarize_prep(batch, lambda shape: draw("bin", shape)), draw, kl_weight)

    return image_loss_fn


def make_train_epoch(vae: VAE, pool: Pool, cfg, loss_fn: Callable | None = None,
                     mesh=None, graphs: bool = True) -> Tuple[Callable, Callable]:
    """``(epoch_fn, opt_init)``: the step loop of one training epoch and the
    initial ``{"enc": ..., "dec": ...}`` optimizer state (two separate
    optimizers, as the reference has).

    ``epoch_fn(opt_state, noise, kl_weight, lr, order, aggressive,
    seg=None, on_segment=None, start=0, sums=None, inner_iters=0,
    max_steps=None) -> (opt_state, kl_weight, sums, inner_iters)`` runs one
    outer step per flat batch index of ``order[start:]`` (step ``i`` draws
    with index ``i``, so a run re-entered at ``start`` draws what the whole
    epoch would have, given the noise's state). Each step anneals the KL
    weight first (``min(1, kl_weight + anneal_rate)`` in f32, as at the top
    of the reference's batch loop), then, while ``aggressive``, runs the
    inner loop (encoder-only updates to a plateau), then takes the outer
    update: decoder-only while aggressive, encoder and decoder otherwise,
    always with the clip over the full gradient.

    The steps run in segments of ``seg`` (the JAX package's
    ``--epoch_segment`` grid ``[0, seg), [seg, 2 seg), ...``; None or 0:
    one segment; ``start`` lies on the grid). Inside a segment the host
    reads nothing from the device: the steps' sums [5] (loss, rec, KL,
    sentences, words) accumulate there, and are read once at the segment's
    end, added to ``sums`` (f64 on the host, carried in from ``sums`` when
    re-entering), and handed to ``on_segment(end, n, kl_weight, seg_sums,
    opt_state, sums, inner_iters)`` (``n`` steps ending before ``end``; the
    caller's log and autosave cadence). ``max_steps`` stops the epoch after
    that many outer steps, inside a segment if it falls there, as a crash
    there would (the caller's test hook). ``sums`` is returned as a [5]
    float64 tensor; ``opt_state`` is the live state (train/graphs.py), into
    which a state made elsewhere is copied. ``loss_fn`` (training mode)
    defaults to the text loss.

    Each step is a static step (train/graphs.py): on the card without a
    ``mesh`` a replay of a captured CUDA graph, after one eager warm-up per
    (mode, batch shape). ``cfg.loop_unroll`` (the JAX package's unrolled
    plain loop, a scheduling knob that leaves the result bit for bit) is
    accepted and changes nothing here: a step is one replay at any k,
    since k steps in one graph measured no faster (PERF.md).
    ``graphs=False`` runs every step eagerly (a comparison's reference);
    ``epoch_fn.steps.off`` says why a run is eager.

    With a ``mesh`` (parallel/dp.py; the pool batch-sharded by
    ``pool.shard(mesh)``) every gradient, outer and inner, is summed over
    dp (``make_grad_on``); with a tp group as well the loss is the
    vocab-sharded ``parallel.tp.make_tp_loss_fn`` (a caller's loss cannot be
    sharded, so it is refused) and the clip ``clip_scale_tp``."""
    scale_fn = clip_scale
    if mesh is not None and mesh.tp > 1:
        if loss_fn is not None:
            raise ValueError("tensor parallelism builds its own vocab-sharded loss "
                             "(parallel.tp.make_tp_loss_fn); pass loss_fn=None")
        from ..parallel.tp import clip_scale_tp, make_tp_loss_fn

        loss_fn = make_tp_loss_fn(vae, mesh, nsamples=cfg.nsamples, train=True)
        scale_fn = partial(clip_scale_tp, mesh=mesh)
    loss_fn = loss_fn or make_loss_fn(vae, nsamples=cfg.nsamples, train=True)
    grad_on = make_grad_on(vae, loss_fn, mesh)
    opt_init_part, opt_update = make_optimizer(cfg.optim, momentum=cfg.momentum)
    params = dict(vae.named_parameters())
    enc = dict(vae.enc.named_parameters())
    dec = dict(vae.dec.named_parameters())
    dev = next(iter(params.values())).device
    # what each mode of the static step updates
    parts = {PLAIN: (("enc", enc), ("dec", dec)), OUTER: (("dec", dec),),
             SUB: (("enc", enc),)}
    seg_sums = torch.zeros(5, device=dev)
    cur, words = torch.zeros((), device=dev), torch.zeros((), device=dev)

    def body(mode, batch, draw, kl_weight):
        """The static step: no host read, fixed addresses."""
        aux = grad_on(batch, draw, kl_weight)
        scale, _, finite = scale_fn(grads_of(params), cfg.clip_grad)
        for part, ps in parts[mode]:
            opt_update(ps, grads_of(ps), steps.state[part], steps.lr, scale=scale,
                       finite=finite)
        if mode == SUB:
            cur.add_(aux[0].detach())
            words.add_(aux[4])
        else:
            seg_sums.add_(torch.stack([a.detach() for a in aux]))

    steps = graphs_mod.StaticSteps(body, dev, graphs_mod.off_reason(dev, mesh, graphs))
    inner = make_aggressive_inner(lambda batch, draw, kl: steps.run(SUB, batch, kl, draw),
                                  pool, cfg.burn_max_iters, cfg.burn_window, cur, words,
                                  mesh=mesh)
    # warm_up <= 0 is valid only with kl_start 1.0 (run_training checks)
    anneal_rate = np.float32((1.0 - cfg.kl_start) / (cfg.warm_up * pool.num_batches)
                             if cfg.warm_up > 0 else 0.0)

    def opt_init():
        return {"enc": opt_init_part(enc), "dec": opt_init_part(dec)}

    def anneal(kl_weight):
        return np.minimum(np.float32(1.0), np.float32(kl_weight) + anneal_rate)

    def epoch_fn(opt_state, noise: Noise, kl_weight, lr, order, aggressive: bool,
                 seg: int | None = None, on_segment: Callable | None = None, start: int = 0,
                 sums=None, inner_iters: int = 0, max_steps: int | None = None):
        opt_state = steps.bind(opt_state)
        steps.lr.fill_(float(lr))
        n = len(order)
        seg = seg or n
        total = [0.0] * 5 if sums is None else [float(x) for x in (
            sums.tolist() if torch.is_tensor(sums) else sums)]
        stop = n if max_steps is None else min(n, start + max_steps)
        lo = start
        while lo < stop:
            hi = min((lo // seg + 1) * seg, n)  # this segment's end on the grid
            seg_sums.zero_()
            for i in range(lo, min(hi, stop)):
                kl_weight = anneal(kl_weight)
                if aggressive:
                    inner_iters += inner(
                        lambda sub, i=i: (lambda site, shape: noise((i, sub), site, shape)),
                        kl_weight)
                steps.run(OUTER if aggressive else PLAIN, pool.batch(int(order[i])), kl_weight,
                          lambda site, shape, i=i: noise(i, site, shape))
            if stop < hi:
                break  # stopped inside the segment
            part = seg_sums.tolist()  # the segment's one read of the device
            total = [a + b for a, b in zip(total, part)]
            if on_segment is not None:
                on_segment(hi, hi - lo, kl_weight, part, opt_state, total, inner_iters)
            lo = hi
        return opt_state, kl_weight, torch.tensor(total, dtype=torch.float64), inner_iters

    epoch_fn.steps = steps
    return epoch_fn, opt_init


def _my_batches(pool: Pool, mesh) -> range:
    """The flat batch indices this rank evaluates: all of them in one
    process; under a mesh dp rank ``d`` takes the whole batches
    ``[d * ceil(n / dp), ...)`` (the JAX package's ``make_pool_reducer``
    mesh branch), keeping each batch's index and so its noise; tp members
    of a dp rank take the same batches. The evaluators loop over them on
    the host, eagerly (module docstring: their sums stay on the device
    until one read at the end, so there is no segment to bound)."""
    n = pool.num_batches
    if mesh is None:
        return range(n)
    per = -(-n // mesh.dp)
    return range(min(n, mesh.dp_index * per), min(n, (mesh.dp_index + 1) * per))


def _sum_over_dp(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the dp ranks (nothing in one process)."""
    if mesh is None:
        return t
    from ..parallel.dp import all_reduce

    return all_reduce(t, mesh.dp_group)


def make_eval_fn(vae: VAE, pool: Pool, nsamples: int = 1,
                 loss_fn: Callable | None = None, mesh=None) -> Callable:
    """ELBO evaluation: ``eval_fn(noise) -> dict(loss, rec, kl, nll per
    sentence; ppl; n_sents, n_words)``. ``loss_fn`` (evaluation mode)
    defaults to the text loss; its draws ``"eps"`` and ``"bin"`` are the
    sites ``"elbo"`` and ``"elbo_bin"``. Under a ``mesh`` with a tp group
    the loss is the vocab-sharded ``make_tp_loss_fn``."""
    if mesh is not None and mesh.tp > 1:
        if loss_fn is not None:
            raise ValueError("tensor parallelism builds its own vocab-sharded eval loss; "
                             "pass loss_fn=None")
        from ..parallel.tp import make_tp_loss_fn

        loss_fn = make_tp_loss_fn(vae, mesh, nsamples)
    loss_fn = loss_fn or make_loss_fn(vae, nsamples)

    @torch.no_grad()
    def eval_fn(noise: Noise) -> Dict[str, float]:
        sums = torch.zeros(5, device=pool.arrays[0][0].device)
        for i in _my_batches(pool, mesh):
            _, out = loss_fn(pool.batch(i), lambda site, shape, i=i: noise(
                i, "elbo" if site == "eps" else f"elbo_{site}", shape))
            sums = sums + torch.stack(out)
        loss_s, rec_s, kl_s, n_sent, n_words = _sum_over_dp(sums, mesh).tolist()
        return {"loss": loss_s / n_sent, "rec": rec_s / n_sent, "kl": kl_s / n_sent,
                "nll": (rec_s + kl_s) / n_sent,
                "ppl": _safe_exp((rec_s + kl_s) / n_words),
                "n_sents": n_sent, "n_words": n_words}

    return eval_fn


def _prepped(pool: Pool, prep: Callable, noise: Noise, site: str, mesh=None):
    """``(i, (x, mask, row_weight))`` for this rank's batches (``_my_batches``),
    binarized (images) from site ``site``."""
    for i in _my_batches(pool, mesh):
        yield i, prep(pool.batch(i), lambda shape, i=i: noise(i, site, shape))


def make_mi_fn(vae: VAE, pool: Pool, prep: Callable = unpack, mesh=None) -> Callable:
    """Corpus MI: batch-size-weighted mean of per-batch MI estimates (the
    encoder's alone, so under tp it is computed alike on every member)."""

    @torch.no_grad()
    def mi_fn(noise: Noise) -> float:
        sums = torch.zeros(2, device=pool.arrays[0][0].device)
        for i, (x, mask, row_weight) in _prepped(pool, prep, noise, "mi_bin", mesh):
            eps = noise(i, "mi", (x.shape[0], 1, vae.nz))
            n = row_weight.sum()
            sums = sums + torch.stack([vae.calc_mi_q(x, mask, row_weight, eps) * n, n])
        mi_sum, n_sum = _sum_over_dp(sums, mesh).tolist()
        return mi_sum / max(n_sum, 1.0)

    return mi_fn


def make_au_fn(vae: VAE, pool: Pool, delta: float = 0.01,
               prep: Callable = unpack, mesh=None) -> Callable:
    """Active units: #dims with Var_x[mu(x)] > delta, in two passes over the
    same prepped batches (for images: one binarization per batch); under a
    mesh the mean is summed over dp between the passes."""

    @torch.no_grad()
    def au_fn(noise: Noise) -> Tuple[int, torch.Tensor]:
        batches = [b for _, b in _prepped(pool, prep, noise, "au_bin", mesh)]
        acc = torch.zeros(vae.nz + 1, device=pool.arrays[0][0].device)
        for x, mask, row_weight in batches:
            mu = vae.calc_infer_mean(x, mask)
            acc = acc + torch.cat([torch.sum(mu * row_weight[:, None], dim=0),
                                   row_weight.sum()[None]])
        acc = _sum_over_dp(acc, mesh)
        mu_sum, n = acc[:-1], acc[-1]
        mu_mean = mu_sum / torch.clamp(n, min=1.0)
        var_sum = torch.zeros_like(mu_sum)
        for x, mask, row_weight in batches:
            mu = vae.calc_infer_mean(x, mask)
            var_sum = var_sum + torch.sum((mu - mu_mean) ** 2 * row_weight[:, None], dim=0)
        var_sum = _sum_over_dp(var_sum, mesh)
        var = (var_sum / torch.clamp(n - 1.0, min=1.0)).cpu()
        return int((var > delta).sum()), var

    return au_fn


def make_iwnll_fn(vae: VAE, pool: Pool, nsamples: int = 500, ns: int = 100,
                  prep: Callable = unpack, mesh=None) -> Callable:
    """Importance-weighted NLL + PPL over a pool (the reference's
    calc_iwnll); under a mesh with a tp group the decoder's likelihood is
    vocab-sharded (``parallel.tp.tp_nll_iw``)."""
    if mesh is not None and mesh.tp > 1:
        from ..parallel.tp import tp_nll_iw

        def nll_fn(x, mask, noise):
            return tp_nll_iw(vae, x, mask, nsamples, ns, noise=noise, group=mesh.tp_group)
    else:
        def nll_fn(x, mask, noise):
            return vae.nll_iw(x, mask, nsamples, ns, noise=noise)

    @torch.no_grad()
    def iwnll_fn(noise: Noise) -> Dict[str, float]:
        sums = torch.zeros(3, device=pool.arrays[0][0].device)
        for i, (x, mask, row_weight) in _prepped(pool, prep, noise, "iw_bin", mesh):
            nll = nll_fn(x, mask, lambda j, shape, i=i: noise(i, f"iw{j}", shape))
            sums = sums + torch.stack([(nll * row_weight).sum(), row_weight.sum(),
                                       unit_count(x, mask, row_weight)])
        nll_sum, n_sent, n_words = _sum_over_dp(sums, mesh).tolist()
        return {"nll": nll_sum / n_sent, "ppl": _safe_exp(nll_sum / n_words),
                "n_sents": n_sent, "n_words": n_words}

    return iwnll_fn
