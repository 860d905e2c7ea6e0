"""Data parallelism over ``torch.distributed``.

Counterpart of ``vae_lagging_encoder_tpu/parallel/dp.py``: each rank holds
the whole model and ``B / dp`` contiguous rows of every batch
(``shard_batch``, ``Pool.shard``); each computes the gradient of its
``loss_sum / all_reduce(n_sents)`` (the reference's objective is the batch
mean of the per-sentence loss, and pad rows make the per-rank counts
unequal), and the gradients and the step's sums are summed over ``dp``
with ONE flat all-reduce per step (``reduce_grads``; the text model's
gradient is ~216 MB, a collective per leaf would cost a launch and a
synchronization each). The clip follows the reduce, on identical
gradients on every rank, so every replica takes the same update.

``Mesh`` is the layout of one rank: its rank, its dp and tp indices, the
``dp`` group (the ranks that share its tp index, hence its vocab shard of
``dec.pred``) and the ``tp`` group (the ranks that share its dp index,
hence its rows), and its device. A group of one rank is ``None`` and its
collectives are skipped; a mesh of one rank needs no process group.

Noise: the JAX package folds the dp index, and only it, into the step's
key; here every per-rank draw of training (eps, dropout, binarization)
comes from the ``(seed, dp index)`` stream (``GeneratorNoise(...,
fold=mesh.dp_index)``), so tp members draw alike and their hidden states
agree without a collective, while the batch picks of the aggressive loop,
the epoch order and every host decision come from unfolded streams.

``emulated_dp_loss`` and ``EmulatedNoise`` are the single-process oracle
of a DP step (tests/test_parallel.py::_emulated_dp_loss of the JAX
package): the loss summed shard by shard, each shard on its own rank's
draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """One rank's place in a ``dp x tp`` layout (module docstring)."""
    dp: int
    tp: int
    rank: int
    dp_index: int
    tp_index: int
    dp_group: Optional[object]
    tp_group: Optional[object]
    device: torch.device

    @property
    def world(self) -> int:
        return self.dp * self.tp

    def same(self, values: Sequence[float]) -> List[float]:
        """``values`` as rank 0 holds them, on every rank (a broadcast over
        all ranks): the inputs of a host decision, so that no rank can
        decide otherwise than the others after a last-bit difference."""
        if self.world == 1:
            return [float(v) for v in values]
        t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0)
        return t.tolist()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over ``group`` (returned); nothing for ``None``."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def make_tp_mesh(dp: int, tp: int, device) -> Mesh:
    """This rank's ``Mesh`` in a ``dp x tp`` layout, creating its groups
    (every rank creates every group, in one order, as ``new_group``
    requires). Rank ``r`` is dp index ``r // tp``, tp index ``r % tp``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != dp * tp:
        raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} ranks, the process group has "
                         f"{world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dp_index, tp_index = divmod(rank, tp)
    dp_group = tp_group = None
    if dp > 1:
        for t in range(tp):
            g = dist.new_group([d * tp + t for d in range(dp)])
            if t == tp_index:
                dp_group = g
    if tp > 1:
        for d in range(dp):
            g = dist.new_group([d * tp + t for t in range(tp)])
            if d == dp_index:
                tp_group = g
    return Mesh(dp, tp, rank, dp_index, tp_index, dp_group, tp_group, torch.device(device))


def make_mesh(n_devices: int, device) -> Mesh:
    """A dp-only mesh of ``n_devices`` ranks."""
    return make_tp_mesh(n_devices, 1, device)


def shard_rows(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This dp rank's contiguous rows of ``t`` along ``dim`` (the JAX
    package's ``P("dp")`` placement): rows ``[d * B/dp, (d + 1) * B/dp)``."""
    n = t.shape[dim]
    if n % mesh.dp:
        raise ValueError(f"batch dim {n} is not divisible by {mesh.dp} dp ranks")
    per = n // mesh.dp
    return t.narrow(dim, mesh.dp_index * per, per)


def shard_batch(mesh: Mesh, *arrays: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """This dp rank's rows of each batch array (batch dim 0)."""
    return tuple(shard_rows(mesh, a) for a in arrays)


def global_rows(mesh: Optional[Mesh], row_weight: torch.Tensor) -> torch.Tensor:
    """The real rows of the whole batch: ``row_weight`` summed over dp."""
    n = row_weight.sum()
    return n if mesh is None else all_reduce(n, mesh.dp_group)


def reduce_grads(params: Dict[str, torch.nn.Parameter], aux: Sequence[torch.Tensor],
                 mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """Sum every parameter's ``.grad`` and the step's ``aux`` sums over dp
    in ONE all-reduce of a flat buffer; the gradients are written back in
    place, the summed aux returned. Under tp the vocab shard's gradient of
    ``dec.pred`` is summed with the same shard's on the other dp ranks."""
    aux = torch.stack([a.detach().reshape(()).to(torch.float32) for a in aux])
    if mesh.dp_group is None:
        return tuple(aux)
    grads = [p.grad for p in params.values()]
    flat = torch.cat([g.reshape(-1) for g in grads] + [aux])
    dist.all_reduce(flat, group=mesh.dp_group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return tuple(flat[off:])


def make_dp_train_step(vae, cfg, mesh: Mesh) -> Callable:
    """One joint encoder + decoder step of the text VAE on a global batch,
    data-parallel: ``step(batch, draw, kl_weight, lr) -> aux`` for this
    rank's rows ``batch`` and its draws ``draw(site, shape)``; the update
    (plain SGD after the global-norm clip at ``cfg.clip_grad``) is written
    into ``vae``'s parameters; ``aux`` (loss, rec, KL, sentences, words)
    are the whole batch's sums."""
    from ..train.aggressive import grads_of, make_grad_on
    from ..train.epoch import make_loss_fn
    from ..train.optim import clip_scale, make_optimizer

    grad_on = make_grad_on(vae, make_loss_fn(vae, nsamples=cfg.nsamples, train=True), mesh)
    _, sgd = make_optimizer("sgd")
    params = dict(vae.named_parameters())

    def step(batch, draw, kl_weight, lr):
        aux = grad_on(batch, draw, kl_weight)
        scale, _, finite = clip_scale(grads_of(params), cfg.clip_grad)
        sgd(params, grads_of(params), {}, lr, scale=scale, finite=finite)
        return aux

    return step


def emulated_dp_loss(loss_fn: Callable, n_shards: int) -> Callable:
    """The single-process oracle of a DP step: ``loss_fn`` (the
    ``(batch, draw, kl_weight) -> (mean_loss, aux)`` contract) applied to
    each of ``n_shards`` contiguous row blocks of the batch with that
    shard's draws (site ``"<site>@<s>"``, see ``EmulatedNoise``), the
    objective ``sum_s loss_sum_s / n_global`` and the aux summed. Its
    gradient is the sum of the shards' gradients, which is what the DP
    ranks all-reduce."""

    def wrapped(batch, draw, kl_weight=1.0):
        per = batch[0].shape[0] // n_shards
        n_global = torch.clamp(batch[-1].sum(), min=1.0)
        total, sums = 0.0, None
        for s in range(n_shards):
            shard = tuple(a[s * per:(s + 1) * per] for a in batch)
            _, aux = loss_fn(shard, lambda site, shape, s=s: draw(f"{site}@{s}", shape),
                             kl_weight)
            total = total + aux[0] / n_global
            sums = aux if sums is None else tuple(a + b for a, b in zip(sums, aux))
        return total, sums

    return wrapped


class EmulatedNoise:
    """A ``noise(i, site, shape)`` provider for ``emulated_dp_loss``:
    ``"<site>@<s>"`` draws from ``noises[s]`` (the provider dp rank ``s``
    would hold), the batch picks (``"pick"``) from ``noises[0]``."""

    def __init__(self, noises: Sequence[Callable]):
        self.noises = list(noises)

    def __call__(self, i, site: str, shape):
        if "@" not in site:
            return self.noises[0](i, site, shape)
        base, s = site.rsplit("@", 1)
        return self.noises[int(s)](i, base, shape)
