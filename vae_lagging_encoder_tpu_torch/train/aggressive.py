"""The paper's aggressive (lagging-encoder) inner loop.

Counterpart of ``vae_lagging_encoder_tpu/train/aggressive.py``
(``make_grad_on``, ``make_aggressive_inner``), whose host-side semantics
are the reference's:

    pre = +inf; cur = words = 0
    for sub_iter in 1..burn_max_iters:
        batch = a uniformly drawn training batch
        full forward + backward; clip the FULL enc+dec gradient;
        encoder-only optimizer step
        cur += loss_sum(batch); words += predicted words(batch)
        if sub_iter % burn_window == 0:
            if pre < cur / words: stop              (per-word plateau)
            pre, cur, words = cur / words, 0, 0

Where the JAX package compiles the loop into one ``lax.while_loop``, here it
is a host loop whose sums stay on the device: the stop can only turn true at
a check, so the host reads one scalar every ``burn_window`` sub-iterations
and none in between. The batch draw is a flat index from the caller's
``draw("pick", (num_batches,))``, mapped to (bucket, index) by the pool.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..data.pool import Pool
from .optim import clip_scale


def grads_of(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``name -> .grad`` after a backward (every parameter is reached)."""
    return {k: p.grad for k, p in params.items()}


def make_grad_on(model: torch.nn.Module, loss_fn: Callable, mesh=None) -> Callable:
    """``grad_on(batch, draw, kl_weight) -> aux``: one full forward +
    backward of ``loss_fn(batch, draw, kl_weight) -> (mean_loss, aux)``,
    leaving the gradient in the parameters' ``.grad``.

    With a ``mesh`` (parallel/dp.py) ``batch`` is this rank's rows: the
    backward is of ``loss_sum / all_reduce(n_sents)`` over dp, and the
    gradients and ``aux`` are summed over dp in one all-reduce
    (``reduce_grads``), so every rank returns the whole batch's sums and
    holds the whole batch's gradient."""
    if mesh is None:
        def grad_on(batch, draw, kl_weight):
            model.zero_grad(set_to_none=True)
            mean_loss, aux = loss_fn(batch, draw, kl_weight)
            mean_loss.backward()
            return aux

        return grad_on

    from ..parallel.dp import global_rows, reduce_grads

    params = dict(model.named_parameters())

    def grad_on(batch, draw, kl_weight):
        model.zero_grad(set_to_none=True)
        n = torch.clamp(global_rows(mesh, batch[-1]), min=1.0)
        _, aux = loss_fn(batch, draw, kl_weight)
        (aux[0] / n).backward()
        return reduce_grads(params, aux, mesh)

    return grad_on


def make_aggressive_inner(grad_on: Callable, pool: Pool,
                          params: Dict[str, torch.Tensor], enc_params: Dict[str, torch.Tensor],
                          clip_grad: float, burn_max_iters: int, burn_window: int,
                          opt_update: Callable, scale_fn: Callable = clip_scale,
                          mesh=None) -> Callable:
    """``inner(opt_state, draw_for, kl_weight, lr) -> (opt_state, sub_iters)``.

    ``params`` are all of the model's (named as the clip sums them),
    ``enc_params`` the encoder's (named as ``opt_state["enc"]`` holds
    them); ``draw_for(sub)`` is sub-iteration ``sub``'s draw provider.
    ``scale_fn`` is the clip (``clip_scale``, or parallel/tp.py's
    ``clip_scale_tp`` bound to its mesh). With a ``mesh``, ``grad_on``
    returns sums over dp, so the plateau test reads the same sums on every
    rank; the value it tests is rank 0's (``Mesh.same``), and the batch
    picks come from an unfolded stream, so every rank stops at the same
    sub-iteration and picks the same batches."""

    def inner(opt_state, draw_for: Callable[[int], Callable], kl_weight: float, lr: float):
        dev = next(iter(params.values())).device
        pre = math.inf
        cur = torch.zeros((), device=dev)
        words = torch.zeros((), device=dev)
        sub = 0
        while sub < burn_max_iters:
            draw = draw_for(sub)
            flat = int(draw("pick", (pool.num_batches,)))
            loss_sum, _, _, _, n_words = grad_on(pool.batch(flat), draw, kl_weight)
            scale, _, finite = scale_fn(grads_of(params), clip_grad)
            opt_state = dict(opt_state, enc=opt_update(
                enc_params, grads_of(enc_params), opt_state["enc"], lr,
                scale=scale, finite=finite))
            sub += 1
            cur = cur + loss_sum.detach()
            words = words + n_words
            if sub % burn_window == 0:
                avg = float(cur / torch.clamp(words, min=1.0))
                if mesh is not None:
                    (avg,) = mesh.same([avg])
                if pre < avg:
                    break
                pre = avg
                cur = torch.zeros((), device=dev)
                words = torch.zeros((), device=dev)
        return opt_state, sub

    return inner
