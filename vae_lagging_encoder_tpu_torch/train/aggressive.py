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
and none in between (the JAX package makes that test on the device; this
port does not). Each sub-iteration is one static step (train/graphs.py: a
graph replay on the card) that also adds its loss sum and predicted words
to two 0-dim device buffers. The batch draw is a flat index from the
caller's ``draw("pick", (num_batches,))``, mapped to (bucket, index) by the
pool.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..data.pool import Pool


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


def make_aggressive_inner(run_sub: Callable, pool: Pool, burn_max_iters: int,
                          burn_window: int, cur: torch.Tensor, words: torch.Tensor,
                          mesh=None) -> Callable:
    """``inner(draw_for, kl_weight) -> sub_iters``.

    ``run_sub(batch, draw, kl_weight)`` runs one sub-iteration's static
    step: a full forward + backward, the clip over the full gradient, the
    encoder-only update, and ``cur += loss_sum``, ``words += n_words`` on
    the 0-dim device buffers ``cur`` and ``words``. ``draw_for(sub)`` is
    sub-iteration ``sub``'s draw provider. With a ``mesh`` the step's sums
    are over dp, so the plateau test reads the same sums on every rank; the
    value it tests is rank 0's (``Mesh.same``), and the batch picks come
    from an unfolded stream, so every rank stops at the same sub-iteration
    and picks the same batches."""

    def inner(draw_for: Callable[[int], Callable], kl_weight) -> int:
        pre = math.inf
        cur.zero_()
        words.zero_()
        sub = 0
        while sub < burn_max_iters:
            draw = draw_for(sub)
            flat = int(draw("pick", (pool.num_batches,)))
            run_sub(pool.batch(flat), draw, kl_weight)
            sub += 1
            if sub % burn_window == 0:
                avg = float(cur / torch.clamp(words, min=1.0))
                if mesh is not None:
                    (avg,) = mesh.same([avg])
                if pre < avg:
                    break
                pre = avg
                cur.zero_()
                words.zero_()
        return sub

    return inner
