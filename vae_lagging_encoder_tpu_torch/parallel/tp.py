"""Tensor parallelism: the decoder's output projection and its CE sharded
by vocabulary.

Counterpart of ``vae_lagging_encoder_tpu/parallel/tp.py``. ``dec.pred``
``[nh, V]`` is the model's largest tensor and FLOP block; each rank of a
``tp`` group holds the columns ``[t * V/T, (t + 1) * V/T)`` of it (and of
its optimizer moments), ``shard_tree`` / ``shard_model`` place them and
``gather_tree`` rebuilds the dense tensor (for checkpoints, which stay
exchangeable with the JAX package's).

Per rank:

- everything up to the decoder's hidden states is replicated over ``tp``:
  tp members draw from the same ``(seed, dp index)`` stream (parallel/
  dp.py), so their z samples and dropout masks agree and their h agree
  without a collective;
- ``tp_token_logp`` computes the logits of its vocab shard only,
  ``h @ pred_local`` ``[N, V/T]`` in f32 with ``torch.matmul`` (TF32 off,
  PyTorch's default), as the JAX package takes ``jnp.dot`` outside any
  Pallas kernel: the fused CE kernel returns an already normalized log p,
  which does not decompose over shards. The logsumexp is assembled over
  the group, as the CE kernel's online logsumexp is over vocab tiles: an
  all-reduce MAX of the row maxima, then one all-reduce SUM of the shifted
  exp-sums together with the target logit, which its owner contributes;
- its backward writes the collectives explicitly (the JAX package's
  ``tp.py:111-117``: under ``shard_map(check_vma=False)`` the transpose of
  a psum would scale every crossing gradient by the group's size): ``dh``
  is all-reduced over ``tp`` (each rank's product carries only its shard's
  part), ``d pred_local`` stays shard-local, the layout its update needs;
- the clip's global norm adds the pred shard's sum of squares all-reduced
  over ``tp`` (``clip_scale_tp``), so every rank scales by one factor.

``gloo`` on CUDA tensors offers only ``all_reduce`` and ``broadcast``;
everything here, the dense gather included, is written with ``all_reduce``,
so the same code runs under ``nccl``.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.dec_lstm import apply_keep
from ..train.optim import clip_scale, make_optimizer
from .dp import Mesh, all_reduce

PRED = "dec.pred"


def is_pred_leaf(path: Tuple[str, ...], leaf) -> bool:
    """The JAX package's pred-leaf rule (``tree_pred_specs``): a 2-D leaf
    reached under a ``dec`` key whose last key is ``pred`` — the
    parameter ``dec.pred`` and its optimizer moments (``dec.v.pred``,
    ``dec.m.pred``)."""
    return "dec" in path and path[-1] == "pred" and getattr(leaf, "ndim", 0) == 2


def _map_pred(tree: Dict, fn: Callable, path: Tuple[str, ...] = ()) -> Dict:
    """``tree`` (nested dicts; dotted keys count as paths) with ``fn``
    applied to its pred leaves, in the dicts' order, the rest as they are."""
    out = {}
    for k, v in tree.items():
        p = path + tuple(str(k).split("."))
        if isinstance(v, dict):
            out[k] = _map_pred(v, fn, p)
        else:
            out[k] = fn(v) if is_pred_leaf(p, v) else v
    return out


def _cols(mesh: Mesh, vocab: int) -> Tuple[int, int]:
    if vocab % mesh.tp:
        raise ValueError(f"vocab {vocab} is not divisible into {mesh.tp} shards")
    per = vocab // mesh.tp
    return mesh.tp_index * per, per


def shard_tree(mesh: Mesh, tree: Dict) -> Dict:
    """``tree`` (a state dict, a name -> tensor dict or an optimizer state)
    with its pred leaves cut to this rank's vocab columns."""
    def cut(t):
        lo, per = _cols(mesh, t.shape[1])
        return t[:, lo:lo + per].clone()
    return _map_pred(tree, cut)


def gather_tree(mesh: Mesh, tree: Dict, vocab: int) -> Dict:
    """The inverse of ``shard_tree`` on every tp member: each pred leaf
    rebuilt dense ``[nh, vocab]`` by one all-reduce over ``tp`` of the
    zero-padded shards (exact: the other shards add zeros)."""
    def dense(t):
        lo, per = _cols(mesh, vocab)
        full = t.new_zeros((t.shape[0], vocab))
        full[:, lo:lo + per] = t
        return all_reduce(full, mesh.tp_group)
    return tree if mesh.tp == 1 else _map_pred(tree, dense)


def shard_model(mesh: Mesh, vae: nn.Module) -> None:
    """Replace ``vae.dec.pred`` by this rank's vocab shard (in place; the
    other parameters stay replicated)."""
    cut = shard_tree(mesh, {PRED: vae.dec.pred.detach()})[PRED]
    vae.dec.pred = nn.Parameter(cut)


def _tp_logp_parts(h, pred_local, targets, vocab_size, group):
    ntp = dist.get_world_size(group) if group is not None else 1
    v_local = pred_local.shape[1]
    if v_local * ntp != vocab_size:
        raise ValueError(f"vocab {vocab_size} != {ntp} shards x {v_local}")
    lo = (dist.get_rank(group) if group is not None else 0) * v_local
    logits = h @ pred_local
    gmax = all_reduce(logits.amax(dim=-1), group, dist.ReduceOp.MAX)
    sumexp = (logits - gmax[:, None]).exp_().sum(dim=-1)
    # the owner shard contributes the target logit; the clamp keeps the
    # gather in bounds on the others, whose contribution is zeroed
    t_local = torch.clamp(targets - lo, 0, v_local - 1)
    owned = (targets >= lo) & (targets < lo + v_local)
    tgt = torch.where(owned, logits.gather(1, t_local[:, None])[:, 0], 0.0)
    both = all_reduce(torch.stack([sumexp, tgt]), group)
    lse = gmax + torch.log(both[0])
    return logits, lse, t_local, owned, both[1]


class TPTokenLogp(torch.autograd.Function):
    """``tp_token_logp`` with its hand-written backward (module docstring)."""

    @staticmethod
    def forward(ctx, h, pred_local, targets, vocab_size, group):
        logits, lse, t_local, owned, tgt = _tp_logp_parts(h, pred_local, targets,
                                                          vocab_size, group)
        ctx.save_for_backward(h, pred_local, logits, lse, t_local, owned)
        ctx.group = group
        return tgt - lse

    @staticmethod
    def backward(ctx, ct):
        h, pred_local, logits, lse, t_local, owned = ctx.saved_tensors
        # d logits = ct * (owned one-hot - softmax slice)
        q = (logits - lse[:, None]).exp_().neg_()
        rows = torch.arange(q.shape[0], device=q.device)
        q[rows, t_local] += owned.to(q.dtype)
        d = ct[:, None] * q
        dh = all_reduce(d @ pred_local.T, ctx.group)
        dpred = h.T @ d
        return dh, dpred, None, None, None


def tp_token_logp(h: torch.Tensor, pred_local: torch.Tensor, targets: torch.Tensor,
                  vocab_size: int, group=None) -> torch.Tensor:
    """Per-token target log-probability with the vocabulary sharded over
    ``group``: h ``[N, nh]`` (replicated over the group), pred_local
    ``[nh, V/T]`` (this rank's columns), targets ``[N]`` global ids ->
    ``[N]``, the same on every member. ``group`` None is one shard."""
    return TPTokenLogp.apply(h, pred_local, targets, vocab_size, group)


def tp_reconstruct_error(dec, tokens, mask, z, group, draw=None) -> torch.Tensor:
    """-log p(x|z) per (sentence, z-sample) ``[B, K]`` with the output stage
    vocab-sharded: ``LSTMDecoder.reconstruct_error`` with ``tp_token_logp``
    in place of the CE, the same ``iw_chunk`` chunks (zero-z padding, per
    chunk dropout sites, ``torch.utils.checkpoint`` with a gradient) and
    the same draws. ``draw`` selects training mode (dropout)."""
    B, T = tokens.shape
    cd = dec.compute_dtype
    seq = dec._shared_input(tokens[:, :-1], draw)

    def rec_chunk(z_chunk, keep_in, keep_out):  # [B, k, nz] -> [B, k]
        k = z_chunk.shape[1]
        outs = apply_keep(dec._hidden_states(tokens[:, :-1], z_chunk, keep_in, seq),
                          keep_out, dec.dropout_out)
        tgt = tokens[None, :, 1:].expand(k, B, T - 1).reshape(-1)
        logp = tp_token_logp(outs.reshape(-1, dec.nh).to(cd).float(),
                             dec.pred.to(cd).float(), tgt, dec.vocab_size, group)
        tok_lp = logp.reshape(k, B, T - 1).transpose(0, 1)
        return -torch.sum(tok_lp * mask[:, None, 1:], dim=-1)

    return dec.over_chunks(rec_chunk, z, draw, T - 1)


def tp_nll_iw(vae, x, mask, nsamples: int = 500, ns: int = 100, noise=None,
              group=None) -> torch.Tensor:
    """Importance-weighted NLL per sentence ``[B]`` with the decoder's
    likelihood vocab-sharded: ``VAE.nll_iw`` (the same chunks of ``ns`` and
    draws ``noise(j, shape)``) with ``tp_reconstruct_error``."""
    return vae.nll_iw(x, mask, nsamples, ns, noise=noise,
                      log_px=lambda x, m, z: -tp_reconstruct_error(vae.dec, x, m, z, group))


def make_tp_loss_fn(vae, mesh: Mesh, nsamples: int = 1, train: bool = False) -> Callable:
    """The text ``make_loss_fn`` contract (``(batch, draw, kl_weight) ->
    (mean_loss, (loss_sum, rec_sum, kl_sum, n_sents, n_words))``) with the
    output stage vocab-sharded over ``mesh``'s tp group; the same draws as
    ``VAE.loss`` (eps first, then the decoder's dropout in training)."""

    def loss_fn(batch, draw, kl_weight=1.0):
        x, mask, row_weight = batch
        eps = draw("eps", (x.shape[0], nsamples, vae.nz))
        z, kl = vae.enc.encode(x, mask, nsamples, eps)
        rec = tp_reconstruct_error(vae.dec, x, mask, z, mesh.tp_group,
                                   draw if train else None).mean(dim=1)
        rec = rec * row_weight
        kl = kl * row_weight
        loss_sum = (rec + kl_weight * kl).sum()
        n_sents = row_weight.sum()
        n_words = (mask[:, 1:] * row_weight[:, None]).sum()
        return loss_sum / torch.clamp(n_sents, min=1.0), (
            loss_sum, rec.sum(), kl.sum(), n_sents, n_words)

    return loss_fn


def clip_scale_tp(grads: Dict[str, torch.Tensor], max_norm: float, mesh: Mesh):
    """``optim.clip_scale`` with ``dec.pred``'s sum of squares all-reduced
    over ``tp`` (and added last, as the JAX package's ``clip_scale_tp``):
    ``(scale, norm, finite)``, the same on every rank."""
    return clip_scale(grads, max_norm, pred_sumsq=partial(all_reduce, group=mesh.tp_group))


def clip_tp(grads: Dict[str, torch.Tensor], max_norm: float, mesh: Mesh):
    """The clipped gradients (zeroed when the norm is not finite) and the
    norm, with the tp-aware global norm of ``clip_scale_tp``."""
    scale, norm, finite = clip_scale_tp(grads, max_norm, mesh)
    return {k: torch.where(finite, g * scale, torch.zeros_like(g))
            for k, g in grads.items()}, norm


def make_tp_train_step(vae, cfg, mesh: Mesh) -> Callable:
    """The joint encoder + decoder step of ``make_dp_train_step`` on a
    ``dp x tp`` mesh: ``step(batch, draw, kl_weight, lr) -> aux`` (the
    whole batch's sums), ``vae.dec.pred`` holding this rank's shard
    (``shard_model``); the plain SGD update follows the tp-aware clip."""
    from ..train.aggressive import grads_of, make_grad_on

    grad_on = make_grad_on(vae, make_tp_loss_fn(vae, mesh, cfg.nsamples, train=True), mesh)
    _, sgd = make_optimizer("sgd")
    params = dict(vae.named_parameters())

    def step(batch, draw, kl_weight, lr):
        aux = grad_on(batch, draw, kl_weight)
        scale, _, finite = clip_scale_tp(grads_of(params), cfg.clip_grad, mesh)
        sgd(params, grads_of(params), {}, lr, scale=scale, finite=finite)
        return aux

    return step


def make_tp_eval_step(vae, mesh: Mesh, nsamples: int = 1) -> Callable:
    """The evaluation-mode loss on a ``dp x tp`` mesh: ``eval(batch, draw,
    kl_weight) -> aux`` summed over the whole batch (all dp ranks)."""
    loss_fn = make_tp_loss_fn(vae, mesh, nsamples, train=False)

    @torch.no_grad()
    def run(batch, draw, kl_weight=1.0):
        _, aux = loss_fn(batch, draw, kl_weight)
        return tuple(all_reduce(torch.stack([a.reshape(()) for a in aux]), mesh.dp_group))

    return run
