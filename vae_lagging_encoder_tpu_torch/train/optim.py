"""Optimizers and the global-norm clip of the reference's recipe.

Counterpart of ``vae_lagging_encoder_tpu/train/optim.py``: two separate
optimizers, one over the encoder's parameters and one over the decoder's
(load-bearing for the aggressive loop, whose inner steps move the encoder
only), and a clip of the WHOLE model's gradient to global norm
``clip_grad`` before either steps. The clip is folded into the update as
one scale: ``clip_scale`` returns 0-dim device tensors (scale, norm,
finite), so no step reads a value back to the host. A non-finite norm
zeroes the step (``finite`` False) instead of poisoning the parameters.

Parameters and gradients travel as dicts ``name -> tensor`` (the names of
``named_parameters``); parameters are updated in place. Optimizer state
has the JAX package's tree layout, ``{}`` (plain SGD), ``{"v": grads-like}``
(momentum) or ``{"m", "v", "t"}`` (Adam), so ``state_to_tree`` /
``state_from_tree`` move it through the checkpoint format both packages
read.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.jax_params import from_jax_params, to_jax_params

Tensors = Dict[str, torch.Tensor]


def scale_from_sumsq(sumsq: torch.Tensor, max_norm: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scale, norm, finite) from a sum of squares: eps 1e-6, min(1, .),
    scale 0 when the norm is not finite."""
    norm = torch.sqrt(sumsq)
    finite = torch.isfinite(norm)
    scale = torch.where(finite, torch.clamp(max_norm / (norm + 1e-6), max=1.0),
                        torch.zeros_like(norm))
    return scale, norm, finite


def clip_scale(grads: Tensors, max_norm: float,
               pred_sumsq: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The clip of ``clip_by_global_norm`` as one scale: multiplying every
    gradient by ``scale`` (zeroing when not ``finite``) is the clipped
    gradient. The squares are summed in the JAX package's leaf order
    (sorted names). Under tensor parallelism ``dec.pred`` is this rank's
    vocab shard: ``pred_sumsq`` (the all-reduce over tp, parallel/tp.py)
    turns its sum of squares into the whole tensor's, which is added last,
    as the JAX package's ``clip_scale_tp`` adds it."""
    if pred_sumsq is None:
        sumsq = sum(torch.sum(torch.square(grads[k])) for k in sorted(grads))
    else:
        sumsq = sum(torch.sum(torch.square(grads[k])) for k in sorted(grads) if k != "dec.pred")
        sumsq = sumsq + pred_sumsq(torch.sum(torch.square(grads["dec.pred"])))
    return scale_from_sumsq(sumsq, max_norm)


def _eff_grad(g: torch.Tensor, scale: Optional[torch.Tensor],
              finite: Optional[torch.Tensor]) -> torch.Tensor:
    """The clipped gradient ``g * scale``, zeroed on the non-finite branch."""
    if scale is None:
        return g
    gs = g * scale
    if finite is None:
        return gs
    return torch.where(finite, gs, torch.zeros_like(gs))


InitFn = Callable[[Tensors], dict]
UpdateFn = Callable[..., dict]


def make_optimizer(name: str = "sgd", momentum: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> Tuple[InitFn, UpdateFn]:
    """``(init_fn(params) -> state, update_fn(params, grads, state, lr,
    scale=None, finite=None) -> state)``; ``update_fn`` writes the new
    parameters in place. ``scale``/``finite`` come from ``clip_scale``."""
    if name == "sgd":
        if momentum:
            def init_fn(params):
                return {"v": {k: torch.zeros_like(p) for k, p in params.items()}}

            @torch.no_grad()
            def update_fn(params, grads, state, lr, scale=None, finite=None):
                v = {k: momentum * state["v"][k] + _eff_grad(grads[k], scale, finite)
                     for k in params}
                for k, p in params.items():
                    p.copy_(p - lr * v[k])
                return {"v": v}
        else:
            def init_fn(params):
                return {}

            @torch.no_grad()
            def update_fn(params, grads, state, lr, scale=None, finite=None):
                for k, p in params.items():
                    p.copy_(p - lr * _eff_grad(grads[k], scale, finite))
                return state
        return init_fn, update_fn

    if name == "adam":
        def init_fn(params):
            dev = next(iter(params.values())).device
            return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                    "v": {k: torch.zeros_like(p) for k, p in params.items()},
                    "t": torch.zeros((), dtype=torch.int32, device=dev)}

        @torch.no_grad()
        def update_fn(params, grads, state, lr, scale=None, finite=None):
            t = state["t"] + 1
            eff = {k: _eff_grad(grads[k], scale, finite) for k in params}
            m = {k: b1 * state["m"][k] + (1 - b1) * eff[k] for k in params}
            v = {k: b2 * state["v"][k] + (1 - b2) * eff[k] * eff[k] for k in params}
            tf = t.to(torch.float32)
            mhat_scale = 1.0 / (1.0 - b1 ** tf)
            vhat_scale = 1.0 / (1.0 - b2 ** tf)
            for k, p in params.items():
                p.copy_(p - lr * (m[k] * mhat_scale) / (torch.sqrt(v[k] * vhat_scale) + eps))
            return {"m": m, "v": v, "t": t}

        return init_fn, update_fn

    raise ValueError(f"unknown optimizer {name!r}")


def state_to_tree(state: Dict[str, dict]) -> Dict[str, dict]:
    """``{"enc": state, "dec": state}`` -> the JAX package's opt_state tree
    of numpy arrays (per-parameter dicts nested as its parameter trees,
    lists included: ``to_jax_params``)."""
    return {part: {k: to_jax_params(v) if isinstance(v, dict)
                   else v.detach().cpu().numpy().copy()
                   for k, v in s.items()}
            for part, s in state.items()}


def state_from_tree(tree: Dict[str, dict], device) -> Dict[str, dict]:
    """Inverse of ``state_to_tree`` (also reads a JAX-written opt_state;
    the moments' trees, lists included, flatten as ``from_jax_params``)."""
    out = {}
    for part, s in tree.items():
        out[part] = {}
        for k, v in s.items():
            if isinstance(v, dict):
                out[part][k] = {n: t.to(device) for n, t in from_jax_params(v).items()}
            else:
                out[part][k] = torch.as_tensor(np.asarray(v)).to(device)
    return out
