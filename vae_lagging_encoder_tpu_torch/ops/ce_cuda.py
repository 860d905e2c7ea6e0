"""Fused vocab projection + cross-entropy: CUDA kernel + plain version +
the autograd Function.

``ce_forward`` is the port's counterpart of the JAX package's Pallas kernel
``ops/ce_pallas.py::_ce_kernel``: per row
``logp[n] = (h W)[n, tgt[n]] - logsumexp_v (h W)[n, v]`` without an
``[N, V]`` logits array. With ``save_logits`` it is the kernel's grad mode
(``save_logits=True``): it also returns the logits rounded to the operand
type as the backward's residual, and as ``lse`` the logsumexp of those
rounded logits (``s2``), so each backward softmax row sums to exactly 1.
On a CUDA tensor it launches ``csrc/ce_fwd.cu`` (``ce_fwd`` or
``ce_fwd_train``, or raises); on a CPU tensor it runs ``ce_logp_plain``.

``FusedCEFn`` is the counterpart of ``_fused_ce`` with its
``_fused_ce_fwd``/``_fused_ce_bwd``: the grad-mode forward, then the
backward in plain PyTorch (``ce_backward``), as the JAX package leaves it
to XLA.

``operand_dtype`` rounds h and W before the product, with f32 accumulation:
``torch.bfloat16`` is the JAX package's default ``mxu_dtype``
(``fused_ce_logp``), ``None`` keeps f32 operands (the f32 checks).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_TRAIN_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
PLAIN_ROW_CHUNK = 8192  # rows of [rows, V] logits the plain version holds at once


def ce_logp_plain(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor,
                  operand_dtype: Optional[torch.dtype] = torch.bfloat16,
                  save_logits: bool = False) -> Tuple[torch.Tensor, ...]:
    """h [N, nh], w [nh, V], tgt [N] -> (logp [N], lse [N]) in f32, or with
    ``save_logits`` (logp, lse of the rounded logits, logits [N, V] in the
    operand type). Rows go in chunks of ``PLAIN_ROW_CHUNK`` to bound the
    f32 logits memory."""
    dt = operand_dtype or torch.float32
    wq = w.to(dt).float()
    logp, lse = [], []
    spill = h.new_empty((h.shape[0], w.shape[1]), dtype=dt) if save_logits else None
    for s in range(0, h.shape[0], PLAIN_ROW_CHUNK):
        logits = h[s:s + PLAIN_ROW_CHUNK].to(dt).float() @ wq
        l = torch.logsumexp(logits, dim=-1)
        t = tgt[s:s + PLAIN_ROW_CHUNK].long()
        logp.append(logits.gather(1, t[:, None])[:, 0] - l)
        if save_logits:
            rounded = logits.to(dt)
            spill[s:s + PLAIN_ROW_CHUNK] = rounded
            l = torch.logsumexp(rounded.float(), dim=-1)
        lse.append(l)
    if not logp:
        empty = h.new_zeros((0,), dtype=torch.float32)
        return (empty, empty.clone()) + ((spill,) if save_logits else ())
    return (torch.cat(logp), torch.cat(lse)) + ((spill,) if save_logits else ())


def _lib(name: str, argtypes) -> ctypes.CDLL:
    lib = build.library("ce_fwd")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def ce_forward(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor,
               operand_dtype: Optional[torch.dtype] = torch.bfloat16,
               save_logits: bool = False) -> Tuple[torch.Tensor, ...]:
    """Same contract as ``ce_logp_plain``; launches the CUDA kernel for
    CUDA tensors. Takes no gradient itself (``FusedCEFn`` does)."""
    if h.device.type == "cpu":
        return ce_logp_plain(h, w, tgt, operand_dtype, save_logits)
    if h.device.type != "cuda":
        raise ValueError(f"ce_forward: unsupported device {h.device}")
    N, nh = h.shape
    if w.dim() != 2 or w.shape[0] != nh or tuple(tgt.shape) != (N,):
        raise ValueError(f"ce_forward: bad shapes h {tuple(h.shape)} w "
                         f"{tuple(w.shape)} tgt {tuple(tgt.shape)}")
    if operand_dtype not in (None, torch.bfloat16):
        raise TypeError(f"ce_forward: operand_dtype {operand_dtype} not supported")
    if w.device != h.device or tgt.device != h.device:
        raise ValueError("ce_forward: all inputs must be on one device")
    V = w.shape[1]
    dt = operand_dtype or torch.float32
    h = h.to(dt).contiguous()
    w = w.to(dt).contiguous()
    tgt = tgt.to(torch.int32).contiguous()
    logp = torch.empty((N,), device=h.device)
    lse = torch.empty((N,), device=h.device)
    spill = torch.empty((N, V), device=h.device, dtype=dt) if save_logits else None
    if N == 0:
        return (logp, lse) + ((spill,) if save_logits else ())
    name = "ce_fwd_train" if save_logits else "ce_fwd"
    lib = _lib(name, _TRAIN_ARGTYPES if save_logits else _ARGTYPES)
    args = (h.data_ptr(), w.data_ptr(), tgt.data_ptr(), logp.data_ptr(), lse.data_ptr()) \
        + ((spill.data_ptr(),) if save_logits else ()) \
        + (N, nh, V, int(dt == torch.bfloat16), torch.cuda.current_stream(h.device).cuda_stream)
    with torch.cuda.device(h.device):
        err = getattr(lib, name)(*args)
    build.check(lib, err, name)
    build.LAUNCHES[name] += 1
    return (logp, lse) + ((spill,) if save_logits else ())


def ce_backward(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor, lse: torch.Tensor,
                logits: torch.Tensor, g: torch.Tensor,
                operand_dtype: Optional[torch.dtype] = torch.bfloat16
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_fused_ce_bwd``: the log_softmax-gather VJP at the saved logits.

    p = exp(logits - lse) (``lse`` of the saved logits, so rows sum to 1),
    d = (onehot - p) * g, rounded to the operand type; dh = d W^T and
    dW = h^T d from the operands in that type with f32 accumulation (the
    products are taken in f32 on values the type represents exactly, as
    JAX's ``preferred_element_type=float32`` does). Returns (dh, dW) in the
    dtypes of h and w."""
    p = torch.exp(logits.float() - lse[:, None])
    t = tgt.long()[:, None]
    d = -(p * g[:, None])
    d.scatter_(1, t, (1.0 - p.gather(1, t)) * g[:, None])
    dt = operand_dtype or torch.float32
    d = d.to(dt).float()
    dh = d @ w.to(dt).float().T
    dw = h.to(dt).float().T @ d
    return dh.to(h.dtype), dw.to(w.dtype)


class FusedCEFn(torch.autograd.Function):
    """``logp = FusedCEFn.apply(h, w, tgt, operand_dtype)``: the per-row
    target log-probability with the gradient of ``_fused_ce_bwd`` for h and
    w (tgt and operand_dtype take none). The forward goes through
    ``ce_forward(..., save_logits=True)``, so a CUDA input launches the
    grad-mode kernel and a CPU input runs the plain version."""

    @staticmethod
    def forward(ctx, h, w, tgt, operand_dtype):
        logp, lse, logits = ce_forward(h, w, tgt, operand_dtype, save_logits=True)
        ctx.operand_dtype = operand_dtype
        ctx.save_for_backward(h, w, tgt, lse, logits)
        return logp

    @staticmethod
    def backward(ctx, g):
        h, w, tgt, lse, logits = ctx.saved_tensors
        dh, dw = ce_backward(h, w, tgt, lse, logits, g, ctx.operand_dtype)
        return dh, dw, None, None
