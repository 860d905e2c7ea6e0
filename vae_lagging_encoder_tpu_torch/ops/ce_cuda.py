"""Fused vocab projection + cross-entropy forward: CUDA kernel + plain version.

``ce_forward`` is the port's counterpart of the JAX package's Pallas kernel
``ops/ce_pallas.py::_ce_kernel`` in its forward form: per row
``logp[n] = (h W)[n, tgt[n]] - logsumexp_v (h W)[n, v]`` without an
``[N, V]`` logits array. On a CUDA tensor it launches ``csrc/ce_fwd.cu``
(or raises); on a CPU tensor it runs ``ce_logp_plain``.

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
PLAIN_ROW_CHUNK = 8192  # rows of [rows, V] logits the plain version holds at once


def ce_logp_plain(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor,
                  operand_dtype: Optional[torch.dtype] = torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [N, nh], w [nh, V], tgt [N] -> (logp [N], lse [N]) in f32.
    Rows go in chunks of ``PLAIN_ROW_CHUNK`` to bound the logits memory."""
    dt = operand_dtype or torch.float32
    wq = w.to(dt).float()
    logp, lse = [], []
    for s in range(0, h.shape[0], PLAIN_ROW_CHUNK):
        logits = h[s:s + PLAIN_ROW_CHUNK].to(dt).float() @ wq
        l = torch.logsumexp(logits, dim=-1)
        t = tgt[s:s + PLAIN_ROW_CHUNK].long()
        logp.append(logits.gather(1, t[:, None])[:, 0] - l)
        lse.append(l)
    if not logp:
        empty = h.new_zeros((0,), dtype=torch.float32)
        return empty, empty.clone()
    return torch.cat(logp), torch.cat(lse)


def _lib() -> ctypes.CDLL:
    lib = build.library("ce_fwd")
    if lib.ce_fwd.argtypes is None:
        lib.ce_fwd.argtypes = _ARGTYPES
        lib.ce_fwd.restype = ctypes.c_int
    return lib


def ce_forward(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor,
               operand_dtype: Optional[torch.dtype] = torch.bfloat16
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``ce_logp_plain``; launches the CUDA kernel for
    CUDA tensors. Takes no gradient (the grad-mode variant is not ported)."""
    if h.device.type == "cpu":
        return ce_logp_plain(h, w, tgt, operand_dtype)
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
    if N == 0:
        return logp, lse
    lib = _lib()
    with torch.cuda.device(h.device):
        err = lib.ce_fwd(h.data_ptr(), w.data_ptr(), tgt.data_ptr(), logp.data_ptr(),
                         lse.data_ptr(), N, nh, V, int(dt == torch.bfloat16),
                         torch.cuda.current_stream(h.device).cuda_stream)
    build.check(lib, err, "ce_fwd")
    build.LAUNCHES["ce_fwd"] += 1
    return logp, lse
