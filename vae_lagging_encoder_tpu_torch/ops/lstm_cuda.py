"""Whole-sequence masked-carry LSTM forward: CUDA kernel + plain version.

``lstm_seq`` is the port's counterpart of the JAX package's Pallas kernels
``ops/lstm_pallas.py::_fwd_kernel`` (``save_residuals=True``: also the cell
states and gate activations a backward pass needs) and ``_infer_kernel``
(``save_residuals=False``). On a CUDA tensor it launches
``csrc/lstm_fwd.cu`` (or raises); on a CPU tensor it runs
``lstm_seq_plain``, the same function in plain PyTorch, which is also what
the kernel is checked against.

Numerics (both versions, as in the TPU kernels): ``h_{t-1}`` is rounded to
``wh``'s dtype before the product, products accumulate in f32, the state
is f32, and ``hs``/``cs`` hold the KEPT state at masked steps.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGTYPES[3] = ctypes.c_int  # wh_bf16


def lstm_seq_plain(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor,
                   save_residuals: bool = False) -> Tuple[torch.Tensor, ...]:
    """xw [T, B, 4H] f32 (input projection incl. biases), mask [T, B] f32,
    wh [H, 4H] f32 or bf16, h0/c0 [B, H] f32.

    Returns ``(hs [T, B, H], hT, cT)``, or with ``save_residuals``
    ``(hs, cs [T, B, H], gates [T, B, 4H], hT, cT)`` where ``gates`` are
    the activations (i, f, g, o)."""
    T, B, H4 = xw.shape
    H = H4 // 4
    whf = wh.float()
    h, c = h0, c0
    hs, cs, gates = [], [], []
    for t in range(T):
        a = xw[t] + h.to(wh.dtype).float() @ whf
        i, f, g, o = a.split(H, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c_raw = f * c + i * g
        h_raw = o * torch.tanh(c_raw)
        m = mask[t, :, None]
        h = m * h_raw + (1.0 - m) * h
        c = m * c_raw + (1.0 - m) * c
        hs.append(h)
        if save_residuals:
            cs.append(c)
            gates.append(torch.cat([i, f, g, o], dim=-1))
    empty = xw.new_zeros((0, B, H))
    hs_t = torch.stack(hs) if hs else empty
    if save_residuals:
        return (hs_t, torch.stack(cs) if cs else empty,
                torch.stack(gates) if gates else xw.new_zeros((0, B, H4)), h, c)
    return hs_t, h, c


def _lib() -> ctypes.CDLL:
    lib = build.library("lstm_fwd")
    if lib.lstm_fwd.argtypes is None:
        lib.lstm_fwd.argtypes = _ARGTYPES
        lib.lstm_fwd.restype = ctypes.c_int
    return lib


def lstm_seq(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
             h0: torch.Tensor, c0: torch.Tensor,
             save_residuals: bool = False) -> Tuple[torch.Tensor, ...]:
    """Same contract as ``lstm_seq_plain``; launches the CUDA kernel for
    CUDA tensors. Takes no gradient (the backward kernel is not ported)."""
    if xw.device.type == "cpu":
        return lstm_seq_plain(xw, mask, wh, h0, c0, save_residuals)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_seq: unsupported device {xw.device}")
    T, B, H4 = xw.shape
    H = H4 // 4
    if H4 != 4 * H or tuple(wh.shape) != (H, H4) or tuple(mask.shape) != (T, B) \
            or tuple(h0.shape) != (B, H) or tuple(c0.shape) != (B, H):
        raise ValueError(f"lstm_seq: bad shapes xw {tuple(xw.shape)} mask "
                         f"{tuple(mask.shape)} wh {tuple(wh.shape)} h0 "
                         f"{tuple(h0.shape)} c0 {tuple(c0.shape)}")
    f32 = (xw, mask, h0, c0)
    if any(a.dtype != torch.float32 for a in f32) or wh.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("lstm_seq: xw, mask, h0, c0 must be float32 and wh float32 or bfloat16")
    if any(a.device != xw.device for a in (mask, wh, h0, c0)):
        raise ValueError("lstm_seq: all inputs must be on one device")
    if T == 0:
        return lstm_seq_plain(xw, mask, wh, h0, c0, save_residuals)
    xw, mask, wh, h0, c0 = (a.contiguous() for a in (xw, mask, wh, h0, c0))
    hs = torch.empty((T, B, H), device=xw.device)
    hT = torch.empty((B, H), device=xw.device)
    cT = torch.empty((B, H), device=xw.device)
    cs = torch.empty((T, B, H), device=xw.device) if save_residuals else None
    gates = torch.empty((T, B, H4), device=xw.device) if save_residuals else None
    lib = _lib()
    with torch.cuda.device(xw.device):
        err = lib.lstm_fwd(
            xw.data_ptr(), mask.data_ptr(), wh.data_ptr(), int(wh.dtype == torch.bfloat16),
            h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
            cs.data_ptr() if save_residuals else None,
            gates.data_ptr() if save_residuals else None,
            hT.data_ptr(), cT.data_ptr(), T, B, H, int(save_residuals),
            torch.cuda.current_stream(xw.device).cuda_stream)
    build.check(lib, err, "lstm_fwd")
    build.LAUNCHES["lstm_fwd_residuals" if save_residuals else "lstm_fwd_infer"] += 1
    if save_residuals:
        return hs, cs, gates, hT, cT
    return hs, hT, cT
