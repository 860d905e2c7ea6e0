"""Whole-sequence masked-carry LSTM, forward and backward: CUDA kernels +
plain versions + the autograd Function.

- ``lstm_seq`` is the port's counterpart of the JAX package's Pallas kernels
  ``ops/lstm_pallas.py::_fwd_kernel`` (``save_residuals=True``: also the
  cell states and gate activations a backward pass needs) and
  ``_infer_kernel`` (``save_residuals=False``); it launches
  ``csrc/lstm_fwd.cu``.
- ``lstm_bwd`` is the counterpart of ``_bwd_kernel`` (the reverse-time
  sweep); it launches ``csrc/lstm_bwd.cu``.
- ``LSTMSeqFn`` is the counterpart of ``lstm_seq_fused`` with its
  ``_fused_fwd``/``_fused_bwd``: the residual-saving forward, then the
  backward sweep and dWh = h_prev^T da as one matrix product.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs its plain PyTorch version (``lstm_seq_plain``,
``lstm_bwd_plain``), which is also what the kernel is checked against.

Numerics (both versions, as in the TPU kernels): ``h_{t-1}`` (forward) and
``da`` (backward) are rounded to ``wh``'s dtype before the product, products
accumulate in f32, the state and the grads are f32, and ``hs``/``cs`` hold
the KEPT state at masked steps.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGTYPES[3] = ctypes.c_int  # wh_bf16
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES[3] = ctypes.c_int  # wh_bf16


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


def lstm_bwd_plain(gates: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                   c_prev: torch.Tensor, dhs: torch.Tensor, dhT: torch.Tensor,
                   dcT: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse sweep of ``_bwd_kernel``, step by step.

    gates [T, B, 4H] (activations i, f, g, o), mask [T, B], wh [H, 4H],
    c_prev [T, B, H] (the kept c_{t-1}, c0 first), dhs [T, B, H] (grads of
    hs), dhT/dcT [B, H]. Returns ``(da [T, B, 4H], dh0, dc0)``: the grads of
    the gate pre-activations and of the initial state."""
    T, B, H4 = gates.shape
    H = H4 // 4
    whf = wh.float()
    dh, dc = dhT, dcT
    da = gates.new_zeros((T, B, H4))
    for t in reversed(range(T)):
        i, f, g, o = gates[t].split(H, dim=-1)
        cp = c_prev[t]
        tanh_c = torch.tanh(f * cp + i * g)
        dhk = dh + dhs[t]
        dck = dc
        m = mask[t, :, None]
        dh_raw = m * dhk
        dc_raw = m * dck
        do = dh_raw * tanh_c
        dc_tot = dc_raw + dh_raw * o * (1.0 - tanh_c * tanh_c)
        di = dc_tot * g
        df = dc_tot * cp
        dg = dc_tot * i
        a = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g),
                       do * o * (1.0 - o)], dim=-1)
        da[t] = a
        # grads flowing to the previous step's kept state
        dh = a.to(wh.dtype).float() @ whf.T + (1.0 - m) * dhk
        dc = dc_tot * f + (1.0 - m) * dck
    return da, dh, dc


def _lib(name: str, argtypes) -> ctypes.CDLL:
    lib = build.library(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(what: str, seq: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
           state: Tuple[torch.Tensor, ...], f32: Tuple[torch.Tensor, ...]) -> None:
    """Device, shape and dtype checks shared by the CUDA wrappers: ``seq``
    is [T, B, 4H], ``state`` are [B, H] and ``f32`` must be float32."""
    T, B, H4 = seq.shape
    H = H4 // 4
    if H4 != 4 * H or tuple(wh.shape) != (H, H4) or tuple(mask.shape) != (T, B) \
            or any(tuple(a.shape) != (B, H) for a in state):
        raise ValueError(f"{what}: bad shapes {tuple(seq.shape)} mask {tuple(mask.shape)} "
                         f"wh {tuple(wh.shape)} state {[tuple(a.shape) for a in state]}")
    if any(a.dtype != torch.float32 for a in f32) or wh.dtype not in (torch.float32,
                                                                        torch.bfloat16):
        raise TypeError(f"{what}: activations and state must be float32, wh float32 "
                        "or bfloat16")
    if any(a.device != seq.device for a in (mask, wh, *f32)):
        raise ValueError(f"{what}: all inputs must be on one device")


def lstm_seq(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
             h0: torch.Tensor, c0: torch.Tensor,
             save_residuals: bool = False) -> Tuple[torch.Tensor, ...]:
    """Same contract as ``lstm_seq_plain``; launches the CUDA kernel for
    CUDA tensors. Takes no gradient itself (``LSTMSeqFn`` does)."""
    if xw.device.type == "cpu":
        return lstm_seq_plain(xw, mask, wh, h0, c0, save_residuals)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_seq: unsupported device {xw.device}")
    _check("lstm_seq", xw, mask, wh, (h0, c0), (xw, mask, h0, c0))
    T, B, H4 = xw.shape
    H = H4 // 4
    if T == 0:
        return lstm_seq_plain(xw, mask, wh, h0, c0, save_residuals)
    xw, mask, wh, h0, c0 = (a.contiguous() for a in (xw, mask, wh, h0, c0))
    hs = torch.empty((T, B, H), device=xw.device)
    hT = torch.empty((B, H), device=xw.device)
    cT = torch.empty((B, H), device=xw.device)
    cs = torch.empty((T, B, H), device=xw.device) if save_residuals else None
    gates = torch.empty((T, B, H4), device=xw.device) if save_residuals else None
    lib = _lib("lstm_fwd", _ARGTYPES)
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


def lstm_bwd(gates: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
             c_prev: torch.Tensor, dhs: torch.Tensor, dhT: torch.Tensor,
             dcT: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as ``lstm_bwd_plain``; launches the CUDA kernel for
    CUDA tensors."""
    if gates.device.type == "cpu":
        return lstm_bwd_plain(gates, mask, wh, c_prev, dhs, dhT, dcT)
    if gates.device.type != "cuda":
        raise ValueError(f"lstm_bwd: unsupported device {gates.device}")
    _check("lstm_bwd", gates, mask, wh, (dhT, dcT), (gates, mask, dhT, dcT, c_prev, dhs))
    T, B, H4 = gates.shape
    H = H4 // 4
    if tuple(c_prev.shape) != (T, B, H) or tuple(dhs.shape) != (T, B, H):
        raise ValueError(f"lstm_bwd: bad shapes c_prev {tuple(c_prev.shape)} dhs "
                         f"{tuple(dhs.shape)}")
    if T == 0:
        return lstm_bwd_plain(gates, mask, wh, c_prev, dhs, dhT, dcT)
    gates, mask, wh, c_prev, dhs, dhT, dcT = (
        a.contiguous() for a in (gates, mask, wh, c_prev, dhs, dhT, dcT))
    da = torch.empty((T, B, H4), device=gates.device)
    da_r = torch.empty((2, B, H4), device=gates.device, dtype=wh.dtype)
    dh0 = torch.empty((B, H), device=gates.device)
    dc0 = torch.empty((B, H), device=gates.device)
    lib = _lib("lstm_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(gates.device):
        err = lib.lstm_bwd(
            gates.data_ptr(), mask.data_ptr(), wh.data_ptr(), int(wh.dtype == torch.bfloat16),
            c_prev.data_ptr(), dhs.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
            da.data_ptr(), da_r.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), T, B, H,
            torch.cuda.current_stream(gates.device).cuda_stream)
    build.check(lib, err, "lstm_bwd")
    build.LAUNCHES["lstm_bwd"] += 1
    return da, dh0, dc0


class LSTMSeqFn(torch.autograd.Function):
    """``(hs, hT, cT) = LSTMSeqFn.apply(xw, mask, wh, h0, c0)`` with the
    gradient of ``_fused_bwd``: dxw = da, dwh = (h_prev^T da) in wh's dtype
    (f32 accumulation), dh0, dc0; mask takes none. The residual-saving
    forward and the backward sweep go through ``lstm_seq`` and ``lstm_bwd``,
    so a CUDA input launches both kernels and a CPU input runs both plain
    versions."""

    @staticmethod
    def forward(ctx, xw, mask, wh, h0, c0):
        hs, cs, gates, hT, cT = lstm_seq(xw, mask, wh, h0, c0, save_residuals=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(mask, wh, h0, c0, hs, cs, gates)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        mask, wh, h0, c0, hs, cs, gates = ctx.saved_tensors
        h_prev = torch.cat([h0[None], hs[:-1]], dim=0)
        c_prev = torch.cat([c0[None], cs[:-1]], dim=0)
        da, dh0, dc0 = lstm_bwd(gates, mask, wh, c_prev,
                                torch.zeros_like(hs) if dhs is None else dhs,
                                torch.zeros_like(h0) if dhT is None else dhT,
                                torch.zeros_like(c0) if dcT is None else dcT)
        H = wh.shape[0]
        dwh = (h_prev.reshape(-1, H).T @ da.reshape(-1, 4 * H)).to(wh.dtype)
        return da, None, dwh, dh0, dc0
