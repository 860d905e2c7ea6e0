"""Whole-sequence masked-carry LSTM, forward and backward: CUDA kernels +
plain versions + the autograd Function.

- ``lstm_seq`` is the port's counterpart of the JAX package's Pallas kernels
  ``ops/lstm_pallas.py::_fwd_kernel`` (``save_residuals=True``: also the
  cell states and gate activations a backward pass needs) and
  ``_infer_kernel`` (``save_residuals=False``); it launches
  ``csrc/lstm_infer.cu`` (tensor cores) for bf16 ``wh``, with or without
  residuals, and ``csrc/lstm_fwd.cu`` (CUDA cores) for f32 ``wh``.
- ``lstm_bwd`` is the counterpart of ``_bwd_kernel`` (the reverse-time
  sweep); it launches ``csrc/lstm_bwd.cu`` (tensor cores with bf16 ``wh``,
  CUDA cores with f32).
- ``infer_plan`` / ``bwd_plan`` compute the launch plans of the two
  tensor-core kernels (blocks, units per block, warps, m-tiles per pass,
  pipeline stages, shared memory), which the kernels check;
  ``plan_owners`` lists which (block, warp) owns each (row, unit) pair.
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
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import build

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGTYPES[3] = ctypes.c_int  # wh_bf16
_BWD_F32_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

# --------------------------------------------------------------- launch plans
# Constants the tensor-core kernels are written for (csrc/lstm_mma.cuh,
# csrc/lstm_infer.cu, csrc/lstm_bwd.cu); tests/test_torch_port_lstm_plan.py
# reads them back from the sources.
MMA_STAGES = 4          # kStages: cp.async ring depth per warp
MAX_WARPS = 16          # kMaxWarps
SMEM_MAX = 232448       # dynamic shared memory one H100 block may opt into
# (n_sub, m_group) instantiations of each kernel. The forward keeps
# m_group x 4 n_sub accumulator tiles per lane (<= 64 f32 registers); n_sub 2
# (16 units per block) serves H > 8 x the SM count (H 1024 on a 114-SM
# H100 PCIe). The residual-saving forward runs at the training batch (up to
# 16 m-tiles, one m-tile a warp per pass); more rows take more passes.
INFER_VARIANTS = ((1, 1), (1, 2), (1, 3), (1, 4), (2, 1), (2, 2))
RESID_VARIANTS = ((1, 1), (2, 1))
BWD_VARIANTS = tuple((nt, mg) for nt in (1, 2) for mg in (1, 2, 3, 4))
# ctypes order of the plan fields after (T, rows, H), as the C entry points
# name them
INFER_PLAN_ARGS = ("n_sub", "warps", "k_split", "m_group", "k_chunk", "stages", "smem_bytes")
BWD_PLAN_ARGS = ("n_sub", "warps", "m_group", "k_chunk", "stages", "smem_bytes")
# lstm_infer: pointers, (T, rows, H, save_residuals), the plan, the stream;
# lstm_bwd_bf16: pointers, (T, rows, H), the plan, the stream
INFER_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (4 + len(INFER_PLAN_ARGS))
                  + [ctypes.c_void_p])
BWD_BF16_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (3 + len(BWD_PLAN_ARGS))
                     + [ctypes.c_void_p])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class MMAPlan:
    """Launch plan of a tensor-core LSTM kernel.

    ``kind`` "infer" (``csrc/lstm_infer.cu``: the product is rows x H times
    H x 4J; ``warps`` = m-tile columns x ``k_split`` K slices, the slices
    summed through shared memory) or "bwd" (``csrc/lstm_bwd.cu``: rows x 4H
    times 4H x J; every warp takes a K slice of all rows). Block u owns
    units [u J, u J + J), J = 8 n_sub, for every row. Each warp keeps ``m_group`` m-tiles of accumulators per pass and stages
    ``k_chunk`` k-steps per cp.async stage, ``stages`` deep."""
    kind: str
    rows: int
    H: int
    n_sub: int
    warps: int
    m_group: int
    k_chunk: int
    k_split: int = 1
    stages: int = MMA_STAGES

    @property
    def units_per_block(self) -> int:
        return 8 * self.n_sub

    @property
    def blocks(self) -> int:
        return _cdiv(self.H, self.units_per_block)

    @property
    def m_tiles(self) -> int:
        return _cdiv(self.rows, 16)

    @property
    def k_steps(self) -> int:
        return _cdiv(self.H if self.kind == "infer" else 4 * self.H, 16)

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def m_columns(self) -> int:
        """Warps that own m-tiles (the forward's K slice 0)."""
        return self.warps // self.k_split

    @property
    def smem_bytes(self) -> int:
        """wh's B fragments + each warp's cp.async ring (+ the backward's
        K-split partial tiles); the kernels compute the same."""
        ring = self.warps * self.stages * self.k_chunk * self.m_group * 512
        if self.kind == "infer":
            return (self.k_steps * 4 * self.n_sub * 256 + ring
                    + (self.k_split - 1) * self.m_columns * self.m_group * 4 * self.n_sub * 512)
        return (self.k_steps * self.n_sub * 256 + ring
                + self.warps * self.m_group * self.n_sub * 512)

    @property
    def ring_elems(self) -> int:
        """bf16 elements of the two-slot operand ring in mma fragment order."""
        return 2 * self.m_tiles * self.k_steps * 256

    def args(self) -> Tuple[int, ...]:
        names = INFER_PLAN_ARGS if self.kind == "infer" else BWD_PLAN_ARGS
        return tuple(getattr(self, n) for n in names)


def _n_sub(H: int, nsm: int) -> int:
    """Fewest 8-unit n-tiles per gate so that the grid has <= nsm blocks."""
    nt = 1
    while _cdiv(H, 8 * nt) > nsm:
        nt += 1
    return nt


def infer_plan(rows: int, H: int, nsm: int, save_residuals: bool = False) -> MMAPlan:
    """The forward's plan: every block takes all rows. Up to 16 m-tile
    columns, each warp owning every WM-th m-tile; when there are fewer than
    16 m-tiles, the spare warps split K instead. The most m-tiles a pass
    that the kernel was built for (``INFER_VARIANTS``, or
    ``RESID_VARIANTS`` with ``save_residuals``), then the deepest pipeline
    stage (k_chunk <= 4) that fits. Raises when no instantiated plan fits."""
    nt = _n_sub(H, nsm)
    mt = _cdiv(rows, 16)
    wm = min(MAX_WARPS, mt)
    wk = min(MAX_WARPS // wm, _cdiv(H, 16))
    variants = RESID_VARIANTS if save_residuals else INFER_VARIANTS
    for mg in range(min(4 // nt, _cdiv(mt, wm)), 0, -1):
        for ck in range(4, 0, -1):
            plan = MMAPlan("infer", rows, H, nt, wm * wk, mg, ck, wk)
            if (nt, mg) in variants and plan.smem_bytes <= SMEM_MAX:
                return plan
    raise ValueError(f"lstm_seq: no tensor-core plan for rows {rows}, H {H} on {nsm} SMs "
                     "(H too large for one block's shared memory)")


def bwd_plan(B: int, H: int, nsm: int) -> MMAPlan:
    """The backward's plan: all rows in every block, warps split the 4H reduction (up to 16), the largest m-tile pass (<= 4) and
    then the deepest pipeline stage (k_chunk <= 4 / m_group) that fit."""
    nt = _n_sub(H, nsm)
    W = min(MAX_WARPS, _cdiv(4 * H, 16))
    for mg in range(min(4, _cdiv(B, 16)), 0, -1):
        for ck in range(4 // mg, 0, -1):
            plan = MMAPlan("bwd", B, H, nt, W, mg, ck)
            if (nt, mg) in BWD_VARIANTS and plan.smem_bytes <= SMEM_MAX:
                return plan
    raise ValueError(f"lstm_bwd: no tensor-core plan for B {B}, H {H} on {nsm} SMs "
                     "(H too large for one block's shared memory)")


def plan_owners(plan: MMAPlan) -> np.ndarray:
    """[rows * H, 3] int array: for each (row, unit) pair of the plan's
    problem (row-major), the (block, warp, count) that the kernel assigns
    it, where count is how many (block, warp) own it (1 when the plan is a
    partition). Mirrors the kernels' index arithmetic."""
    rows, H, J = plan.rows, plan.H, plan.units_per_block
    owner = np.full((rows, H, 2), -1, np.int64)
    count = np.zeros((rows, H), np.int64)

    def own(r, u, b, w):
        ok = (r < rows) & (u < H)
        r, u = r[ok], u[ok]
        np.add.at(count, (r, u), 1)
        owner[r, u, 0], owner[r, u, 1] = b, (w[ok] if np.ndim(w) else w)

    if plan.kind == "infer":
        for b in range(plan.blocks):
            units = np.arange(b * J, b * J + J)
            for w in range(plan.m_columns):  # K slice 0 owns the pairs
                for mt in range(w, plan.m_tiles, plan.m_columns):
                    r, u = np.meshgrid(np.arange(mt * 16, mt * 16 + 16), units, indexing="ij")
                    own(r.ravel(), u.ravel(), b, w)
    else:
        s = np.arange(plan.m_group * plan.n_sub * 128)
        c, lane, nt, m = s & 3, (s >> 2) & 31, (s >> 7) % plan.n_sub, (s >> 7) // plan.n_sub
        for b in range(plan.blocks):
            for mt0 in range(0, plan.m_tiles, plan.m_group):
                r = (mt0 + m) * 16 + (lane >> 2) + 8 * (c >> 1)
                u = b * J + nt * 8 + 2 * (lane & 3) + (c & 1)
                own(r, u, b, (s % plan.threads) // 32)
    return np.concatenate([owner.reshape(-1, 2), count.reshape(-1, 1)], axis=1)


def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _lib(name: str, argtypes, source: Optional[str] = None) -> ctypes.CDLL:
    """The library of ``csrc/<source or name>.cu`` with the C function
    ``name`` typed."""
    lib = build.library(source or name)
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
    if wh.dtype == torch.bfloat16:
        plan = infer_plan(B, H, _num_sms(xw.device), save_residuals)
        return lstm_infer(xw, mask, wh, h0, c0, plan, save_residuals)
    hs = torch.empty((T, B, H), device=xw.device)
    hT = torch.empty((B, H), device=xw.device)
    cT = torch.empty((B, H), device=xw.device)
    cs = torch.empty((T, B, H), device=xw.device) if save_residuals else None
    gates = torch.empty((T, B, H4), device=xw.device) if save_residuals else None
    lib = _lib("lstm_fwd", _ARGTYPES)
    with torch.cuda.device(xw.device):
        err = lib.lstm_fwd(
            xw.data_ptr(), mask.data_ptr(), wh.data_ptr(), 0,
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


def lstm_infer(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, plan: MMAPlan,
               save_residuals: bool = False) -> Tuple[torch.Tensor, ...]:
    """The bf16 forward on ``csrc/lstm_infer.cu`` with ``plan``
    (``infer_plan``): ``(hs, hT, cT)``, or with ``save_residuals``
    ``(hs, cs, gates, hT, cT)``. Takes contiguous CUDA tensors that passed
    ``lstm_seq``'s checks; ``lstm_seq`` calls it."""
    T, B, H4 = xw.shape
    H = H4 // 4
    if (plan.kind, plan.rows, plan.H) != ("infer", B, H) or wh.dtype != torch.bfloat16:
        raise ValueError(f"lstm_infer: plan {plan} does not fit rows {B}, H {H}, wh {wh.dtype}")
    hs = torch.empty((T, B, H), device=xw.device)
    hT = torch.empty((B, H), device=xw.device)
    cT = torch.empty((B, H), device=xw.device)
    cs = torch.empty((T, B, H), device=xw.device) if save_residuals else None
    gates = torch.empty((T, B, H4), device=xw.device) if save_residuals else None
    ring = torch.zeros(plan.ring_elems, device=xw.device, dtype=torch.bfloat16)
    lib = _lib("lstm_infer", INFER_ARGTYPES)
    with torch.cuda.device(xw.device):
        err = lib.lstm_infer(
            xw.data_ptr(), mask.data_ptr(), wh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), cs.data_ptr() if save_residuals else None,
            gates.data_ptr() if save_residuals else None, hT.data_ptr(), cT.data_ptr(),
            ring.data_ptr(), T, B, H, int(save_residuals), *plan.args(),
            torch.cuda.current_stream(xw.device).cuda_stream)
    build.check(lib, err, "lstm_infer")
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
    dh0 = torch.empty((B, H), device=gates.device)
    dc0 = torch.empty((B, H), device=gates.device)
    ptrs = (gates.data_ptr(), mask.data_ptr(), wh.data_ptr(), c_prev.data_ptr(),
            dhs.data_ptr(), dhT.data_ptr(), dcT.data_ptr(), da.data_ptr())
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    if wh.dtype == torch.bfloat16:
        plan = bwd_plan(B, H, _num_sms(gates.device))
        ring = torch.zeros(plan.ring_elems, device=gates.device, dtype=torch.bfloat16)
        lib = _lib("lstm_bwd_bf16", BWD_BF16_ARGTYPES, source="lstm_bwd")
        with torch.cuda.device(gates.device):
            err = lib.lstm_bwd_bf16(*ptrs, ring.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
                                    T, B, H, *plan.args(), stream)
    else:
        da_r = torch.empty((2, B, H4), device=gates.device)
        lib = _lib("lstm_bwd_f32", _BWD_F32_ARGTYPES, source="lstm_bwd")
        with torch.cuda.device(gates.device):
            err = lib.lstm_bwd_f32(*ptrs, da_r.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
                                   T, B, H, stream)
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
