"""Shared LSTM machinery.

Counterpart of ``vae_lagging_encoder_tpu/models/lstm_core.py``. Parameters
keep the JAX layouts: ``wx [ni, 4H]``, ``wh [H, 4H]`` and the two PyTorch
biases ``b_ih``/``b_hh`` as separate parameters, gate order (i, f, g, o).
The input projection for the whole sequence is hoisted out of the
recurrence, and the recurrence runs on ``ops/lstm_cuda.py``. ``lstm_run``
takes its input in two parts: a per-sentence sequence ``x`` [Bs, T, d_seq]
and an optional per-row constant ``x_row`` [K*Bs, d_row] (the decoder's
embeddings and z), so that ``[x; x_row] @ wx`` is computed as
``x @ wx[:d_seq]`` once per sentence and step plus ``x_row @ wx[d_seq:]``
(with the bias) once per row, and ``xw`` is written once, contiguous in the
kernel's [T, rows, 4H] layout (without ``x_row``: the product, time-major,
plus the bias). The products stay in f32 (TF32 off); only
the order of the f32 sums within a dot product differs from the single
product of the concatenation. A ``SeqInput`` carries the sentences' product
from the first call that reads it to the later ones (the decoder's
z-chunks of one evaluation). Under a profiler a call's input products are
the span ``lstm.input_proj`` and the recurrence ``lstm.recurrence``, each
with its device time, and the counter ``lstm.input_rows_shared`` adds the
rows assembled less the sentence rows computed (utils/profiling.py);
inside a graph replay none of them exists.

Routes (``kernel_route`` = the config's ``use_pallas``):

- kernel route: ``wh`` goes to bf16 (f32 accumulation) when H > 512 or the
  compute dtype is bf16, as the JAX package's Pallas route does. Without a
  gradient a CUDA input launches the forward-only kernel; with one it goes
  through ``LSTMSeqFn`` (the residual-saving forward kernel and the
  backward-sweep kernel, the counterpart of ``lstm_seq_fused``). A CPU
  input runs the plain versions of the same. The JAX package also gates its kernels on TPU tiles (H % 128,
  B % 8, B <= 128 for the training kernel, a VMEM fit for the inference
  kernel) and falls back to scan (with f32 ``wh``) off those tiles; the
  port has no such gates, so at an off-tile shape the port keeps the kernel
  route's numerics where the JAX package would switch to scan's.
- scan route: the plain recurrence with ``wh`` in the compute dtype — the
  numerics of the JAX package's ``lax.scan`` route.

At masked (pad) positions both routes emit the KEPT state, as the TPU
kernels do; the JAX scan route emits the raw step output there. Callers
read only unmasked positions and the final carry, where all agree.

``lstm_cell`` is one step of the recurrence, ``wh`` in the compute dtype
(f32 by default): the step of the JAX package's generation loops, which
never take the kernel route, and so neither does the port's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.lstm_cuda import LSTMSeqFn, lstm_seq, lstm_seq_plain
from ..utils.profiling import count, span


def uniform_(t: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-scale, scale, generator=generator)


class LSTMParams(nn.Module):
    """``wx [input_dim, 4H]``, ``wh [H, 4H]``, ``b_ih``, ``b_hh [4H]``."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.wx = nn.Parameter(torch.empty(input_dim, 4 * hidden_dim))
        self.wh = nn.Parameter(torch.empty(hidden_dim, 4 * hidden_dim))
        self.b_ih = nn.Parameter(torch.empty(4 * hidden_dim))
        self.b_hh = nn.Parameter(torch.empty(4 * hidden_dim))

    def reset_parameters(self, generator: torch.Generator, scale: float = 0.01) -> None:
        for p in (self.wx, self.wh, self.b_ih, self.b_hh):
            uniform_(p, scale, generator)


def lstm_bias(params: LSTMParams) -> torch.Tensor:
    """The effective gate bias ``b_ih + b_hh``."""
    return params.b_ih + params.b_hh


def lstm_cell(h: torch.Tensor, c: torch.Tensor, xw_t: torch.Tensor, wh: torch.Tensor,
              compute_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step given the input projection ``xw_t`` [N, 4H] (biases
    included): h and ``wh`` rounded to ``compute_dtype``, the product in f32."""
    cd = compute_dtype
    gates = xw_t + h.to(cd).float() @ wh.to(cd).float()
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


class SeqInput:
    """A batch's per-sentence LSTM input ``x`` [Bs, T, d_seq] and, once an
    ``lstm_run`` has computed it, its product with ``wx[:d_seq]`` (no
    bias), time-major [T, Bs, 4H] (``proj``). Calls of one LSTM
    that read the same ``SeqInput`` compute that product once; the caller
    shares one only where no gradient is taken (a checkpointed chunk must
    recompute whatever it computed)."""

    def __init__(self, x: torch.Tensor):
        self.x, self.proj = x, None


def lstm_run(params: LSTMParams, x,
             mask: Optional[torch.Tensor] = None,
             h0: Optional[torch.Tensor] = None,
             c0: Optional[torch.Tensor] = None,
             kernel_route: bool = False,
             compute_dtype: torch.dtype = torch.float32,
             x_row: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run the LSTM over a padded batch.

    x: [Bs, T, d_seq], or a ``SeqInput`` of it; x_row: None (then d_seq is
    the input dim and there are Bs rows) or [K*Bs, d_row], d_seq + d_row
    the input dim: row n = k*Bs + b reads ``[x[b, t]; x_row[n]]`` at step
    t. mask: [rows, T] (1 real / 0 pad) or None.
    Returns (outputs [rows, T, H], (h_T, c_T)), the carries at each row's
    last real token when a mask is given.
    """
    seq = x if isinstance(x, SeqInput) else SeqInput(x)
    Bs, T, d_seq = seq.x.shape
    N = Bs if x_row is None else x_row.shape[0]
    H = params.wh.shape[0]
    cd = compute_dtype
    wx, bias = params.wx.to(cd).float(), lstm_bias(params)
    fresh = seq.proj is None
    with span("lstm.input_proj", device=True):
        if fresh:  # the small input transposed, so that the product comes out time-major
            x_t = seq.x.transpose(0, 1).reshape(T * Bs, d_seq).to(cd).float()
            seq.proj = (x_t @ wx[:d_seq]).view(T, Bs, 4 * H)
        if x_row is not None:
            p_row = x_row.to(cd).float() @ wx[d_seq:] + bias
    # xw[t, k*Bs + b] = proj[t, b] + p_row[k*Bs + b] (the bias alone without
    # x_row): one pass, written contiguous (a strided result would not take
    # the view). No addmm: at the encoder's shapes cuBLASLt's bias epilogue
    # launches a cudaMemsetAsync that a CUDA-activity trace records with no
    # device event.
    if x_row is None:
        xw = seq.proj + bias
    else:
        xw = (seq.proj[:, None] + p_row.view(1, N // Bs, Bs, 4 * H)).view(T, N, 4 * H)
    shared = N - (Bs if fresh else 0)  # rows whose sentence product was not computed for them
    if shared:
        count("lstm.input_rows_shared", shared)
    m = mask.transpose(0, 1) if mask is not None else seq.x.new_ones((T, N))
    if h0 is None:
        h0 = seq.x.new_zeros((N, H))
    if c0 is None:
        c0 = seq.x.new_zeros((N, H))

    if not kernel_route:
        wh = params.wh.to(cd)
        with span("lstm.recurrence", device=True):
            hs, hT, cT = lstm_seq_plain(xw, m, wh, h0, c0)
    else:
        wh = params.wh.to(torch.bfloat16 if (H > 512 or cd == torch.bfloat16)
                          else torch.float32)
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (xw, wh, h0, c0))
        run = LSTMSeqFn.apply if needs_grad else lstm_seq
        with span("lstm.recurrence", device=True):
            hs, hT, cT = run(xw, m.contiguous(), wh, h0, c0)
    return hs.transpose(0, 1), (hT, cT)
