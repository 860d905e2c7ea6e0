"""The yardstick's arithmetic: peaks, model FLOPs, and the operations and
bytes of each kernel launch.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s in
bf16, 3.35 TB/s of HBM3 (67 TFLOP/s in f32 without the tensor cores).
Every share in this benchmark is of the bf16 peak, so that a later change
to lower-precision products cannot read above 100 %.

Model FLOPs count a matrix product's multiply-adds twice, at the real
(unmasked) positions only, and a training step as three forwards (the
forward and a backward of twice its cost); the IW estimator is forward
only. Rewritten from ``bench.py``'s ``analytic_flops`` and
``analytic_iwnll_flops``, which counted every padded position.

A launch's bound is ``max(ops / 989e12, bytes / 3.35e12)`` seconds for the
function the kernel computes at that launch's shapes, each input read once
and each output written once (``chip_smoke.py::bound``): inputs at the
positions the function needs, outputs whole.
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES)


# ------------------------------------------------------------ model FLOPs
def text_token_flops(cfg: dict, vocab: int) -> Dict[str, float]:
    """Forward FLOPs per real position: the encoder LSTM's (input
    projection and recurrence) per source token, the decoder's (LSTM with z
    at its input, the vocabulary projection) per predicted token."""
    enc = 2.0 * (cfg["ni"] + cfg["enc_nh"]) * 4 * cfg["enc_nh"]
    dec = 2.0 * ((cfg["ni"] + cfg["nz"] + cfg["dec_nh"]) * 4 * cfg["dec_nh"]
                 + cfg["dec_nh"] * vocab)
    return {"enc": enc, "dec": dec}


def text_sentence_flops(cfg: dict) -> Dict[str, float]:
    """Forward FLOPs per sentence outside the positions: the posterior head
    (h -> 2 nz) once, the decoder's z -> c0 per sample."""
    return {"enc": 2.0 * cfg["enc_nh"] * 2 * cfg["nz"], "dec": 2.0 * cfg["nz"] * cfg["dec_nh"]}


def text_train_flops(cfg: dict, lengths: Sequence[int], nsamples: int = 1) -> float:
    """One training step over sentences of ``lengths`` tokens (with <s> and
    </s>): 3 x forward, the decoder once per z-sample."""
    tok, sen = text_token_flops(cfg, cfg["vocab_size"]), text_sentence_flops(cfg)
    enc = sum(lengths) * tok["enc"] + len(lengths) * sen["enc"]
    dec = sum(n - 1 for n in lengths) * tok["dec"] + len(lengths) * sen["dec"]
    return 3.0 * (enc + nsamples * dec)


def text_padded_train_flops(cfg: dict, batch: int, T: int) -> float:
    """``bench.py::analytic_flops``'s count for one [batch, T] step: every
    padded position through all three LSTM and vocabulary products."""
    tok = text_token_flops(cfg, cfg["vocab_size"])
    return 3.0 * (tok["enc"] + tok["dec"]) * batch * T


def text_iwnll_flops(cfg: dict, lengths: Sequence[int], nsamples: int, chunk: int) -> float:
    """The IW estimator over sentences of ``lengths``: the encoder once per
    chunk of ``chunk`` samples, the decoder once per sample."""
    tok, sen = text_token_flops(cfg, cfg["vocab_size"]), text_sentence_flops(cfg)
    enc = sum(lengths) * tok["enc"] + len(lengths) * sen["enc"]
    dec = sum(n - 1 for n in lengths) * tok["dec"] + len(lengths) * sen["dec"]
    return -(-nsamples // chunk) * enc + nsamples * dec


# ------------------------------------------------------- kernel launches
def lstm_fwd_bound(T: int, rows: int, H: int, real: int, residuals: bool) -> float:
    """The masked LSTM forward over T steps of ``rows`` rows, ``real``
    unmasked (row, step) positions: the recurrent product at those (bf16
    wh); xw [T, rows, 4H] f32 read there, the mask, wh in bf16 and h0, c0
    read; hs (and with ``residuals`` cs and the gates [T, rows, 4H]) and
    hT, cT written whole."""
    ops = 2.0 * real * 4 * H * H
    out = T * rows * H * (6 if residuals else 1) + 2 * rows * H
    nbytes = 4.0 * (real * 4 * H + T * rows + 2 * rows * H + out) + 2.0 * H * 4 * H
    return bound_s(ops, nbytes)


def lstm_bwd_bound(T: int, rows: int, H: int, real: int) -> float:
    """The reverse sweep: dh = da wh^T at the real positions; the gates,
    c_prev and dhs read there, the mask, dhT, dcT and wh read; da [T, rows,
    4H], dh0 and dc0 written whole."""
    ops = 2.0 * real * 4 * H * H
    nbytes = (4.0 * (real * 4 * H + T * rows + 2 * real * H + 2 * rows * H
                     + T * rows * 4 * H + 2 * rows * H) + 2.0 * H * 4 * H)
    return bound_s(ops, nbytes)


def ce_fwd_bound(N: int, nh: int, V: int, spill: bool) -> float:
    """The fused projection + CE over N rows: bf16 h and W read, the target
    read, log p and the logsumexp written (and in grad mode the bf16
    logits)."""
    ops = 2.0 * N * nh * V
    nbytes = 2.0 * (N * nh + nh * V) + 4.0 * N + 8.0 * N + (2.0 * N * V if spill else 0.0)
    return bound_s(ops, nbytes)


def ce_bwd_bound(N: int, nh: int, V: int) -> float:
    """The CE's VJP: d from the bf16 logits, dh = d W^T, dW = h^T d; the
    logits, bf16 h and W, lse, target and g read, dh and dW (f32) written."""
    ops = 4.0 * N * nh * V
    nbytes = (2.0 * N * V + 2.0 * (N * nh + nh * V) + 12.0 * N
              + 4.0 * (N * nh + nh * V))
    return bound_s(ops, nbytes)
