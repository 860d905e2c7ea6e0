"""Plain-PyTorch reference of the text VAE (Yahoo and Yelp configurations).

The model of He et al. 2019 ("Lagging Inference Networks and Posterior
Collapse in VAEs", jxhe/vae-lagging-encoder, modules/encoders/enc_lstm.py,
modules/decoders/dec_lstm.py, text.py): an LSTM encoder over the whole
sentence whose final state gives the Gaussian posterior's (mu, logvar),
and an LSTM decoder with z fed at every step and as its initial state
(c0 = z W_trans, h0 = tanh c0), word dropout on the decoder's input
embeddings and on its outputs, a vocabulary projection and the masked
token cross-entropy; the loss is reconstruction + kl_weight * KL, its
gradient clipped to a global norm over encoder and decoder together, each
side stepped by its own optimizer. ``nll_iw`` is the paper's
importance-weighted NLL.

Written from that description, in plain PyTorch, at the precision the
configuration states (``numerics.py``): the vocabulary projection takes
bf16 operands with f32 accumulation, and so does its backward (the CE's
d rounded to bf16); the recurrent product h W_h too where the
configuration says so (``Products.rec``: then the LSTM's da is rounded
before da W_h^T and dW_h is rounded to bf16); the other products are f32.
The weights are a dict ``name -> tensor`` in the layouts ``wx [in, 4H]``,
``wh [H, 4H]`` (gates i, f, g, o), ``linear [nh, 2 nz]``, ``trans [nz,
nh]``, ``pred [nh, V]``. Noise comes in as tensors: eps, and the dropout
uniforms (kept where u < 1 - rate, scaled by 1 / (1 - rate)).
At a masked step the LSTM keeps its state.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .numerics import Products

Weights = Dict[str, torch.Tensor]
CE_ROWS = 8192  # rows of [rows, V] f32 logits held at once


class _LSTM(torch.autograd.Function):
    """Masked whole-sequence LSTM: xw [T, R, 4H] (input projection with
    biases), mask [T, R], wh [H, 4H], h0, c0 [R, H] -> (hs [T, R, H], hT,
    cT). h and wh enter the recurrent product through ``prods.rec``."""

    @staticmethod
    def forward(ctx, xw, mask, wh, h0, c0, prods):
        T, R, H4 = xw.shape
        H = H4 // 4
        rec = prods.rec
        whb = rec(wh)
        h, c = h0, c0
        hs, cs, acts = [], [], []
        for t in range(T):
            a = xw[t] + rec(h) @ whb
            i, f, g, o = a.split(H, dim=-1)
            i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            m = mask[t, :, None]
            h = m * h_new + (1.0 - m) * h
            c = m * c_new + (1.0 - m) * c
            hs.append(h)
            cs.append(c)
            acts.append(torch.cat([i, f, g, o], dim=-1))
        hs, cs, acts = torch.stack(hs), torch.stack(cs), torch.stack(acts)
        ctx.save_for_backward(mask, wh, h0, c0, hs, cs, acts)
        ctx.prods = prods
        ctx.set_materialize_grads(False)
        return hs, h, c

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        mask, wh, h0, c0, hs, cs, acts = ctx.saved_tensors
        T, R, H = hs.shape
        rec = ctx.prods.rec
        whb = rec(wh)
        dh = torch.zeros_like(h0) if dhT is None else dhT
        dc = torch.zeros_like(c0) if dcT is None else dcT
        c_prev = torch.cat([c0[None], cs[:-1]])
        h_prev = torch.cat([h0[None], hs[:-1]])
        da = torch.empty_like(acts)
        for t in reversed(range(T)):
            i, f, g, o = acts[t].split(H, dim=-1)
            tanh_c = torch.tanh(f * c_prev[t] + i * g)
            dhk = dh if dhs is None else dh + dhs[t]
            m = mask[t, :, None]
            dh_raw, dc_raw = m * dhk, m * dc
            do = dh_raw * tanh_c
            dc_tot = dc_raw + dh_raw * o * (1.0 - tanh_c * tanh_c)
            a = torch.cat([dc_tot * g * i * (1.0 - i), dc_tot * c_prev[t] * f * (1.0 - f),
                           dc_tot * i * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
            da[t] = a
            dh = rec(a) @ whb.T + (1.0 - m) * dhk
            dc = dc_tot * f + (1.0 - m) * dc
        # dW_h = h_prev^T da: an f32 product, rounded to wh's type
        dwh = rec(ctx.prods.mm(h_prev.reshape(-1, H).T, da.reshape(-1, 4 * H)))
        return da, None, dwh, dh, dc, None


class _CE(torch.autograd.Function):
    """Per-row target log-probability of logits = h W (bf16 operands, f32
    accumulation: ``prods.low``). The backward takes the logits rounded to
    bf16 and their logsumexp, so each softmax row sums to one, and rounds
    d = (onehot - p) g to bf16 before dh = d W^T and dW = h^T d."""

    @staticmethod
    def forward(ctx, h, w, tgt, prods):
        low = prods.low
        hb, wb = low(h), low(w)
        logp, lse2, spill = [], [], []
        for s in range(0, h.shape[0], CE_ROWS):
            logits = hb[s:s + CE_ROWS] @ wb
            t = tgt[s:s + CE_ROWS, None]
            logp.append(logits.gather(1, t)[:, 0] - torch.logsumexp(logits, dim=-1))
            rounded = low(logits)
            spill.append(rounded)
            lse2.append(torch.logsumexp(rounded, dim=-1))
        ctx.save_for_backward(hb, wb, tgt, torch.cat(lse2), torch.cat(spill))
        ctx.low = low
        return torch.cat(logp)

    @staticmethod
    def backward(ctx, g):
        hb, wb, tgt, lse, spill = ctx.saved_tensors
        dh, dw = torch.empty_like(hb), torch.zeros_like(wb)
        for s in range(0, hb.shape[0], CE_ROWS):
            p = torch.exp(spill[s:s + CE_ROWS] - lse[s:s + CE_ROWS, None])
            gs = g[s:s + CE_ROWS, None]
            t = tgt[s:s + CE_ROWS, None]
            d = -(p * gs)
            d.scatter_(1, t, (1.0 - p.gather(1, t)) * gs)
            d = ctx.low(d)
            dh[s:s + CE_ROWS] = d @ wb.T
            dw += hb[s:s + CE_ROWS].T @ d
        return dh, dw, None, None


@torch.no_grad()
def ce_logp(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor, prods: Products
            ) -> torch.Tensor:
    """The forward alone, in row blocks (evaluation)."""
    wb = prods.low(w)
    out = []
    for s in range(0, h.shape[0], CE_ROWS):
        logits = prods.low(h[s:s + CE_ROWS]) @ wb
        out.append(logits.gather(1, tgt[s:s + CE_ROWS, None])[:, 0]
                   - torch.logsumexp(logits, dim=-1))
    return torch.cat(out)


def _lstm(w: Weights, pre: str, x: torch.Tensor, mask: torch.Tensor, h0, c0,
          prods: Products):
    """x [R, T, in] -> (hs [R, T, H], hT): input projection (f32 product)
    with both biases, then the recurrence."""
    R, T, _ = x.shape
    H = w[pre + "wh"].shape[0]
    xw = prods.mm(x.reshape(R * T, -1), w[pre + "wx"]).reshape(R, T, 4 * H)
    xw = (xw + (w[pre + "b_ih"] + w[pre + "b_hh"])).transpose(0, 1)
    hs, hT, _ = _LSTM.apply(xw.contiguous(), mask.transpose(0, 1).contiguous(), w[pre + "wh"],
                            h0, c0, prods)
    return hs.transpose(0, 1), hT


def encode(w: Weights, tokens, mask, prods: Products) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, logvar) [B, nz]; logvar clipped to [-8, 8]."""
    B = tokens.shape[0]
    H = w["enc.lstm.wh"].shape[0]
    zeros = tokens.new_zeros((B, H), dtype=torch.float32)
    _, hT = _lstm(w, "enc.lstm.", w["enc.emb"][tokens], mask, zeros, zeros, prods)
    mu, logvar = prods.mm(hT, w["enc.linear"]).chunk(2, dim=-1)
    return mu, torch.clamp(logvar, -8.0, 8.0)


def _dropout(x: torch.Tensor, u: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    return x if u is None else torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0)


def decoder_logp(w: Weights, tokens, z, prods: Products, u_in=None, u_out=None,
                 rate_in: float = 0.0, rate_out: float = 0.0, grad: bool = True):
    """log p(x_t | x_<t, z) of every target position: [B, K, T-1]
    (tokens [B, T], z [B, K, nz]; rows of the LSTM are k * B + b)."""
    B, T = tokens.shape
    K, nz = z.shape[1], z.shape[2]
    H = w["dec.lstm.wh"].shape[0]
    emb = _dropout(w["dec.emb"][tokens[:, :-1]], u_in, rate_in)
    ni = emb.shape[-1]
    z_flat = z.transpose(0, 1).reshape(K * B, nz)
    c0 = prods.mm(z_flat, w["dec.trans"])
    x = torch.cat([emb[None].expand(K, B, T - 1, ni).reshape(K * B, T - 1, ni),
                   z_flat[:, None, :].expand(K * B, T - 1, nz)], dim=-1)
    ones = x.new_ones((K * B, T - 1))
    hs, _ = _lstm(w, "dec.lstm.", x, ones, torch.tanh(c0), c0, prods)
    h = _dropout(hs, u_out, rate_out).reshape(-1, H)
    tgt = tokens[None, :, 1:].expand(K, B, T - 1).reshape(-1)
    logp = (_CE.apply(h, w["dec.pred"], tgt, prods) if grad
            else ce_logp(h, w["dec.pred"], tgt, prods))
    return logp.reshape(K, B, T - 1).transpose(0, 1)


def gaussian_kl(mu, logvar):
    return 0.5 * torch.sum(mu ** 2 + torch.exp(logvar) - logvar - 1.0, dim=-1)


def train_loss(w: Weights, cfg: dict, batch, noise: dict, kl_weight, prods: Products):
    """The training loss of one batch (mean over its real sentences) and
    its sum, with the step's noise ``{"eps": [B, 1, nz], "keep_in": [B,
    T-1, ni], "keep_out": [B, T-1, nh]}``."""
    tokens, mask, row_weight = batch
    mu, logvar = encode(w, tokens, mask, prods)
    z = mu[:, None, :] + noise["eps"] * torch.exp(0.5 * logvar)[:, None, :]
    kl = gaussian_kl(mu, logvar)
    lp = decoder_logp(w, tokens, z, prods, noise.get("keep_in"), noise.get("keep_out"),
                      cfg["dec_dropout_in"], cfg["dec_dropout_out"])
    rec = -torch.sum(lp * mask[:, None, 1:], dim=-1).mean(dim=1)
    loss = rec * row_weight + kl_weight * (kl * row_weight)
    loss_sum = loss.sum()
    return loss_sum / torch.clamp(row_weight.sum(), min=1.0), loss_sum


@torch.no_grad()
def nll_iw(w: Weights, tokens, mask, eps_chunks, prods: Products, rows: int = 640):
    """Importance-weighted NLL per sentence [B] from ``eps_chunks`` (one
    [B, ns, nz] tensor per chunk of samples; each chunk encodes x again).
    The decoder runs ``rows`` LSTM rows at a time."""
    B = tokens.shape[0]
    nz = eps_chunks[0].shape[-1]
    log2pi = math.log(2 * math.pi)
    log_w = []
    for eps in eps_chunks:
        mu, logvar = encode(w, tokens, mask, prods)
        z = mu[:, None, :] + eps * torch.exp(0.5 * logvar)[:, None, :]
        per = max(1, rows // B)
        rec = torch.cat([decoder_logp(w, tokens, z[:, s:s + per], prods, grad=False)
                         for s in range(0, z.shape[1], per)], dim=1)
        log_px = torch.sum(rec * mask[:, None, 1:], dim=-1)
        log_pz = -0.5 * (torch.sum(z ** 2, dim=-1) + nz * log2pi)
        log_q = (-0.5 * torch.sum((z - mu[:, None]) ** 2 / torch.exp(logvar)[:, None], dim=-1)
                 - 0.5 * (nz * log2pi + torch.sum(logvar, dim=-1))[:, None])
        log_w.append(log_pz + log_px - log_q)
    n = sum(e.shape[1] for e in eps_chunks)
    return -(torch.logsumexp(torch.cat(log_w, dim=1), dim=1) - math.log(n))
