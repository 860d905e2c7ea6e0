"""LSTM decoder p(x|z) for text: training and evaluation paths.

Counterpart of ``vae_lagging_encoder_tpu/models/dec_lstm.py``
(the reference's LSTMDecoder):

- word embedding with dropout_in (training only);
- z -> Linear(nz, nh, no bias) -> c0, h0 = tanh(c0);
- z concatenated to the word embedding at every timestep (LSTM input
  ni + nz); rows are z-major, row n = k * B + b;
- dropout_out on the LSTM outputs (training only), Linear(nh, V, no bias)
  logits; ``reconstruct_error`` is the token-summed masked cross-entropy
  per (sentence, z-sample).

Dropout is ``x / keep`` where ``u < keep`` (keep = 1 - rate) and zero
elsewhere, ``u`` uniform in [0, 1): the JAX package's
``bernoulli(key, keep, shape)`` is ``uniform(key, shape) < keep``, so a test
that hands in the JAX package's uniforms gets its exact keep-masks. The
uniforms come from the caller's ``draw(site, shape)`` (sites ``"keep_in"``
[B, T, ni] and ``"keep_out"`` [K*B, T, nh]); a ``draw`` marks training mode.

The z-sample axis is processed in chunks of ``iw_chunk`` samples (20 on
the kernel route with a fusable vocab, 10 otherwise, as in the JAX
package), which bounds the rows of each LSTM and CE call. Training takes
at most one chunk (the reference draws one z per sentence).

On the kernel route the vocab projection + CE is the fused CE of
``ops/ce_cuda.py`` with bf16 operands (the JAX package's ``fused_ce_logp``
default): ``ce_forward`` in evaluation, ``FusedCEFn`` (grad mode) in
training. Otherwise it is the JAX package's XLA branch on f32 logits:
``log_softmax`` + gather in training, gather - logsumexp in evaluation.
The JAX package routes to its CE kernel only when ``nh % 128 == 0`` (a TPU
lane tile) and V >= 1024; the port drops the tile gate and keeps the
vocab-size one (``ce_fusable``).

Generation (greedy, sample, beam) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..ops.ce_cuda import FusedCEFn, ce_forward
from .decoder import DecoderBase
from .lstm_core import LSTMParams, lstm_run, uniform_


Draw = Callable[[str, Tuple[int, ...]], torch.Tensor]


def ce_fusable(vocab: int) -> bool:
    """Vocabularies large enough that the fused CE is the route (JAX: V >= 1024)."""
    return vocab >= 1024


def dropout(x: torch.Tensor, rate: float, draw: Optional[Draw], site: str) -> torch.Tensor:
    """The JAX package's ``_dropout``: identity outside training (no
    ``draw``) or at rate 0, else ``x / keep`` where ``draw(site) < keep``."""
    if draw is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(draw(site, tuple(x.shape)) < keep, x / keep, 0.0)


class LSTMDecoder(DecoderBase):
    def __init__(self, vocab_size: int, ni: int, nh: int, nz: int,
                 dropout_in: float = 0.5, dropout_out: float = 0.5,
                 kernel_route: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size, self.ni, self.nh, self.nz = vocab_size, ni, nh, nz
        self.dropout_in, self.dropout_out = dropout_in, dropout_out
        self.kernel_route = kernel_route
        self.compute_dtype = compute_dtype
        self.fused_ce = kernel_route and ce_fusable(vocab_size)
        self.iw_chunk = 20 if self.fused_ce else 10
        self.emb = nn.Parameter(torch.empty(vocab_size, ni))
        self.lstm = LSTMParams(ni + nz, nh)
        self.trans = nn.Parameter(torch.empty(nz, nh))
        self.pred = nn.Parameter(torch.empty(nh, vocab_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init recipe: embeddings U(-0.1, 0.1), the rest U(-0.01, 0.01)."""
        uniform_(self.emb, 0.1, generator)
        self.lstm.reset_parameters(generator, 0.01)
        uniform_(self.trans, 0.01, generator)
        uniform_(self.pred, 0.01, generator)

    def _init_state(self, z_flat: torch.Tensor):
        """z [N, nz] -> (h0, c0): c0 = z @ trans, h0 = tanh(c0)."""
        c0 = z_flat @ self.trans
        return torch.tanh(c0), c0

    def _hidden_states(self, tokens_in: torch.Tensor, z: torch.Tensor,
                       draw: Optional[Draw] = None) -> torch.Tensor:
        """tokens_in [B, T], z [B, K, nz] -> LSTM outputs [K*B, T, nh], row k*B + b."""
        B, T = tokens_in.shape
        K = z.shape[1]
        emb = dropout(self.emb[tokens_in], self.dropout_in, draw, "keep_in")
        emb_k = emb[None].expand(K, B, T, self.ni).reshape(K * B, T, self.ni)
        z_flat = z.transpose(0, 1).reshape(K * B, self.nz)
        z_seq = z_flat[:, None, :].expand(K * B, T, self.nz)
        h0, c0 = self._init_state(z_flat)
        outs, _ = lstm_run(self.lstm, torch.cat([emb_k, z_seq], dim=-1), None, h0, c0,
                           kernel_route=self.kernel_route,
                           compute_dtype=self.compute_dtype)
        return outs

    def decode(self, tokens_in: torch.Tensor, z: torch.Tensor,
               draw: Optional[Draw] = None) -> torch.Tensor:
        """Teacher-forced logits: tokens_in [B, T], z [B, K, nz] -> [B, K, T, V]
        (with dropout when ``draw`` is given)."""
        B, T = tokens_in.shape
        K = z.shape[1]
        cd = self.compute_dtype
        outs = dropout(self._hidden_states(tokens_in, z, draw), self.dropout_out, draw,
                       "keep_out")
        logits = outs.reshape(-1, self.nh).to(cd).float() @ self.pred.to(cd).float()
        return logits.reshape(K, B, T, self.vocab_size).permute(1, 0, 2, 3)

    def reconstruct_error(self, tokens: torch.Tensor, mask: torch.Tensor,
                          z: torch.Tensor, draw: Optional[Draw] = None) -> torch.Tensor:
        """-log p(x|z) per (sentence, z-sample): [B, K].

        tokens [B, T] = <s> w1..wn </s> pad..; inputs tokens[:, :-1],
        targets tokens[:, 1:], target mask mask[:, 1:]. ``draw`` selects
        training mode: dropout, and the CE that takes a gradient."""
        B, T = tokens.shape
        if draw is not None and z.shape[1] > self.iw_chunk:
            raise ValueError(f"training takes at most iw_chunk = {self.iw_chunk} z-samples "
                             f"per sentence, got {z.shape[1]}")

        def rec_chunk(z_chunk):  # [B, k, nz] -> [B, k]
            k = z_chunk.shape[1]
            if self.fused_ce:
                outs = dropout(self._hidden_states(tokens[:, :-1], z_chunk, draw),
                               self.dropout_out, draw, "keep_out")  # [k*B, T-1, nh]
                tgt = tokens[None, :, 1:].expand(k, B, T - 1).reshape(-1)
                h = outs.reshape(-1, self.nh)
                if draw is None:
                    logp, _ = ce_forward(h, self.pred, tgt, torch.bfloat16)
                else:
                    logp = FusedCEFn.apply(h, self.pred, tgt, torch.bfloat16)
                tok_lp = logp.reshape(k, B, T - 1).transpose(0, 1)
            else:
                logits = self.decode(tokens[:, :-1], z_chunk, draw)  # [B, k, T-1, V]
                tgt = tokens[:, None, 1:].expand(B, k, T - 1)[..., None]
                if draw is None:
                    tok_lp = logits.gather(-1, tgt)[..., 0] - torch.logsumexp(logits, dim=-1)
                else:
                    tok_lp = torch.log_softmax(logits, dim=-1).gather(-1, tgt)[..., 0]
            return -torch.sum(tok_lp * mask[:, None, 1:], dim=-1)

        return torch.cat([rec_chunk(z[:, s:s + self.iw_chunk])
                          for s in range(0, z.shape[1], self.iw_chunk)], dim=1)
