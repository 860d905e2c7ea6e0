"""LSTM sentence encoder with a Gaussian posterior head.

Counterpart of ``vae_lagging_encoder_tpu/models/enc_lstm.py``:
Embedding(V, ni) -> 1-layer LSTM(ni, nh) -> final carry (the masked carry
gives each row's state at its last real token) -> Linear(nh, 2 nz, no
bias) -> (mu, logvar), logvar clipped to [-8, 8].
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .encoder import GaussianEncoderBase
from .lstm_core import LSTMParams, lstm_run, uniform_


class GaussianLSTMEncoder(GaussianEncoderBase):
    def __init__(self, vocab_size: int, ni: int, nh: int, nz: int,
                 kernel_route: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size, self.ni, self.nh, self.nz = vocab_size, ni, nh, nz
        self.kernel_route = kernel_route
        self.compute_dtype = compute_dtype
        self.emb = nn.Parameter(torch.empty(vocab_size, ni))
        self.lstm = LSTMParams(ni, nh)
        self.linear = nn.Parameter(torch.empty(nh, 2 * nz))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init recipe: embeddings U(-0.1, 0.1), the rest U(-0.01, 0.01)."""
        uniform_(self.emb, 0.1, generator)
        self.lstm.reset_parameters(generator, 0.01)
        uniform_(self.linear, 0.01, generator)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, T] (full sentence incl. <s>/</s>) -> (mu, logvar) [B, nz]."""
        x = self.emb[tokens]
        _, (h_final, _) = lstm_run(self.lstm, x, mask, kernel_route=self.kernel_route,
                                   compute_dtype=self.compute_dtype)
        mu, logvar = (h_final @ self.linear).chunk(2, dim=-1)
        return mu, torch.clamp(logvar, -8.0, 8.0)
