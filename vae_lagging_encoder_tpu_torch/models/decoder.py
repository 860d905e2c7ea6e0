"""Decoder interface p(x|z) (the reference's DecoderBase)."""
from __future__ import annotations

import torch
from torch import nn


class DecoderBase(nn.Module):
    """Subclasses implement ``reconstruct_error(x, mask, z) -> [B, K]``."""

    def reconstruct_error(self, x: torch.Tensor, mask: torch.Tensor,
                          z: torch.Tensor) -> torch.Tensor:
        """-log p(x|z) per (item, z-sample): [B, K]."""
        raise NotImplementedError

    def log_probability(self, x, mask, z) -> torch.Tensor:
        """log p(x|z): [B, K]."""
        return -self.reconstruct_error(x, mask, z)
