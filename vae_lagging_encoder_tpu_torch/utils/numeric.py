"""Numerically stable helpers (the reference's modules/utils.py)."""
from __future__ import annotations

import torch


def log_sum_exp(value: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Stable log(sum(exp(value))) along ``dim``; the reference's
    ``log_sum_exp(value, dim, keepdim)`` calling convention."""
    return torch.logsumexp(value, dim=dim, keepdim=keepdim)
