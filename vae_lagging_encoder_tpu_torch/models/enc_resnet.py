"""ResNet image encoder with a Gaussian posterior head.

Counterpart of ``vae_lagging_encoder_tpu/models/enc_resnet.py`` (the
reference's ResNetEncoderV2): per stage of width c, a stride-2 "down" 3x3
conv -> ELU, then a residual block conv1 -> ELU -> conv2, residual add ->
ELU; then the NHWC flatten -> fc -> (mu, logvar), logvar clipped to
[-8, 8]. Parameters keep the JAX layouts (HWIO conv weights, fc
[H*W*C, 2 nz] with its rows in NHWC flatten order), so the JAX package's
weights load by name (``utils/jax_params.py``). The convs run in
``compute_dtype``; the flatten and fc in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv2d
from .encoder import GaussianEncoderBase
from .lstm_core import uniform_


class _Stage(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.down = nn.Parameter(torch.empty(3, 3, cin, c))
        self.conv1 = nn.Parameter(torch.empty(3, 3, c, c))
        self.conv2 = nn.Parameter(torch.empty(3, 3, c, c))


class ResNetEncoderV2(GaussianEncoderBase):
    def __init__(self, nz: int, channels: Tuple[int, ...] = (64, 64, 64),
                 img_size: Tuple[int, int, int] = (28, 28, 1),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nz, self.channels, self.img_size = nz, tuple(channels), tuple(img_size)
        self.compute_dtype = compute_dtype
        self.blocks = nn.ModuleList()
        cin, h = img_size[2], img_size[0]
        for c in channels:
            self.blocks.append(_Stage(cin, c))
            cin, h = c, -(-h // 2)
        self.fc = nn.Parameter(torch.empty(h * h * cin, 2 * nz))
        self.fc_b = nn.Parameter(torch.empty(2 * nz))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's recipe: convs and fc U(-0.01, 0.01), fc bias 0."""
        for blk in self.blocks:
            for p in (blk.down, blk.conv1, blk.conv2):
                uniform_(p, 0.01, generator)
        uniform_(self.fc, 0.01, generator)
        with torch.no_grad():
            self.fc_b.zero_()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, H, W, C] (binarized) -> (mu, logvar) [B, nz]; ``mask`` unused."""
        cd = self.compute_dtype
        h = x.to(cd)
        for blk in self.blocks:
            h = F.elu(conv2d(h, blk.down.to(cd), stride=2))
            r = F.elu(conv2d(h, blk.conv1.to(cd)))
            r = conv2d(r, blk.conv2.to(cd))
            h = F.elu(h + r)
        stats = h.reshape(h.shape[0], -1).float() @ self.fc + self.fc_b
        mu, logvar = stats.chunk(2, dim=-1)
        # [-8, 8] only removes exp() overflow in the aggressive loop
        return mu, torch.clamp(logvar, -8.0, 8.0)
