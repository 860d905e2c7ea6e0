"""The published OmniGlot encoder: a ResNet with batch norm.

jxhe/vae-lagging-encoder's ``modules/encoders/enc_resnet_v2.py`` as
``config/config_omniglot.py`` builds it (arXiv:1901.05534, Table 3),
selected by ``image_arch="published"`` (``build_image_vae``). The JAX
package's encoder without batch norm is models/enc_resnet.py. In
PyTorch's NCHW layout, f32, convolutions without bias, ``BatchNorm2d``
with PyTorch's defaults (eps 1e-5, momentum 0.1; batch statistics in
training, running statistics in evaluation: models/modes.py):

- per stage of width c, stride 2 (28 -> 14 -> 7 -> 4, PyTorch's
  symmetric padding 1): ``y = ELU(BN(conv3x3_s2(h)))``, ``y =
  BN(conv3x3(y))``, ``s = BN(conv1x1_s2(h))``, ``h = ELU(y + s)``;
- the head ``ELU(BN(conv(h)))`` with a kernel the size of the last map
  (4 x 4, no padding) to [B, ``head``], then a linear layer with bias to
  (mu, logvar).

Parameters take PyTorch's layouts: OIHW convolutions, the linear layer's
``fc`` [2 nz, head]. Under a profiler the forward is the span ``resnet``,
with its device time (utils/profiling.py).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv2d_nchw, to_nchw
from ..utils.profiling import span
from .encoder import GaussianEncoderBase
from .lstm_core import uniform_


def reset_batch_norms(module: nn.Module) -> None:
    """Every ``BatchNorm2d`` of ``module`` as PyTorch makes it: scale 1,
    shift 0, running mean 0, running variance 1, no batches tracked."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def default_uniform_(p: nn.Parameter, fan_in: int, generator: torch.Generator) -> None:
    """PyTorch's default init of a convolution or linear layer's weight and
    bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    uniform_(p, 1.0 / math.sqrt(fan_in), generator)


class _Stage(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv1 = nn.Parameter(torch.empty(c, cin, 3, 3))
        self.bn1 = nn.BatchNorm2d(c)
        self.conv2 = nn.Parameter(torch.empty(c, c, 3, 3))
        self.bn2 = nn.BatchNorm2d(c)
        self.skip = nn.Parameter(torch.empty(c, cin, 1, 1))
        self.bn_skip = nn.BatchNorm2d(c)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        y = F.elu(self.bn1(conv2d_nchw(h, self.conv1, stride=2, padding=1)))
        y = self.bn2(conv2d_nchw(y, self.conv2, padding=1))
        return F.elu(y + self.bn_skip(conv2d_nchw(h, self.skip, stride=2)))


class BNResNetEncoder(GaussianEncoderBase):
    def __init__(self, nz: int, channels: Tuple[int, ...] = (64, 64, 64),
                 img_size: Tuple[int, int, int] = (28, 28, 1), head: int = 512):
        super().__init__()
        self.nz, self.channels, self.img_size = nz, tuple(channels), tuple(img_size)
        self.stages = nn.ModuleList()
        cin, h = img_size[2], img_size[0]
        for c in channels:
            self.stages.append(_Stage(cin, c))
            cin, h = c, (h - 1) // 2 + 1
        self.head = nn.Parameter(torch.empty(head, cin, h, h))
        self.bn_head = nn.BatchNorm2d(head)
        self.fc = nn.Parameter(torch.empty(2 * nz, head))
        self.fc_b = nn.Parameter(torch.empty(2 * nz))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's defaults, which jxhe's modules keep: convolutions and the
        linear layer U(+-1/sqrt(fan_in)), its bias too; batch norms fresh."""
        for p in [p for s in self.stages for p in (s.conv1, s.conv2, s.skip)] + [self.head]:
            default_uniform_(p, p[0].numel(), generator)
        default_uniform_(self.fc, self.fc.shape[1], generator)
        default_uniform_(self.fc_b, self.fc.shape[1], generator)
        reset_batch_norms(self)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, H, W, C] (binarized) -> (mu, logvar) [B, nz]; ``mask`` unused."""
        with span("resnet", device=True):
            h = to_nchw(x)
            for stage in self.stages:
                h = stage(h)
            h = F.elu(self.bn_head(conv2d_nchw(h, self.head))).flatten(1)
            mu, logvar = (h @ self.fc.T + self.fc_b).chunk(2, dim=-1)
        return mu, logvar
