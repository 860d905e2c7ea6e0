"""The published OmniGlot decoder: a PixelCNN of bottleneck blocks with
batch norm and direct connections.

jxhe/vae-lagging-encoder's ``modules/decoders/dec_pixelcnn_v2.py`` in
mode ``large`` as ``config/config_omniglot.py`` builds it
(arXiv:1901.05534, Table 3), selected by ``image_arch="published"``
(``build_image_vae``). The JAX package's stack of masked convolutions is
models/dec_pixelcnn.py. In PyTorch's NCHW layout, f32, convolutions
without bias, ``BatchNorm2d`` with PyTorch's defaults (batch statistics
in training, running statistics in evaluation: models/modes.py):

- ``zf = z W_z^T + b_z`` viewed as ``latent_maps`` maps of the image's
  size; the input is ``h0 = cat(x, zf)`` (1 + ``latent_maps`` channels);
- block A: ``ELU(BN(conv_A(h0)))``, a ``kernels[0]`` kernel to ``hidden``
  maps whose raster mask A (the center blocked) covers the image channel
  alone; the latent maps enter whole;
- the bottleneck block ``P_k(h) = ELU(BN(up(ELU(BN(conv_k(ELU(BN(down(h)))))))) + h)``:
  ``down`` 1x1 to ``bottleneck`` maps, ``conv_k`` a k x k convolution under
  mask B (the center kept), ``up`` 1x1 back to ``hidden``;
- the main chain ``b0 = A(h0)``, ``b1 = P(b0)``, ``b2 = P(b1)``, ``b_i =
  P(b_{i-1} + D_{i-3}(b_{i-3}))`` for i = 3 .. L-1 (``main[i - 1]`` with
  kernel ``kernels[i]``), then ``out = b_{L-1} + D_{L-3}(b_{L-3})``:
  ``D_j`` (``direct[j]``, kernel ``kernels[j + 1]``) are L - 2 bottleneck
  blocks of their own, one for each i in jxhe's ``range(1, num_blocks -
  1)``, each applied once;
- the head ``conv1x1(ELU(BN(conv1x1(out))))`` to one Bernoulli logit per
  pixel (jxhe's sigmoid and ``binary_cross_entropy`` become the stable
  BCE-with-logits of ``PixelDecoderBase``: the same function).

Masked taps are zero through the mask multiplied into the weight, so their
gradient is zero (jxhe zeroes the weight's data before each forward). The
masks are buffers outside the state dict. Under a profiler the forward is
the span ``pixelcnn``, with its device time (utils/profiling.py).

Training takes at most ``iw_chunk`` z-samples: above it the chunks are
recomputed in the backward, which would update the running statistics
twice. Sampling is the dense sampler (``sample(fast=False)``, the
default here); the cached incremental sampler is not implemented.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv2d_nchw, raster_mask, to_nchw
from ..utils.profiling import span
from .dec_pixelcnn import PixelDecoderBase
from .enc_resnet_bn import default_uniform_, reset_batch_norms

PUBLISHED_KERNELS = (7, 7, 7, 7, 7, 5, 5, 5, 5, 3, 3, 3, 3)


class _Bottleneck(nn.Module):
    """``P_k``: 1x1 down, a k x k convolution under mask B, 1x1 up, each
    with batch norm, the residual add and ELU."""

    def __init__(self, c: int, cb: int, k: int):
        super().__init__()
        self.k = k
        self.down = nn.Parameter(torch.empty(cb, c, 1, 1))
        self.bn_down = nn.BatchNorm2d(cb)
        self.conv = nn.Parameter(torch.empty(cb, cb, k, k))
        self.bn_conv = nn.BatchNorm2d(cb)
        self.up = nn.Parameter(torch.empty(c, cb, 1, 1))
        self.bn_up = nn.BatchNorm2d(c)
        self.register_buffer("mask", raster_mask(cb, cb, k, include_center=True),
                             persistent=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        u = F.elu(self.bn_down(conv2d_nchw(h, self.down)))
        u = F.elu(self.bn_conv(conv2d_nchw(u, self.conv * self.mask, padding=self.k // 2)))
        return F.elu(self.bn_up(conv2d_nchw(u, self.up)) + h)


class BottleneckPixelCNNDecoder(PixelDecoderBase):
    fast_sampler = False

    def __init__(self, nz: int, img_size: Tuple[int, int, int] = (28, 28, 1),
                 kernels: Sequence[int] = PUBLISHED_KERNELS, hidden: int = 64,
                 bottleneck: int = 32, latent_maps: int = 4, iw_chunk: int = 25):
        super().__init__()
        if len(kernels) < 4:
            raise ValueError(f"kernels {tuple(kernels)}: the direct connections need 4 or more")
        H, W, C = img_size
        self.nz, self.img_size, self.kernels = nz, tuple(img_size), tuple(kernels)
        self.latent_maps, self.iw_chunk = latent_maps, iw_chunk
        self.z_w = nn.Parameter(torch.empty(latent_maps * H * W, nz))
        self.z_b = nn.Parameter(torch.empty(latent_maps * H * W))
        k0 = kernels[0]
        self.conv_a = nn.Parameter(torch.empty(hidden, C + latent_maps, k0, k0))
        self.bn_a = nn.BatchNorm2d(hidden)
        self.register_buffer("mask_a", raster_mask(hidden, C + latent_maps, k0,
                                                   include_center=False, masked_in=C),
                             persistent=False)
        self.main = nn.ModuleList(_Bottleneck(hidden, bottleneck, k) for k in kernels[1:])
        self.direct = nn.ModuleList(_Bottleneck(hidden, bottleneck, kernels[i])
                                    for i in range(1, len(kernels) - 1))
        self.out_hidden = nn.Parameter(torch.empty(hidden, hidden, 1, 1))
        self.bn_out = nn.BatchNorm2d(hidden)
        self.out = nn.Parameter(torch.empty(C, hidden, 1, 1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's defaults, which jxhe's modules keep: convolutions and the
        linear layer U(+-1/sqrt(fan_in)), its bias too; batch norms fresh."""
        blocks = list(self.main) + list(self.direct)
        convs = [self.conv_a, self.out_hidden, self.out] + [
            p for b in blocks for p in (b.down, b.conv, b.up)]
        for p in convs:
            default_uniform_(p, p[0].numel(), generator)
        default_uniform_(self.z_w, self.nz, generator)
        default_uniform_(self.z_b, self.nz, generator)
        reset_batch_norms(self)

    def _logits(self, x: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, C] binary canvas, z_flat [N, nz] -> Bernoulli logits [N, H, W, C]."""
        with span("pixelcnn", device=True):
            N = x.shape[0]
            H, W, _ = self.img_size
            zf = (z_flat @ self.z_w.T + self.z_b).view(N, self.latent_maps, H, W)
            h0 = torch.cat([to_nchw(x), zf], dim=1)
            b = [F.elu(self.bn_a(conv2d_nchw(h0, self.conv_a * self.mask_a,
                                             padding=self.kernels[0] // 2)))]
            for i, block in enumerate(self.main, start=1):
                b.append(block(b[-1] if i < 3 else b[-1] + self.direct[i - 3](b[i - 3])))
            out = b[-1] + self.direct[-1](b[-3])
            y = conv2d_nchw(F.elu(self.bn_out(conv2d_nchw(out, self.out_hidden))), self.out)
        return y.permute(0, 2, 3, 1)

    def reconstruct_error(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                          z: torch.Tensor, draw=None) -> torch.Tensor:
        if self.training and z.shape[1] > self.iw_chunk:
            raise ValueError(
                f"{z.shape[1]} z-samples in training: the published decoder trains on at "
                f"most iw_chunk ({self.iw_chunk}), since a chunk recomputed in the backward "
                "would update the batch norms' running statistics twice")
        return super().reconstruct_error(x, mask, z, draw)

    def _incremental_pixels(self, *args, **kwargs):
        raise ValueError("the cached incremental sampler is not implemented for the published "
                         "decoder (batch norm, bottleneck blocks, direct connections); "
                         "sample with fast=False")
