"""Conditional PixelCNN decoder p(x|z) over binarized images.

Counterpart of ``vae_lagging_encoder_tpu/models/dec_pixelcnn.py`` (the
reference's PixelCNNDecoderV2), training, evaluation and sampling:

- ``n_layers`` masked convs of ``filters`` channels (the first
  ``first_kernel`` x ``first_kernel`` with mask A, which blocks the current
  pixel; the rest ``kernel`` x ``kernel`` with mask B), the masks folded
  into the weights and the masked taps computed densely, as in the JAX
  package;
- z conditions every layer: ``z @ wz`` added with the bias in f32 before
  the ELU, the result cast back to ``compute_dtype`` for the next conv;
- a 1x1 output conv in f32 -> one Bernoulli logit per pixel;
- ``reconstruct_error``: the per-image summed BCE-with-logits, in one
  teacher-forced pass over all pixels. The z-sample axis runs in chunks of
  ``iw_chunk`` samples (z zero-padded to a whole number of chunks), which
  bounds the memory of an IW pass; under autograd each chunk is recomputed
  in the backward (``torch.utils.checkpoint``, as ``jax.checkpoint``).

Sampling is autoregressive in raster order. ``sample(fast=True)`` is the
cached incremental sampler (``_incremental_pixels``): per pixel, each
layer's activation at that pixel only, from a zero-initialised padded
canvas of earlier activations and the masked kernel flattened to one
window product; the masks zero every not-yet-written position, so its
logits equal the dense ``_logits`` (``force_image`` teacher-forces the
canvas to show it). ``fast=False`` runs the dense forward once per pixel,
the oracle. A pixel is 1 where ``u < sigmoid(logit)``, which is what the
JAX package's ``bernoulli`` computes from its uniforms; the uniforms of
pixel ``p`` (raster index) come from ``noise(p, (N, C))``, else from
``generator``. Rounding follows the dense path under bf16: each window
product is rounded to bf16 before the f32 epilogue, as the conv's output.

Parameters keep the JAX layouts (HWIO ``w``, ``wz`` [nz, C]). Rows are
z-major, row n = k * B + b. The loss and the samplers live in
``PixelDecoderBase``, which the published decoder (models/dec_pixelcnn_bn.py)
shares; the dense sampler runs in evaluation mode (models/modes.py).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.conv import causal_mask, masked_conv2d
from .decoder import DecoderBase
from .lstm_core import uniform_
from .modes import module_mode


StepNoise = Callable[[int, Tuple[int, ...]], torch.Tensor]


class _Layer(nn.Module):
    def __init__(self, k: int, cin: int, cout: int, nz: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(k, k, cin, cout))
        self.b = nn.Parameter(torch.empty(cout))
        self.wz = nn.Parameter(torch.empty(nz, cout))


class PixelDecoderBase(DecoderBase):
    """What both OmniGlot decoders share, given ``_logits(x [N, H, W, C],
    z_flat [N, nz]) -> [N, H, W, C]``: the teacher-forced loss in chunks of
    ``iw_chunk`` z-samples and the samplers. ``fast_sampler`` says whether
    ``sample`` defaults to the cached sampler ``_incremental_pixels``."""

    nz: int
    img_size: Tuple[int, int, int]
    iw_chunk: int
    fast_sampler = True

    def _logits(self, x: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits: x [B, H, W, C], z [B, K, nz] -> [B, K, H, W, C]."""
        B, K = x.shape[0], z.shape[1]
        xk = x[None].expand(K, *x.shape).reshape(K * B, *x.shape[1:])
        logits = self._logits(xk, z.transpose(0, 1).reshape(K * B, self.nz))
        return logits.reshape(K, B, *x.shape[1:]).transpose(0, 1)

    def _rec_chunk(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        logits = self.decode(x, z)
        nll = (torch.clamp(logits, min=0) - logits * x[:, None]
               + torch.log1p(torch.exp(-torch.abs(logits))))  # stable BCE-with-logits
        return torch.sum(nll, dim=(2, 3, 4))

    def reconstruct_error(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                          z: torch.Tensor, draw=None) -> torch.Tensor:
        """-log p(x|z) per (image, z-sample): [B, K]. ``mask`` and ``draw``
        are unused (the image decoder has no padding and no dropout)."""
        B, K = x.shape[0], z.shape[1]
        c = self.iw_chunk
        if K <= c:
            return self._rec_chunk(x, z)
        K_pad = -(-K // c) * c
        if K_pad != K:
            z = torch.cat([z, z.new_zeros((B, K_pad - K, self.nz))], dim=1)
        grad = torch.is_grad_enabled()
        out = [checkpoint(self._rec_chunk, x, z[:, s:s + c], use_reentrant=False) if grad
               else self._rec_chunk(x, z[:, s:s + c]) for s in range(0, K_pad, c)]
        return torch.cat(out, dim=1)[:, :K]

    # ------------------------------------------------------------ sampling
    @torch.no_grad()
    def sample(self, z_flat: torch.Tensor, noise: Optional[StepNoise] = None,
               fast: Optional[bool] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z [N, nz] -> binary images [N, H, W, C], pixel by pixel in raster
        order: the cached sampler (``fast``; default ``fast_sampler``) or the
        dense forward per pixel, in evaluation mode (models/modes.py)."""
        if fast is None:
            fast = self.fast_sampler
        if fast:
            return self._incremental_pixels(z_flat, noise, generator=generator)[0]
        noise = noise or uniform_noise(generator, z_flat.device)
        N = z_flat.shape[0]
        H, W, C = self.img_size
        canvas = z_flat.new_zeros((N, H, W, C))
        with module_mode(self, False):
            for p in range(H * W):
                i, j = divmod(p, W)
                logit = self._logits(canvas, z_flat)[:, i, j, :]
                canvas[:, i, j, :] = (noise(p, (N, C)) < torch.sigmoid(logit)).float()
        return canvas

    # the shared VAE.reconstruct interface (max_len is unused)
    def greedy_decode(self, z_flat: torch.Tensor, max_len: int = 0) -> torch.Tensor:
        """A sample with a fixed seed (0), as the JAX package's ``PRNGKey(0)``."""
        return self.sample(z_flat, generator=torch.Generator(z_flat.device).manual_seed(0))

    def sample_decode(self, z_flat: torch.Tensor, max_len: int = 0,
                      noise: Optional[StepNoise] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.sample(z_flat, noise, generator=generator)


class PixelCNNDecoderV2(PixelDecoderBase):
    def __init__(self, nz: int, img_size: Tuple[int, int, int] = (28, 28, 1),
                 n_layers: int = 8, filters: int = 64, first_kernel: int = 7,
                 kernel: int = 3, compute_dtype: torch.dtype = torch.float32,
                 iw_chunk: int = 25):
        super().__init__()
        self.nz, self.img_size, self.n_layers, self.filters = nz, tuple(img_size), n_layers, filters
        self.kernels = [first_kernel] + [kernel] * (n_layers - 1)
        self.compute_dtype = compute_dtype
        self.iw_chunk = iw_chunk
        C = img_size[2]
        self.layers = nn.ModuleList(
            _Layer(first_kernel if i == 0 else kernel, C if i == 0 else filters, filters, nz)
            for i in range(n_layers))
        self.out_w = nn.Parameter(torch.empty(1, 1, filters, C))
        self.out_b = nn.Parameter(torch.empty(C))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's recipe: w, wz and out_w U(-0.05, 0.05), biases 0."""
        with torch.no_grad():
            for layer in self.layers:
                uniform_(layer.w, 0.05, generator)
                layer.b.zero_()
                uniform_(layer.wz, 0.05, generator)
            uniform_(self.out_w, 0.05, generator)
            self.out_b.zero_()

    def _logits(self, x: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, C] binary canvas, z_flat [N, nz] -> Bernoulli logits [N, H, W, C]."""
        cd = self.compute_dtype
        h = x.to(cd)
        for i, layer in enumerate(self.layers):
            shift = (z_flat @ layer.wz + layer.b)[:, None, None, :]  # f32 [N, 1, 1, C]
            h = masked_conv2d(h, layer.w.to(cd), include_center=i > 0)
            h = F.elu(h.float() + shift).to(cd)
        return masked_conv2d(h.float(), self.out_w, include_center=True) + self.out_b

    # ------------------------------------------------------------ sampling
    @torch.no_grad()
    def _incremental_pixels(self, z_flat: torch.Tensor, noise: Optional[StepNoise] = None,
                            force_image: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cached raster generation: returns ``(canvas [N, H, W, C], logits
        [N, H, W, C])``; the written pixels are ``force_image``'s when given,
        else Bernoulli samples."""
        N = z_flat.shape[0]
        H, W, C = self.img_size
        cd = self.compute_dtype
        ks = self.kernels
        if noise is None and force_image is None:
            noise = uniform_noise(generator, z_flat.device)
        mats, conds, biases = [], [], []
        for i, (layer, k) in enumerate(zip(self.layers, ks)):
            w = layer.w * causal_mask(*layer.w.shape, include_center=i > 0,
                                      dtype=layer.w.dtype, device=layer.w.device)
            mats.append(w.reshape(k * k * w.shape[2], w.shape[3]).to(cd).float())
            conds.append(z_flat @ layer.wz)
            biases.append(layer.b)
        out_w = self.out_w[0, 0]  # the 1x1 conv (mask B keeps the center)
        # canvases[l] = input of layer l, padded by its margin k // 2;
        # canvases[L] = the last hidden layer (read by the unpadded 1x1 conv)
        widths = [C] + [self.filters] * self.n_layers
        pads = [k // 2 for k in ks] + [0]
        canvases = [z_flat.new_zeros((N, H + 2 * p, W + 2 * p, c)) for p, c in zip(pads, widths)]
        logits = z_flat.new_zeros((N, H, W, C))
        for p in range(H * W):
            i, j = divmod(p, W)
            for l, k in enumerate(ks):
                win = canvases[l][:, i:i + k, j:j + k, :].reshape(N, -1)
                # the dense conv's output is in compute_dtype: round the same way
                acc = (win.to(cd).float() @ mats[l]).to(cd).float()
                h = F.elu(acc + biases[l] + conds[l])
                m = pads[l + 1]
                canvases[l + 1][:, i + m, j + m, :] = h
            logit = h.to(cd).float() @ out_w + self.out_b
            logits[:, i, j, :] = logit
            if force_image is not None:
                pix = force_image[:, i, j, :]
            else:
                pix = (noise(p, (N, C)) < torch.sigmoid(logit)).float()
            canvases[0][:, i + pads[0], j + pads[0], :] = pix
        m0 = pads[0]
        return canvases[0][:, m0:m0 + H, m0:m0 + W, :], logits


def uniform_noise(generator: Optional[torch.Generator], device) -> StepNoise:
    """Uniform [0, 1) draws from ``generator``, one call per pixel."""
    return lambda p, shape: torch.rand(shape, generator=generator, device=device)
