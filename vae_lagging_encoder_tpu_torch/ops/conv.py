"""Convolutions of the image models, in the JAX package's layouts.

Counterpart of ``vae_lagging_encoder_tpu/ops/conv.py``: ``conv2d`` over
NHWC activations and HWIO weights with XLA's ``SAME`` padding,
``causal_mask`` (the PixelCNN raster masks A and B) and ``masked_conv2d``.
No Pallas kernel lies behind these in the JAX package; here they are
cuDNN convolutions through ``torch.ops.aten``.

- XLA ``SAME`` pads ``total = max((ceil(n / s) - 1) * s + k - n, 0)`` with
  ``total // 2`` before and the rest after: asymmetric at stride 2 (28 -> 14
  pads (0, 1), 7 -> 4 pads (1, 1)), which ``F.pad`` applies first; a
  symmetric pad goes to the convolution itself.
- Layout: the NHWC tensor is handed to the convolution as an NCHW view
  (channels-last strides) and the result comes back the same way, so the
  activations stay NHWC in memory and PyTorch copies no transpose (cuDNN's
  f32 kernels are NCHW and transpose inside the call: PERF.md §5).
- Precision: in float32 the convolutions, forward and backward, run
  without TF32 (``torch.backends.cudnn.allow_tf32`` is True by default),
  as the port's other f32 products do; bfloat16 operands run as bfloat16.
- Determinism: the backward (input and weight gradients) takes cuDNN's
  deterministic algorithms (``torch.backends.cudnn.deterministic``); the
  forward keeps cuDNN's default choice. With the default choice in the
  backward, two runs of one training step from the same state differ in
  the last bits (cuDNN documents some of its backward algorithms as not
  deterministic), which an exact resume, and a CUDA-graph replay held
  against the eager step, cannot allow. ``chip_smoke.py`` (phase 9) finds
  which products differ from run to run under the default choice, and
  what the restriction costs a training step.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Tuple

import torch
import torch.nn.functional as F


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA ``SAME`` padding (before, after) of one spatial axis."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


@contextmanager
def _cudnn_flags(deterministic: bool = False):
    """TF32 off; with ``deterministic``, cuDNN's deterministic algorithms
    (a caller's global ``deterministic`` is kept either way)."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = False
    cudnn.deterministic = prev[1] or deterministic
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev


class _Conv2dFn(torch.autograd.Function):
    """``F.conv2d`` (NCHW x, OIHW w, symmetric padding) whose forward and
    backward both run under ``_cudnn_flags`` (the backward with
    deterministic algorithms): the backward runs after the forward has
    returned, so flags set around the forward alone would not cover it."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: Tuple[int, int]):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        with _cudnn_flags():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conf
        with _cudnn_flags(deterministic=True):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [stride, stride], list(padding), [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [N, H, W, Cin], w [kh, kw, Cin, Cout] -> [N, H', W', Cout], ``SAME``."""
    top, bottom = same_pads(x.shape[1], w.shape[0], stride)
    left, right = same_pads(x.shape[2], w.shape[1], stride)
    xc = x.permute(0, 3, 1, 2)
    if top != bottom or left != right:
        xc, pad = F.pad(xc, (left, right, top, bottom)), (0, 0)
    else:
        pad = (top, left)
    y = _Conv2dFn.apply(xc, w.permute(3, 2, 0, 1), stride, pad)
    return y.permute(0, 2, 3, 1)


def causal_mask(kh: int, kw: int, cin: int, cout: int, include_center: bool,
                dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """PixelCNN raster-order mask for a HWIO kernel: the rows above the
    center and the pixels left of it; mask A (``include_center=False``, the
    first layer) blocks the current pixel, mask B (later layers) keeps it.
    Single-channel images, so no channel ordering within a pixel."""
    m = torch.zeros((kh, kw, 1, 1), dtype=dtype, device=device)
    ch, cw = kh // 2, kw // 2
    m[:ch] = 1.0
    m[ch, :cw] = 1.0
    if include_center:
        m[ch, cw] = 1.0
    return m.expand(kh, kw, cin, cout)


def masked_conv2d(x: torch.Tensor, w: torch.Tensor, include_center: bool) -> torch.Tensor:
    """``conv2d`` with the raster mask folded into the weights."""
    mask = causal_mask(*w.shape, include_center, dtype=w.dtype, device=w.device)
    return conv2d(x, w * mask)
