"""Precision of the reference's products.

A configuration states the precision of each product (``precision`` in
its file under ``port_bench/configs/``): ``float32`` products run in f32
with TF32 off; ``bfloat16`` products round both operands to bf16 and
accumulate in f32 (exact products of representable values). ``Products``
carries that choice, and the control's: every product one step below what
the configuration states, which for an f32 product with TF32 off is TF32
(its operands rounded to a 10-bit significand, f32 accumulation) and for
a bf16 product fp8 e4m3 with a scale per tensor (its largest magnitude
mapped to 448, the way an fp8 product is fed), f32 accumulation.
"""
from __future__ import annotations

import contextlib

import torch

BF16 = torch.bfloat16


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32: 10 significand bits, to nearest (ties
    away from zero), as the tensor cores take an f32 operand in TF32 mode."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and back to f32."""
    return x.to(BF16).float()


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 under one scale for the whole tensor
    (its largest magnitude to 448), back to f32."""
    scale = 448.0 / torch.clamp(x.abs().amax(), min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the matmuls and convolutions inside (the library's
    default for cuDNN is on)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


class _MM(torch.autograd.Function):
    """``a @ b`` with both operands, and the gradients' operands, passed
    through ``rnd`` (identity for f32, ``to_tf32`` for the control)."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ctx.rnd
        ga = r(g) @ r(b).T if ctx.needs_input_grad[0] else None
        gb = r(a).T @ r(g) if ctx.needs_input_grad[1] else None
        return ga, gb, None


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


class Products:
    """The products of a configuration: ``mm`` (an f32 product, with its
    gradient), ``rnd`` (the operand rounding of an f32 product or
    convolution), ``low`` (of a bf16 product, and of a value the
    configuration stores in bf16), ``rec`` (of the LSTM's recurrent
    product, ``recurrent`` being ``"bfloat16"`` or ``"float32"``).
    ``control=True`` is the control, one step below each."""

    def __init__(self, control: bool = False, recurrent: str = "bfloat16"):
        self.control = control
        self.rnd = to_tf32 if control else _same
        self.low = to_fp8 if control else to_bf16
        self.rec = self.low if recurrent == "bfloat16" else self.rnd

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _MM.apply(a, b, self.rnd)
