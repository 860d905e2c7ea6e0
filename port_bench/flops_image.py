"""The image model's FLOPs, in ``flops.py``'s convention: a matrix
product's or a convolution's multiply-adds counted twice, a training step
as three forwards, over the batch's real images (row weight 1). A masked
convolution counts all of its taps (the dense product the library runs);
batch norm, ELU and the adds count nothing.

The published OmniGlot model (``port_bench/reference/image_vae.py``): at
28 x 28, nz 32, ~0.026 GFLOP an image in the encoder and ~1.231 GFLOP in
the decoder, so ~188 GFLOP a training step of 50 images.
"""
from __future__ import annotations

from typing import Dict


def conv_flops(cin: int, cout: int, k: int, hw: int) -> float:
    """A k x k convolution from ``cin`` to ``cout`` maps over ``hw`` output
    positions."""
    return 2.0 * cin * cout * k * k * hw


def bottleneck_flops(c: int, cb: int, k: int, hw: int) -> float:
    return conv_flops(c, cb, 1, hw) + conv_flops(cb, cb, k, hw) + conv_flops(cb, c, 1, hw)


def image_forward_flops(cfg: dict) -> Dict[str, float]:
    """One image's forward FLOPs through the encoder and the decoder."""
    H, W, C = cfg["img_size"]
    nz = cfg["nz"]
    enc, cin, h = 0.0, C, H
    for c in cfg["enc_layers"]:
        ho = (h - 1) // 2 + 1
        enc += conv_flops(cin, c, 3, ho * ho) + conv_flops(c, c, 3, ho * ho)
        enc += conv_flops(cin, c, 1, ho * ho)
        cin, h = c, ho
    enc += conv_flops(cin, cfg["enc_head"], h, 1) + 2.0 * cfg["enc_head"] * 2 * nz
    ks, hid, cb, maps = cfg["dec_kernels"], cfg["dec_hidden"], cfg["dec_bottleneck"], \
        cfg["latent_maps"]
    hw = H * W
    dec = 2.0 * nz * maps * hw + conv_flops(C + maps, hid, ks[0], hw)
    dec += sum(bottleneck_flops(hid, cb, k, hw) for k in ks[1:])            # the main chain
    dec += sum(bottleneck_flops(hid, cb, ks[i], hw) for i in range(1, len(ks) - 1))  # direct
    dec += conv_flops(hid, hid, 1, hw) + conv_flops(hid, C, 1, hw)
    return {"enc": enc, "dec": dec}


def image_train_flops(cfg: dict, images: int, nsamples: int = 1) -> float:
    """One training step over ``images`` real images: 3 x forward, the
    decoder once per z-sample."""
    f = image_forward_flops(cfg)
    return 3.0 * images * (f["enc"] + nsamples * f["dec"])


def image_iwnll_flops(cfg: dict, images: int, nsamples: int, chunk: int) -> float:
    """The IW estimator over ``images``: the encoder once per chunk of
    ``chunk`` samples, the decoder once per sample."""
    f = image_forward_flops(cfg)
    return images * (-(-nsamples // chunk) * f["enc"] + nsamples * f["dec"])
