"""The published OmniGlot VAE (a ResNet encoder and a bottleneck PixelCNN
decoder, both with batch norm): the ``omniglot`` configuration.

Data: ``<split>_images`` grey 28 x 28 images of pen strokes made from the
seed (the corpus is not in the repository): each image two to five
strokes, a stroke a Gaussian ridge along a segment (center U(6, 22)^2,
angle U(0, pi), half-length U(3, 9), width U(0.6, 1.6)), the sum clipped to
[0, 1] as a pixel's probability of being on. Batches of ``batch_size`` in
order, the remainder a last batch of its own size (no padded rows: a
batch norm's statistics would count them), as the reference's loader
leaves it.

Weights: U(-scale, scale) of the ``init`` entry of the leaf's last name
part, plus ``init_offset``'s (the batch norms' scales, 1 + U(-0.1, 0.1));
running statistics as PyTorch makes them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .. import flops_image, inputs
from ..reference import image_vae as ref_image
from . import load_weights, uniform_weights

STROKES = 5
RENDER_CHUNK = 2048  # images rasterized at once


def stroke_images(n: int, size: int, seed: int, stream: int) -> torch.Tensor:
    """``n`` stroke images [n, size, size, 1] f32 in [0, 1] (module doc)."""
    r = inputs.rng(seed, stream, 31)
    lo = 6.0 * size / 28.0
    shape = (n, STROKES)
    cy, cx = (torch.from_numpy(r.uniform(lo, size - lo, shape)).float() for _ in range(2))
    ang = torch.from_numpy(r.uniform(0.0, torch.pi, shape)).float()
    half = torch.from_numpy(r.uniform(3.0, 9.0, shape)).float() * size / 28.0
    wid = torch.from_numpy(r.uniform(0.6, 1.6, shape)).float()
    on = torch.arange(STROKES)[None, :] < torch.from_numpy(r.integers(2, STROKES + 1, (n, 1)))
    ys, xs = torch.meshgrid(torch.arange(size, dtype=torch.float32),
                            torch.arange(size, dtype=torch.float32), indexing="ij")
    out = torch.empty((n, size, size, 1))
    for s in range(0, n, RENDER_CHUNK):
        sl = slice(s, min(n, s + RENDER_CHUNK))
        dy = ys[None, None] - cy[sl, :, None, None]
        dx = xs[None, None] - cx[sl, :, None, None]
        sin, cos = torch.sin(ang[sl])[..., None, None], torch.cos(ang[sl])[..., None, None]
        u = (dy * sin + dx * cos) / half[sl, :, None, None]
        v = (dx * sin - dy * cos) / wid[sl, :, None, None]
        ink = torch.exp(-u * u - v * v) * on[sl, :, None, None]
        out[sl, :, :, 0] = ink.sum(dim=1).clamp_(0.0, 1.0)
    return out


class Model:
    def __init__(self, config: dict, tr: dict):
        self.c, self.tr = config, tr
        self.B = config["batch_size"]
        self.K = tr.get("nsamples", config["nsamples"])

    # --------------------------------------------------------------- shapes
    def shapes(self) -> Dict[str, tuple]:
        """The port's parameters (``BNResNetEncoder``, ``BottleneckPixelCNNDecoder``)."""
        c = self.c
        H, W, C = c["img_size"]
        nz, hid, cb, maps, ks = (c["nz"], c["dec_hidden"], c["dec_bottleneck"],
                                 c["latent_maps"], c["dec_kernels"])
        out: Dict[str, tuple] = {}

        def bn(name, n):
            out[name + ".weight"] = out[name + ".bias"] = (n,)

        cin, h = C, H
        for i, ch in enumerate(c["enc_layers"]):
            p = f"enc.stages.{i}."
            out[p + "conv1"], out[p + "conv2"], out[p + "skip"] = \
                (ch, cin, 3, 3), (ch, ch, 3, 3), (ch, cin, 1, 1)
            for b in ("bn1", "bn2", "bn_skip"):
                bn(p + b, ch)
            cin, h = ch, (h - 1) // 2 + 1
        out["enc.head"] = (c["enc_head"], cin, h, h)
        bn("enc.bn_head", c["enc_head"])
        out["enc.fc"], out["enc.fc_b"] = (2 * nz, c["enc_head"]), (2 * nz,)
        out["dec.z_w"], out["dec.z_b"] = (maps * H * W, nz), (maps * H * W,)
        out["dec.conv_a"] = (hid, C + maps, ks[0], ks[0])
        bn("dec.bn_a", hid)
        blocks = [(f"dec.main.{i}.", k) for i, k in enumerate(ks[1:])]
        blocks += [(f"dec.direct.{i - 1}.", ks[i]) for i in range(1, len(ks) - 1)]
        for p, k in blocks:
            out[p + "down"], out[p + "conv"], out[p + "up"] = \
                (cb, hid, 1, 1), (cb, cb, k, k), (hid, cb, 1, 1)
            bn(p + "bn_down", cb)
            bn(p + "bn_conv", cb)
            bn(p + "bn_up", hid)
        out["dec.out_hidden"] = (hid, hid, 1, 1)
        bn("dec.bn_out", hid)
        out["dec.out"] = (C, hid, 1, 1)
        return out

    def weights(self, seed: int, dev, init: Dict[str, float]) -> Dict[str, torch.Tensor]:
        w = uniform_weights(self.shapes(), seed, dev, init)
        for k in w:
            w[k] += self.c.get("init_offset", {}).get(k.rsplit(".", 1)[-1], 0.0)
        return w

    # ----------------------------------------------------------------- data
    def batches(self, split: str, seed: int, stream: int):
        """``[(rows, [(probs [rows, H, W, 1], row_weight [rows])])]``: the
        full batches, then the remainder's batch (module doc)."""
        n, B = self.c[f"{split}_images"], self.B
        imgs = stroke_images(n, self.c["img_size"][0], seed, stream)
        full = n // B * B
        groups = [(B, [(imgs[s:s + B], torch.ones(B)) for s in range(0, full, B)])]
        if full < n:
            groups.append((n - full, [(imgs[full:], torch.ones(n - full))]))
        return [g for g in groups if g[1]]

    def port_pool(self, groups, dev):
        from vae_lagging_encoder_tpu_torch.data import ImagePool

        imgs = torch.cat([p for _, bs in groups for p, _ in bs]).numpy()
        return ImagePool(imgs, self.B, dev, pad=False)

    def build(self, cfg, weights, dev):
        from vae_lagging_encoder_tpu_torch.models import build_image_vae

        c = self.c
        cfg = cfg.replace(image_arch="published", enc_head=c["enc_head"],
                          dec_kernels=tuple(c["dec_kernels"]), dec_hidden=c["dec_hidden"],
                          dec_bottleneck=c["dec_bottleneck"], latent_maps=c["latent_maps"])
        vae = build_image_vae(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        return load_weights(vae, self.shapes(), weights)

    def loss_fn(self, vae, cfg):
        from vae_lagging_encoder_tpu_torch.train.epoch import make_image_loss_fn

        return make_image_loss_fn(vae, nsamples=cfg.nsamples, train=True)

    # ------------------------------------------------------------ reference
    def ref_batch(self, batch, dev):
        return tuple(t.to(dev) for t in batch)

    def ref_loss(self, w, batch, noise, kl_weight, prods):
        return ref_image.train_loss(w, self.c, batch, noise, kl_weight, prods)

    # ---------------------------------------------------------------- counts
    @staticmethod
    def shape_of(batch) -> int:
        return batch[0].shape[0]

    def step_flops(self, batch) -> float:
        return flops_image.image_train_flops(self.c, int(batch[1].sum()), self.K)

    def step_launches(self, batch, iw_chunk: int) -> List[Tuple[str, float]]:
        """None of the port's own kernels: the convolutions and batch norms
        are the library's (cuDNN), the rest PyTorch's."""
        return []
