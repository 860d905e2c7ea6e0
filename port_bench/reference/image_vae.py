"""Plain-PyTorch reference of the published OmniGlot VAE (the ``omniglot``
configuration).

The image model of He et al. 2019 ("Lagging Inference Networks and
Posterior Collapse in VAEs", arXiv:1901.05534, Table 3;
jxhe/vae-lagging-encoder, ``config/config_omniglot.py``, ``image.py``,
``modules/encoders/enc_resnet_v2.py``,
``modules/decoders/dec_pixelcnn_v2.py`` in mode ``large``). NCHW, f32,
convolutions without bias, batch norm ``F.batch_norm`` with eps 1e-5 and
momentum 0.1 (batch statistics in training, running statistics in
evaluation), ELU with alpha 1:

- encoder, x [B, 1, 28, 28] binarized: per stage of width c, stride 2
  (28 -> 14 -> 7 -> 4, symmetric padding 1), ``y = ELU(BN(conv3x3_s2(h)))``,
  ``y = BN(conv3x3(y))``, ``s = BN(conv1x1_s2(h))``, ``h = ELU(y + s)``;
  the head ``ELU(BN(conv4x4(h)))`` (no padding) to [B, 512]; then
  ``Linear(512, 2 nz)`` with bias gives (mu, logvar);
- decoder: ``zf = Linear(nz, 4 * 28 * 28)(z)`` (with bias) viewed as 4
  maps; ``h0 = cat(x, zf)`` (5 channels); block A ``ELU(BN(conv7x7(h0)))``
  to 64 maps under mask A (the center blocked) on the image channel, the
  4 latent maps whole; the bottleneck block ``P_k(h) = ELU(BN(up(ELU(BN(
  conv_k(ELU(BN(down(h)))))))) + h)`` (1x1 64 -> 32, k x k 32 -> 32 under
  mask B, the center kept, 1x1 32 -> 64); kernels ``k = [7, 7, 7, 7, 7, 5,
  5, 5, 5, 3, 3, 3, 3]``, ``k[0]`` block A's; ``b0 = A(h0)``, ``b1 =
  P_k1(b0)``, ``b2 = P_k2(b1)``, ``b_i = P_ki(b_{i-1} + D_{i-3}(b_{i-3}))``
  for i = 3 .. 12, ``out = b12 + D_10(b10)``, ``D_j`` eleven blocks of
  their own with kernel ``k[j + 1]`` (jxhe's ``direct_connects``, one for
  each i in ``range(1, num_blocks - 1)``); the head ``conv1x1(ELU(BN(conv1x1(out))))``
  (64 -> 64 -> 1) gives one logit per pixel;
- the loss per image: the summed BCE of x under the logits plus
  ``kl_weight`` times the analytic KL of (mu, logvar) to N(0, I), one z a
  training step (eps given), the images binarized afresh (``u < probs``,
  u given); the mean over the batch's rows of weight 1.

Departures from jxhe's code, each the same function or a reading of it:

- logits and the stable BCE-with-logits (``max(l, 0) - l x + log(1 +
  exp(-|l|))``) in place of a sigmoid and ``binary_cross_entropy``;
- the masks multiplied into the weights at each use, so a masked tap's
  gradient is zero (jxhe zeroes the weight's data in place before each
  forward: its masked taps get a gradient, which enters the clip's norm
  and Adam's moments, but never an output);
- assumed readings (the configuration's ``assumed``): the direct
  connections' wiring above (jxhe's ``range(1, num_blocks - 1)``); a bias
  on the ``z`` transform; mask A on the image channel alone; the
  configuration's 13 entries of 32 maps read as the bottleneck width.

Weights are a dict ``name -> tensor`` under the port's names (PyTorch's
layouts: OIHW convolutions, linear ``[out, in]``):
``enc.stages.<i>.{conv1,conv2,skip}``, their batch norms
``enc.stages.<i>.{bn1,bn2,bn_skip}.{weight,bias}``, ``enc.head``,
``enc.bn_head.*``, ``enc.fc``, ``enc.fc_b``; ``dec.z_w``, ``dec.z_b``,
``dec.conv_a``, ``dec.bn_a.*``, ``dec.{main,direct}.<j>.{down,conv,up}``
with ``bn_down``, ``bn_conv``, ``bn_up``, ``dec.out_hidden``,
``dec.bn_out.*``, ``dec.out``. Running statistics travel in ``stats``,
``name -> tensor`` under the same prefixes (``.running_mean``,
``.running_var``), updated in place in training; without ``stats`` the
training forward keeps none. The products and convolutions take their
operands through ``prods.rnd`` (f32, or TF32 for the control), forward
and backward.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .numerics import Products

Weights = Dict[str, torch.Tensor]
BN_EPS, BN_MOMENTUM = 1e-5, 0.1


class _Conv(torch.autograd.Function):
    """``F.conv2d`` with both operands, and the gradients' operands, passed
    through ``rnd``."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, rnd):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, rnd)
        return F.conv2d(rnd(x), rnd(w), stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, r = ctx.conf
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, r(w), r(g), stride, padding)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(r(x), w.shape, r(g), stride, padding)
        return gx, gw, None, None, None


def raster_mask(cout: int, cin: int, k: int, center: bool, masked_in: int, device):
    """The raster mask of an OIHW kernel on input channels ``< masked_in``:
    the rows above the center and the taps left of it (and the center with
    ``center``); the other input channels whole."""
    m = torch.ones((cout, cin, k, k), device=device)
    m[:, :masked_in, k // 2, k // 2 + int(center):] = 0.0
    m[:, :masked_in, k // 2 + 1:] = 0.0
    return m


class Net:
    """One forward of the model in training (``train``: batch statistics,
    ``stats`` updated) or evaluation mode (``stats``' running statistics)."""

    def __init__(self, w: Weights, cfg: dict, prods: Products, train: bool,
                 stats: Optional[Weights] = None):
        self.w, self.cfg, self.prods, self.train, self.stats = w, cfg, prods, train, stats

    def conv(self, x, name: str, stride: int = 1, padding: int = 0, mask=None):
        w = self.w[name] if mask is None else self.w[name] * mask
        return _Conv.apply(x, w, stride, padding, self.prods.rnd)

    def bn(self, x, name: str):
        s = self.stats or {}
        return F.batch_norm(x, s.get(name + ".running_mean"), s.get(name + ".running_var"),
                            self.w[name + ".weight"], self.w[name + ".bias"],
                            training=self.train, momentum=BN_MOMENTUM, eps=BN_EPS)

    def encode(self, x):
        """x [B, 1, H, W] -> (mu, logvar) [B, nz]."""
        h = x
        for i in range(len(self.cfg["enc_layers"])):
            p = f"enc.stages.{i}."
            y = F.elu(self.bn(self.conv(h, p + "conv1", 2, 1), p + "bn1"))
            y = self.bn(self.conv(y, p + "conv2", 1, 1), p + "bn2")
            h = F.elu(y + self.bn(self.conv(h, p + "skip", 2), p + "bn_skip"))
        h = F.elu(self.bn(self.conv(h, "enc.head"), "enc.bn_head")).flatten(1)
        out = self.prods.mm(h, self.w["enc.fc"].T) + self.w["enc.fc_b"]
        return out.chunk(2, dim=-1)

    def bottleneck(self, h, p: str, k: int):
        cb = self.w[p + "conv"].shape[0]
        mask = raster_mask(cb, cb, k, True, cb, h.device)
        u = F.elu(self.bn(self.conv(h, p + "down"), p + "bn_down"))
        u = F.elu(self.bn(self.conv(u, p + "conv", 1, k // 2, mask), p + "bn_conv"))
        return F.elu(self.bn(self.conv(u, p + "up"), p + "bn_up") + h)

    def logits(self, x, z):
        """x [N, 1, H, W], z [N, nz] -> logits [N, 1, H, W]."""
        ks, maps = self.cfg["dec_kernels"], self.cfg["latent_maps"]
        N, C, H, W = x.shape
        zf = (self.prods.mm(z, self.w["dec.z_w"].T) + self.w["dec.z_b"]).view(N, maps, H, W)
        h0 = torch.cat([x, zf], dim=1)
        wa = self.w["dec.conv_a"]
        mask = raster_mask(wa.shape[0], wa.shape[1], ks[0], False, C, x.device)
        b = [F.elu(self.bn(self.conv(h0, "dec.conv_a", 1, ks[0] // 2, mask), "dec.bn_a"))]
        for i in range(1, len(ks)):
            inp = b[-1] if i < 3 else b[-1] + self.bottleneck(
                b[i - 3], f"dec.direct.{i - 3}.", ks[i - 2])
            b.append(self.bottleneck(inp, f"dec.main.{i - 1}.", ks[i]))
        out = b[-1] + self.bottleneck(b[-3], f"dec.direct.{len(ks) - 3}.", ks[len(ks) - 2])
        y = F.elu(self.bn(self.conv(out, "dec.out_hidden"), "dec.bn_out"))
        return self.conv(y, "dec.out")


def bce(logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """-log p(x | logits) summed per image: [N]."""
    nll = torch.clamp(logits, min=0) - logits * x + torch.log1p(torch.exp(-torch.abs(logits)))
    return nll.flatten(1).sum(dim=1)


def gaussian_kl(mu, logvar):
    return 0.5 * torch.sum(mu ** 2 + torch.exp(logvar) - logvar - 1.0, dim=-1)


def nchw(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 1] -> [B, 1, H, W], NCHW in memory."""
    B, H, W, _ = images.shape
    return images.reshape(B, 1, H, W)


def train_loss(w: Weights, cfg: dict, batch, noise: dict, kl_weight, prods: Products,
               stats: Optional[Weights] = None):
    """One training step's mean loss over the batch ``(probs [B, H, W, 1],
    row_weight [B])`` and the per-image loss: the images binarized by
    ``noise["bin"]`` (u < probs), eps ``noise["eps"]`` [B, 1, nz]."""
    probs, rw = batch
    x = nchw((noise["bin"] < probs).to(probs.dtype))
    net = Net(w, cfg, prods, True, stats)
    mu, logvar = net.encode(x)
    z = mu + noise["eps"][:, 0, :] * torch.exp(0.5 * logvar)
    rec = bce(net.logits(x, z), x) * rw
    kl = gaussian_kl(mu, logvar) * rw
    loss = rec + kl_weight * kl
    return loss.sum() / torch.clamp(rw.sum(), min=1.0), loss


@torch.no_grad()
def nll_iw(w: Weights, cfg: dict, x: torch.Tensor, eps_chunks: List[torch.Tensor],
           prods: Products, stats: Weights) -> torch.Tensor:
    """The importance-weighted NLL per image of binarized ``x`` [B, H, W, 1]
    in evaluation mode, ``eps_chunks`` [B, ns, nz] each: -(logsumexp_k
    (log p(z_k) + log p(x | z_k) - log q(z_k | x)) - log K)."""
    net = Net(w, cfg, prods, False, stats)
    xc = nchw(x)
    B, nz = x.shape[0], cfg["nz"]
    log_w = []
    for eps in eps_chunks:
        mu, logvar = net.encode(xc)
        ns = eps.shape[1]
        z = mu[:, None] + eps * torch.exp(0.5 * logvar)[:, None]
        zk = z.transpose(0, 1).reshape(ns * B, nz)
        xk = xc[None].expand(ns, *xc.shape).reshape(ns * B, *xc.shape[1:])
        log_px = -bce(net.logits(xk, zk), xk).view(ns, B).T
        log_pz = -0.5 * (torch.sum(z ** 2, dim=-1) + nz * math.log(2 * math.pi))
        log_q = (-0.5 * torch.sum((z - mu[:, None]) ** 2 / torch.exp(logvar)[:, None], dim=-1)
                 - 0.5 * (nz * math.log(2 * math.pi) + torch.sum(logvar, dim=-1))[:, None])
        log_w.append(log_pz + log_px - log_q)
    lw = torch.cat(log_w, dim=1)
    return -(torch.logsumexp(lw, dim=1) - math.log(lw.shape[1]))
