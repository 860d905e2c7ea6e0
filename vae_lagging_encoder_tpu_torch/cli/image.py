"""Image experiment CLI (the reference's image.py): training, evaluation and
generation.

    python -m vae_lagging_encoder_tpu_torch.cli.image --dataset omniglot --aggressive 1
    python -m vae_lagging_encoder_tpu_torch.cli.image --dataset omniglot --eval \
        --load_path models/omniglot/model.ckpt
    # resume a stopped run from its best checkpoint
    ... --load_path models/omniglot/model.ckpt --resume
    # PNG grids of prior samples, or of test images beside their reconstructions
    ... --load_path ck --sample_from_prior --num_samples 50 --output_file samples.png
    ... --load_path ck --reconstruct --output_file recon.png
    # off the GPU
    ... --device cpu
    # jxhe's published model (batch norm, the bottleneck PixelCNN)
    ... --image_arch published

The data is ``--train_data`` (the reference's ``omniglot.pt`` or an
``.npz`` of the same splits; the synthetic substitute, with a warning, when
the file is missing); the widths are the config's. The checkpoint is the
JAX package's ``.npz`` format (either package writes and reads it; the
published model's, with its batch norms' running statistics, this
package alone). Generation runs the cached incremental PixelCNN sampler
(the published model: the dense sampler).
"""
from __future__ import annotations

import json
import os
import struct
import sys
import time
import zlib

import numpy as np
import torch

from ..data import load_omniglot
from ..models import build_image_vae
from ..ops.build import resolve_device
from ..train.checkpoint import load_checkpoint
from ..train.loop import train_image
from ..utils.jax_params import from_jax_params
from .common import build_parser, config_from_args, make_run_logger, seeded_generator

# generator streams of generate(): the prior's z and the pixels; the test
# images' binarization, the posterior's z and the pixels
PRIOR_Z, PRIOR_PIX, REC_BIN, REC_Z, REC_PIX = range(5)


def build_image_parser():
    p = build_parser(default_dataset="omniglot")
    p.add_argument("--sample_from_prior", action="store_true",
                   help="sample images from the prior (needs --load_path)")
    p.add_argument("--reconstruct", action="store_true",
                   help="reconstruct test images (needs --load_path)")
    p.add_argument("--num_samples", type=int, default=50)
    p.add_argument("--output_file", type=str, default="",
                   help="PNG path (default <exp_dir>/{samples,recon}.png)")
    p.add_argument("--image_arch", type=str, default=None, choices=["stack", "published"],
                   help="stack: the JAX package's PixelCNN (default); published: jxhe's "
                        "config_omniglot.py model (batch norm, bottleneck blocks)")
    return p


def init_config(argv=None):
    args = build_image_parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.model_type != "image":
        raise SystemExit(f"--dataset {cfg.dataset} is not an image dataset; "
                         "use vae_lagging_encoder_tpu_torch.cli.text")
    return cfg, args


def save_grid(imgs, path: str, ncols: int = 10) -> None:
    """[N, H, W, 1] images in [0, 1] -> one PNG grid, a 1-pixel white border
    around each image, filled row by row."""
    imgs = np.asarray(imgs)
    n, h, w, _ = imgs.shape
    if n == 0:
        raise ValueError("no images to render (num_samples=0 or an empty test split)")
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    canvas = np.ones((nrows * (h + 2), ncols * (w + 2)), np.float32)
    for i in range(n):
        r, c = divmod(i, ncols)
        canvas[r * (h + 2) + 1:r * (h + 2) + 1 + h,
               c * (w + 2) + 1:c * (w + 2) + 1 + w] = imgs[i, :, :, 0]
    _write_gray_png(path, np.round(np.clip(canvas, 0, 1) * 255).astype(np.uint8))


def _write_gray_png(path: str, gray: np.ndarray) -> None:
    """A minimal 8-bit grayscale PNG encoder (zlib and struct only)."""
    h, w = gray.shape
    raw = b"".join(b"\x00" + gray[r].tobytes() for r in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


@torch.no_grad()
def generate(cfg, args, log, exp_dir: str) -> int:
    """Prior samples, or the first ``num_samples`` test images (binarized)
    each followed by its reconstruction (a grid of 10 columns: original,
    reconstruction, original, ...), to one PNG. The seconds of the sampling
    go on a ``split="generate"`` metric record."""
    dev = resolve_device(args.device)
    if not cfg.load_path:
        raise SystemExit("--sample_from_prior/--reconstruct need --load_path")
    vae = build_image_vae(cfg, device=dev)
    vae.load_state_dict(from_jax_params(load_checkpoint(cfg.load_path)[0]))
    vae.eval()  # batch norm (the published model) on its running statistics
    n = args.num_samples
    if args.sample_from_prior:
        t0 = time.perf_counter()
        z = vae.sample_from_prior(n, seeded_generator(dev, cfg.seed, PRIOR_Z))
        imgs = vae.dec.sample(z, generator=seeded_generator(dev, cfg.seed, PRIOR_PIX)).cpu()
        out = args.output_file or os.path.join(exp_dir, "samples.png")
    else:  # reconstruct
        probs = torch.from_numpy(load_omniglot(cfg.train_data)[2][:n]).to(dev)
        n = probs.shape[0]
        t0 = time.perf_counter()
        u = torch.rand(probs.shape, generator=seeded_generator(dev, cfg.seed, REC_BIN),
                       device=dev)
        xb = (u < probs).float()  # a fresh binarization, as at training and evaluation
        z, _ = vae.enc.sample(xb, None, 1, generator=seeded_generator(dev, cfg.seed, REC_Z))
        recon = vae.dec.sample(z[:, 0, :], generator=seeded_generator(dev, cfg.seed, REC_PIX))
        imgs = torch.stack([xb, recon], dim=1).reshape(-1, *xb.shape[1:]).cpu()
        out = args.output_file or os.path.join(exp_dir, "recon.png")
    seconds = time.perf_counter() - t0  # ends in the read to the host
    save_grid(imgs.numpy(), out, ncols=10)
    kind = "prior samples" if args.sample_from_prior else "reconstructions (orig/recon interleaved)"
    log.info(f"[generate] {n} {kind} in {seconds:.3f} s, {n / max(seconds, 1e-9):.2f} "
             f"images/s -> {out}")
    log.metric(split="generate", mode="prior" if args.sample_from_prior else "reconstruct",
               images=n, seconds=seconds, path=out)
    return 0


def main(argv=None) -> int:
    cfg, args = init_config(argv)
    with make_run_logger(cfg, "image") as log:
        log.info(f"[config] {cfg}")
        if args.sample_from_prior or args.reconstruct:
            return generate(cfg, args, log, os.path.dirname(log.log_path))
        results = train_image(cfg, log, device=args.device)
        log.info("[results] " + json.dumps(
            {k: v for k, v in results.items() if k != "history"}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
