"""Image experiment CLI (the reference's image.py): training and evaluation.

    python -m vae_lagging_encoder_tpu_torch.cli.image --dataset omniglot --aggressive 1
    python -m vae_lagging_encoder_tpu_torch.cli.image --dataset omniglot --eval \
        --load_path models/omniglot/model.ckpt
    # resume a stopped run from its best checkpoint
    ... --load_path models/omniglot/model.ckpt --resume
    # off the GPU
    ... --device cpu

The data is ``--train_data`` (the reference's ``omniglot.pt`` or an
``.npz`` of the same splits; the synthetic substitute, with a warning, when
the file is missing); the widths are the config's. The checkpoint is the
JAX package's ``.npz`` format (either package writes and reads it).
Generation (``--sample_from_prior``, ``--reconstruct``) is not ported yet.
"""
from __future__ import annotations

import json
import sys

from ..train.loop import train_image
from .common import build_parser, config_from_args, make_run_logger


def build_image_parser():
    return build_parser(default_dataset="omniglot")


def init_config(argv=None):
    args = build_image_parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.model_type != "image":
        raise SystemExit(f"--dataset {cfg.dataset} is not an image dataset; "
                         "use vae_lagging_encoder_tpu_torch.cli.text")
    return cfg, args


def main(argv=None) -> int:
    cfg, args = init_config(argv)
    with make_run_logger(cfg, "image") as log:
        log.info(f"[config] {cfg}")
        results = train_image(cfg, log, device=args.device)
        log.info("[results] " + json.dumps(
            {k: v for k, v in results.items() if k != "history"}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
