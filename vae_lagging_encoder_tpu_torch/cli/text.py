"""Text experiment CLI (the reference's text.py): training and evaluation.

    python -m vae_lagging_encoder_tpu_torch.cli.text --dataset yahoo --aggressive 1
    python -m vae_lagging_encoder_tpu_torch.cli.text --dataset yahoo --eval \
        --load_path models/yahoo/model.ckpt
    # resume a stopped run from its best checkpoint
    ... --load_path models/yahoo/model.ckpt --resume
    # off the GPU (the kernels' plain versions), e.g. at tiny widths
    ... --device cpu --ni 16 --enc_nh 32 --dec_nh 32 --nz 4

The checkpoint is the JAX package's ``.npz`` format (either package writes
and reads it). Generation (``--sample_from_prior``, ``--reconstruct``) is
not ported yet.
"""
from __future__ import annotations

import json
import sys

from ..train.loop import train_text
from .common import build_parser, config_from_args, make_run_logger


def main(argv=None) -> int:
    args = build_parser(default_dataset="yahoo").parse_args(argv)
    cfg = config_from_args(args)
    if cfg.model_type != "text":
        raise SystemExit(f"--dataset {cfg.dataset} is not a text dataset; "
                         "use vae_lagging_encoder_tpu_torch.cli.image")
    with make_run_logger(cfg, "text") as log:
        log.info(f"[config] {cfg}")
        results = train_text(cfg, log, device=args.device)
        log.info("[results] " + json.dumps(
            {k: v for k, v in results.items() if k != "history"}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
