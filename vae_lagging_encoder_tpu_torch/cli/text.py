"""Text experiment CLI, evaluation only (the reference's text.py --eval).

    python -m vae_lagging_encoder_tpu_torch.cli.text --dataset yahoo --eval \\
        --load_path models/yahoo/model.ckpt [--train_data ... --val_data ... \\
        --test_data ...] [--device cpu]

The checkpoint is the JAX package's ``.npz`` format (either package writes
it). Without ``--eval`` the CLI exits: training is not ported yet.
"""
from __future__ import annotations

import json
import sys

from ..train.loop import train_text
from .common import build_parser, config_from_args, make_run_logger


def main(argv=None) -> int:
    args = build_parser(default_dataset="yahoo").parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.eval:
        raise SystemExit("vae_lagging_encoder_tpu_torch.cli.text: training is not "
                         "ported yet; run the final evaluation with --eval "
                         "--load_path CKPT")
    with make_run_logger(cfg, "text") as log:
        log.info(f"[config] {cfg}")
        results = train_text(cfg, log, device=args.device)
        log.info("[results] " + json.dumps(results, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
