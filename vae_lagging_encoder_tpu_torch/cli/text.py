"""Text experiment CLI (the reference's text.py): training, evaluation and
generation.

    python -m vae_lagging_encoder_tpu_torch.cli.text --dataset yahoo --aggressive 1
    python -m vae_lagging_encoder_tpu_torch.cli.text --dataset yahoo --eval \
        --load_path models/yahoo/model.ckpt
    # resume a stopped run from its best checkpoint
    ... --load_path models/yahoo/model.ckpt --resume
    # sentences from the prior, or reconstructions of test sentences
    ... --load_path ck --sample_from_prior --num_samples 20 --decoding_strategy sample
    ... --load_path ck --reconstruct --decoding_strategy beam --output_file rec.txt
    # off the GPU (the kernels' plain versions), e.g. at tiny widths
    ... --device cpu --ni 16 --enc_nh 32 --dec_nh 32 --nz 4

The checkpoint is the JAX package's ``.npz`` format (either package writes
and reads it).
"""
from __future__ import annotations

import json
import sys
import time

import torch

from ..data import MonoTextData
from ..models import build_text_vae
from ..ops.build import resolve_device
from ..train.checkpoint import load_checkpoint
from ..train.loop import dataset_is_labeled, train_text
from ..utils.jax_params import from_jax_params
from .common import build_parser, config_from_args, make_run_logger, seeded_generator

# generator streams of generate(): the prior's z, then the decoder's noise
# (greedy and beam draw none), one stream per reconstructed batch
PRIOR_Z, DECODE = 0, 1


def build_text_parser():
    p = build_parser(default_dataset="yahoo")
    p.add_argument("--sample_from_prior", action="store_true",
                   help="sample sentences from the prior (needs --load_path)")
    p.add_argument("--reconstruct", action="store_true",
                   help="reconstruct test sentences (needs --load_path)")
    p.add_argument("--decoding_strategy", type=str, default="greedy",
                   choices=["greedy", "sample", "beam"])
    p.add_argument("--num_samples", type=int, default=10)
    p.add_argument("--max_decode_len", type=int, default=100)
    p.add_argument("--output_file", type=str, default="")
    return p


def init_config(argv=None):
    args = build_text_parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.model_type != "text":
        raise SystemExit(f"--dataset {cfg.dataset} is not a text dataset; "
                         "use vae_lagging_encoder_tpu_torch.cli.image")
    return cfg, args


@torch.no_grad()
def generate(cfg, args, log) -> int:
    """Prior sampling (``--sample_from_prior``) or test-set reconstruction
    (``--reconstruct``) from ``cfg.load_path``, one sentence a line: the
    vocabulary is the train split's, the reconstructions are the first
    ``num_samples`` real rows of the test split's batches. The seconds of
    the decoding go on a ``split="generate"`` metric record."""
    dev = resolve_device(args.device)
    if not cfg.load_path:
        raise SystemExit("--sample_from_prior/--reconstruct need --load_path")
    label = dataset_is_labeled(cfg)
    vocab = MonoTextData(cfg.train_data, label=label).vocab
    vae = build_text_vae(cfg, len(vocab), device=dev)
    vae.load_state_dict(from_jax_params(load_checkpoint(cfg.load_path)[0]))
    strategy = args.decoding_strategy
    lines, batches = [], []
    t0 = time.perf_counter()
    if args.sample_from_prior:
        z = vae.sample_from_prior(args.num_samples, seeded_generator(dev, cfg.seed, PRIOR_Z))
        if strategy == "beam":
            outs = vae.dec.beam_search_decode(z, max_len=args.max_decode_len)
        elif strategy == "sample":
            outs = vae.dec.sample_decode(z, args.max_decode_len,
                                         generator=seeded_generator(dev, cfg.seed, DECODE))
        else:
            outs = vae.dec.greedy_decode(z, args.max_decode_len)
        lines = [" ".join(vocab.decode(row)) for row in _rows(outs)]
    else:  # reconstruct
        test = MonoTextData(cfg.test_data, label=label, vocab=vocab)
        # ceil, so that num_samples > batch_size takes enough batches
        n_batches = -(-args.num_samples // cfg.batch_size)
        batches = test.create_data_batch(cfg.batch_size, cfg.length_buckets)[:n_batches]
        for i, b in enumerate(batches):
            outs = vae.reconstruct(torch.from_numpy(b.tokens).long().to(dev),
                                   torch.from_numpy(b.mask).to(dev), strategy,
                                   args.max_decode_len,
                                   generator=seeded_generator(dev, cfg.seed, DECODE, i))
            lines += [" ".join(vocab.decode(row))
                      for row, w in zip(_rows(outs), b.row_weight) if w > 0]
        lines = lines[: args.num_samples]
    seconds = time.perf_counter() - t0  # every decode ends in a read to the host
    log.info(f"[generate] {len(lines)} sentences ({strategy}) in {seconds:.3f} s, "
             f"{len(lines) / max(seconds, 1e-9):.2f} sentences/s")
    log.metric(split="generate", mode="prior" if args.sample_from_prior else "reconstruct",
               strategy=strategy, sentences=len(lines), batches=len(batches), seconds=seconds)
    text = "\n".join(lines)
    if args.output_file:
        with open(args.output_file, "w") as fh:
            fh.write(text + "\n")
        log.info(f"[generate] {len(lines)} sentences -> {args.output_file}")
    else:
        log.info(text)
    return 0


def _rows(outs):
    """Token rows as lists: a [N, L] tensor (greedy, sample) or lists (beam)."""
    return outs.tolist() if isinstance(outs, torch.Tensor) else outs


def main(argv=None) -> int:
    cfg, args = init_config(argv)
    with make_run_logger(cfg, "text") as log:
        log.info(f"[config] {cfg}")
        if args.sample_from_prior or args.reconstruct:
            return generate(cfg, args, log)
        results = train_text(cfg, log, device=args.device)
        log.info("[results] " + json.dumps(
            {k: v for k, v in results.items() if k != "history"}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
