"""Toy posterior-mean-space tracing (the reference's toy.py).

Trains the 1-D-latent text VAE on the synthetic corpus and, before training
and every ``--plot_niter`` epochs, records for a fixed probe set of
sentences the pairs

    (<z> under the model's posterior p(z|x), by quadrature on a z grid
         with the decoder's likelihoods,
     mu(x), the mean of the encoder's approximate posterior)

into ``{plot_dir}/{dataset}_aggr{a}_seed{s}.pkl``: a list of ``{"epoch",
"pairs"}``, ``pairs`` a float32 numpy array [n, 2], which
``plot_scripts/`` draws as the paper's posterior-mean-space figures
(collapse onto the x-axis against the diagonal).

    python -m vae_lagging_encoder_tpu_torch.cli.toy --dataset synthetic \
        --aggressive 1 --epochs 20 --plot_niter 1

The probe set is the first ``--num_plot`` real sentences of the training
pool in its flat order (buckets by ascending length), the same in every
probe; the grid is ``np.arange(zmin, zmax, dz)`` in float32, as
``jnp.arange`` builds it (400 points at the defaults). Each epoch is the
training epoch of ``train/epoch.py`` with the aggressive flag fixed (no MI
switch-off, no validation, as in the reference's toy). With ``--exp_dir``
the log also goes to ``{exp_dir}/log.txt`` and the seconds of each probe
and epoch to ``log.metrics.jsonl``.
"""
from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np
import torch

from ..data import BucketedPool
from ..models import build_text_vae
from ..ops.build import resolve_device
from ..train.epoch import make_train_epoch
from ..train.loop import load_text_datasets, make_noise_for
from ..utils.exp_utils import Logger, create_exp_dir
from .common import build_parser, config_from_args


def init_config(argv=None):
    p = build_parser(default_dataset="synthetic")
    p.add_argument("--plot_niter", type=int, default=1,
                   help="epochs between posterior-mean-space probes")
    p.add_argument("--num_plot", type=int, default=500, help="number of probe sentences")
    p.add_argument("--zmin", type=float, default=-20.0)
    p.add_argument("--zmax", type=float, default=20.0)
    p.add_argument("--dz", type=float, default=0.1)
    p.add_argument("--plot_dir", type=str, default="plot_data")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    if cfg.nz != 1:
        raise SystemExit("toy tracing requires nz=1 (use --dataset synthetic)")
    return cfg, args


def z_grid(zmin: float, zmax: float, dz: float) -> torch.Tensor:
    """The probe grid [G, 1]: ``np.arange`` in float32, which is what
    ``jnp.arange`` with a step computes (its length included)."""
    return torch.from_numpy(np.arange(zmin, zmax, dz, dtype=np.float32))[:, None]


def probe_batches(pool: BucketedPool, num_plot: int):
    """Whole batches of the pool in flat order until they hold ``num_plot``
    real sentences."""
    batches, n = [], 0
    for batch in pool:
        if n >= num_plot:
            break
        batches.append(batch)
        n += float(batch[2].sum())
    return batches


@torch.no_grad()
def probe_pairs(vae, batches, grid: torch.Tensor, num_plot: int) -> np.ndarray:
    """(<z>_post, mu) of the real rows of ``batches``: float32 [n, 2], n <= num_plot."""
    pairs = []
    for tokens, mask, row_weight in batches:
        post = vae.calc_model_posterior_mean(tokens, mask, grid)
        infer = vae.calc_infer_mean(tokens, mask)
        keep = row_weight > 0
        pairs.append(torch.stack([post[keep, 0], infer[keep, 0]], dim=1).cpu().numpy())
    return np.concatenate(pairs)[:num_plot].astype(np.float32)


def main(argv=None) -> int:
    cfg, args = init_config(argv)
    dev = resolve_device(args.device)
    log_path = os.path.join(create_exp_dir(cfg.exp_dir), "log.txt") if cfg.exp_dir else None
    with Logger(log_path) as log:
        train_data, _, _ = load_text_datasets(cfg)
        pool = BucketedPool(train_data.create_data_batch(cfg.batch_size, cfg.length_buckets), dev)
        vae = build_text_vae(cfg, len(train_data.vocab), device=dev)
        epoch_fn, opt_init = make_train_epoch(vae, pool, cfg)
        opt_state = opt_init()
        batches = probe_batches(pool, args.num_plot)
        grid = z_grid(args.zmin, args.zmax, args.dz).to(dev)
        log.info(f"[toy] probing {sum(float(b[2].sum()) for b in batches):.0f} sentences on a "
                 f"{grid.shape[0]}-point z grid")
        os.makedirs(args.plot_dir, exist_ok=True)
        path = os.path.join(args.plot_dir,
                            f"{cfg.dataset}_aggr{int(cfg.aggressive)}_seed{cfg.seed}.pkl")
        noise_for = make_noise_for(cfg.seed, dev)
        rng = np.random.RandomState(cfg.seed)
        kl_weight = np.float32(cfg.kl_start)
        trace = []

        def record(epoch: int) -> None:
            t0 = time.perf_counter()
            pairs = probe_pairs(vae, batches, grid, args.num_plot)  # ends in a read to the host
            seconds = time.perf_counter() - t0
            trace.append({"epoch": epoch, "pairs": pairs})
            with open(path, "wb") as fh:
                pickle.dump(trace, fh)
            log.info(f"[toy] epoch {epoch}: recorded {len(pairs)} (<z>_post, mu) pairs in "
                     f"{seconds:.3f} s -> {path}")
            log.metric(split="toy_probe", epoch=epoch, pairs=len(pairs), seconds=seconds)

        record(-1)  # before training
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            opt_state, kl_weight, sums, inner = epoch_fn(
                opt_state, noise_for("train", epoch), kl_weight, float(cfg.lr),
                rng.permutation(pool.num_batches), bool(cfg.aggressive))
            loss_s, _, kl_s, n_sent, _ = sums.tolist()
            seconds = time.perf_counter() - t0
            log.info(f"epoch {epoch}: loss {loss_s / n_sent:.4f} kl {kl_s / n_sent:.4f} "
                     f"inner {inner} ({seconds:.2f} s)")
            log.metric(split="toy_epoch", epoch=epoch, train_loss=loss_s / n_sent,
                       kl=kl_s / n_sent, inner_iters=inner, steps=pool.num_batches + inner,
                       seconds=seconds)
            if (epoch + 1) % args.plot_niter == 0:
                record(epoch)
        return 0


if __name__ == "__main__":
    sys.exit(main())
