"""Shared CLI plumbing: the reference's flag names merged over the
per-dataset configs (flags win), as in ``vae_lagging_encoder_tpu/cli/
common.py``. ``--device`` takes the place of ``--jax_platform``;
``--autosave_niter``, ``--profile_dir``, ``--dp_devices`` and
``--tp_devices`` keep the JAX CLI's meanings (D*T > 1 starts D*T rank
processes: train/loop.py::run_parallel). Not offered: the compilation
cache and the XLA dispatch knobs ``--epoch_segment`` / ``--loop_unroll``
(an epoch here is a host loop of steps, with nothing to segment or
unroll)."""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..config import DATASET_CONFIGS, ExperimentConfig, get_config
from ..utils.exp_utils import Logger, create_exp_dir


def build_parser(default_dataset: str = "yahoo") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, default=default_dataset,
                   choices=sorted(DATASET_CONFIGS))
    p.add_argument("--aggressive", type=int, default=None,
                   help="1 = lagging-encoder inner loop (paper's algorithm)")
    p.add_argument("--kl_start", type=float, default=None)
    p.add_argument("--warm_up", type=int, default=None)
    p.add_argument("--nsamples", type=int, default=None)
    p.add_argument("--iw_nsamples", type=int, default=None)
    p.add_argument("--iw_batch", type=int, default=None,
                   help="IW estimator chunk size; iw_nsamples must divide by it")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--load_path", type=str, default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue training from load_path's saved state")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--optim", type=str, default=None, choices=["sgd", "adam"])
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--decay_epoch", type=int, default=None)
    p.add_argument("--lr_decay", type=float, default=None)
    p.add_argument("--max_decay", type=int, default=None)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--exp_dir", type=str, default=None)
    p.add_argument("--label", type=int, default=None)
    p.add_argument("--log_niter", type=int, default=None)
    p.add_argument("--test_nepoch", type=int, default=None)
    p.add_argument("--ni", type=int, default=None, help="embedding size")
    p.add_argument("--enc_nh", type=int, default=None, help="encoder LSTM hidden size")
    p.add_argument("--dec_nh", type=int, default=None, help="decoder LSTM hidden size")
    p.add_argument("--nz", type=int, default=None, help="latent dimension")
    p.add_argument("--dec_dropout_in", type=float, default=None)
    p.add_argument("--dec_dropout_out", type=float, default=None)
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--use_pallas", type=int, default=None,
                   help="1 = the kernel route (CUDA kernels on a GPU)")
    p.add_argument("--dp_devices", type=int, default=None,
                   help="data-parallel ranks: each takes batch_size/dp rows of every batch")
    p.add_argument("--tp_devices", type=int, default=None,
                   help="vocab-shard the decoder's output projection + CE "
                        "over this many tensor-parallel ranks (text models; "
                        "composes with --dp_devices: dp*tp ranks)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="capture a torch.profiler trace of one epoch here and "
                        "distill it into <profile_dir>/DOSSIER.md")
    p.add_argument("--autosave_niter", type=int, default=None,
                   help="mid-epoch autosave every N outer steps to "
                        "<save_path>.auto; --resume --load_path <save_path>.auto "
                        "restarts mid-epoch (0 = off)")
    p.add_argument("--train_data", type=str, default=None)
    p.add_argument("--val_data", type=str, default=None)
    p.add_argument("--test_data", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' (default) needs a GPU and never "
                        "falls back; 'cpu' runs the kernels' plain versions")
    return p


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    overrides = {}
    for k, v in vars(args).items():
        if k in fields and v is not None and k != "dataset":
            if k in ("aggressive", "label", "use_pallas"):
                v = bool(v)
            if k in ("eval", "resume") and not v:
                continue  # store_true default False shouldn't override
            overrides[k] = v
    return get_config(args.dataset, **overrides)


def make_run_logger(cfg: ExperimentConfig, kind: str) -> Logger:
    exp_dir = cfg.exp_dir or os.path.join(
        "models", cfg.dataset,
        f"exp_{kind}_aggressive{int(cfg.aggressive)}_"
        f"kls{cfg.kl_start}_warm{cfg.warm_up}_seed{cfg.seed}_{int(time.time())}")
    create_exp_dir(exp_dir, scripts_to_save=[sys.argv[0]] if sys.argv else None)
    return Logger(os.path.join(exp_dir, "log.txt"))


def seeded_generator(device, seed: int, *stream: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and the ids of a stream
    (a use, a batch), so that each stream draws independently of the others."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state >> np.uint64(1)))
