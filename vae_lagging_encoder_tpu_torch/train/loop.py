"""Host-side entry points: the final evaluation of a text VAE.

Counterpart of ``vae_lagging_encoder_tpu/train/loop.py``'s
``load_text_datasets``, ``run_final_eval`` and ``train_text`` with
``cfg.eval``: load the corpora (vocabulary from the train split), bucket
the test split into a device-resident pool, build the model, load a
checkpoint, and report ELBO/rec/KL, MI, active units and the
importance-weighted NLL/PPL. Training is not ported yet.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..config import ExperimentConfig
from ..data import BucketedPool, MonoTextData
from ..models import VAE, build_text_vae
from ..ops.build import resolve_device
from ..utils.exp_utils import Logger
from ..utils.jax_params import from_jax_params
from .checkpoint import load_checkpoint
from .epoch import Noise, make_au_fn, make_eval_fn, make_iwnll_fn, make_mi_fn, make_noise


def dataset_is_labeled(cfg: ExperimentConfig) -> bool:
    """Whether corpus lines carry a leading "<label>\\t". Explicit --label
    0/1 wins; default: the built-in text corpora are all labeled."""
    if cfg.label is not None:
        return bool(cfg.label)
    return cfg.dataset in ("yahoo", "yelp", "synthetic", "docs_english")


def load_text_datasets(cfg: ExperimentConfig):
    label = dataset_is_labeled(cfg)
    train = MonoTextData(cfg.train_data, label=label)
    val = MonoTextData(cfg.val_data, label=label, vocab=train.vocab)
    test = MonoTextData(cfg.test_data, label=label, vocab=train.vocab)
    return train, val, test


def run_final_eval(cfg: ExperimentConfig, vae: VAE, pool: BucketedPool, log: Logger,
                   noise: Optional[Noise] = None) -> Dict:
    """ELBO decomposition, MI, AU, IW-NLL + PPL over ``pool``.

    ``noise`` (see train/epoch.py) defaults to a generator seeded with
    ``cfg.seed + 1``, shared by the evaluators in the order they run."""
    if cfg.iw_nsamples > cfg.iw_batch and cfg.iw_nsamples % cfg.iw_batch:
        raise SystemExit(
            f"--iw_nsamples {cfg.iw_nsamples} must be divisible by "
            f"--iw_batch {cfg.iw_batch} (the IW estimator runs in "
            f"iw_batch-sample chunks)")
    if noise is None:
        noise = make_noise(cfg.seed + 1, pool.arrays[0][0].device)
    # each evaluator ends in one device->host read, so host-clock spans are
    # complete device spans
    t = [time.perf_counter()]
    elbo = make_eval_fn(vae, pool)(noise)
    t.append(time.perf_counter())
    mi = make_mi_fn(vae, pool)(noise)
    t.append(time.perf_counter())
    au, _ = make_au_fn(vae, pool)()
    t.append(time.perf_counter())
    iw = make_iwnll_fn(vae, pool, nsamples=cfg.iw_nsamples, ns=cfg.iw_batch)(noise)
    t.append(time.perf_counter())
    seconds = dict(zip(("elbo", "mi", "au", "iw"), (b - a for a, b in zip(t, t[1:]))))
    log.info("[time] " + " ".join(f"{k} {v:.3f}s" for k, v in seconds.items())
             + f"; iw-nll {iw['n_sents'] / seconds['iw']:.2f} sentences/s")
    log.metric(split="test_seconds", **seconds)
    results = {
        "elbo_loss": float(elbo["loss"]), "rec": float(elbo["rec"]),
        "kl": float(elbo["kl"]), "mi": float(mi), "au": int(au),
        "iw_nll": float(iw["nll"]), "iw_ppl": float(iw["ppl"]),
    }
    log.info(f"[TEST] rec {results['rec']:.4f} kl {results['kl']:.4f} "
             f"mi {results['mi']:.4f} au {results['au']} "
             f"iw-nll {results['iw_nll']:.4f} iw-ppl {results['iw_ppl']:.2f}")
    log.metric(split="test", **results)
    return results


def train_text(cfg: ExperimentConfig, logger: Optional[Logger] = None,
               device="cuda") -> Dict:
    """``cfg.eval``: the final evaluation of ``cfg.load_path`` (or of the
    seeded initial model when no checkpoint is given)."""
    if not cfg.eval:
        raise SystemExit("training is not ported to vae_lagging_encoder_tpu_torch yet; "
                         "this package runs the final evaluation only "
                         "(--eval --load_path CKPT)")
    dev = resolve_device(device)
    log = logger or Logger()
    train_data, val_data, test_data = load_text_datasets(cfg)
    log.info(f"[data] train {len(train_data)} / val {len(val_data)} / "
             f"test {len(test_data)} sentences, vocab {len(train_data.vocab)}")
    test_pool = BucketedPool(test_data.create_data_batch(cfg.batch_size, cfg.length_buckets),
                             dev)
    vae = build_text_vae(cfg, len(train_data.vocab), device=dev)
    if cfg.load_path:
        params, extra = load_checkpoint(cfg.load_path)
        vae.load_state_dict(from_jax_params(params))
        log.info(f"[ckpt] loaded {cfg.load_path} (extra keys: {list(extra)})")
    with torch.no_grad():
        return run_final_eval(cfg, vae, test_pool, log)
