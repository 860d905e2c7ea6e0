"""Host-side entry points: training and the final evaluation of the text and
image VAEs.

Counterpart of ``vae_lagging_encoder_tpu/train/loop.py``: ``run_training``
(KL-annealed training with separate encoder and decoder optimizers, the
aggressive inner loop with its epoch-level MI-plateau permanent switch-off,
per-epoch validation ELBO, the best checkpoint, LR plateau decay with
rollback to the best parameters and fresh optimizer state, the test
cadence, epoch-level ``--resume``, and the final evaluation on the best
parameters), ``run_final_eval``, ``train_text`` and ``train_image``. The
image path passes its loss (``make_image_loss_fn``) and eval prep
(``binarize_prep``) through the same lifecycle.

Not ported from ``run_training``: data and tensor parallelism, mid-epoch
autosaves (``--autosave_niter``; a checkpoint holding a mid-epoch position
is refused), ``--profile_dir``, and the XLA dispatch knobs
``--epoch_segment`` / ``--loop_unroll`` (an epoch here is a host loop of
steps, logged every ``log_niter`` steps as the reference does).

Noise: ``run_training`` takes ``noise_for(stage, epoch) -> noise`` (see
train/epoch.py for the provider's sites) with stages ``"train"``,
``"val_mi"``, ``"val"``, ``"test"`` and ``"final"``. The default,
``make_noise_for``, seeds one generator per (stage, epoch) from the
config's seed, so a resumed run draws what the uninterrupted run would
have drawn from that epoch on; a test can replay the JAX package's keys.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data import (BucketedPool, ImagePool, MonoTextData, Pool, ensure_synthetic_dataset,
                    load_omniglot)
from ..models import VAE, build_image_vae, build_text_vae
from ..ops.build import resolve_device
from ..utils.exp_utils import Logger
from ..utils.jax_params import from_jax_params, to_jax_params
from .checkpoint import load_checkpoint, save_checkpoint
from .epoch import (Noise, binarize_prep, make_au_fn, make_eval_fn, make_image_loss_fn,
                    make_iwnll_fn, make_mi_fn, make_noise, make_train_epoch, unpack)
from .optim import state_from_tree, state_to_tree

NoiseFor = Callable[[str, int], Noise]
STAGES = ("train", "val_mi", "val", "test")


def make_noise_for(seed: int, device) -> NoiseFor:
    """One generator per (stage, epoch), seeded from ``seed``; the final
    evaluation's is seeded with ``seed + 1`` as in a standalone ``--eval``."""

    def noise_for(stage: str, epoch: int) -> Noise:
        if stage == "final":
            return make_noise(seed + 1, device)
        return make_noise((seed * 8 + STAGES.index(stage)) * 100_003 + epoch, device)

    return noise_for


def dataset_is_labeled(cfg: ExperimentConfig) -> bool:
    """Whether corpus lines carry a leading "<label>\\t". Explicit --label
    0/1 wins; default: the built-in text corpora are all labeled."""
    if cfg.label is not None:
        return bool(cfg.label)
    return cfg.dataset in ("yahoo", "yelp", "synthetic", "docs_english")


def load_text_datasets(cfg: ExperimentConfig):
    """(train, val, test) ``MonoTextData`` of the config's files; for
    ``synthetic`` the corpus is written first where it is missing
    (``ensure_synthetic_dataset``, relative to the working directory)."""
    if cfg.dataset == "synthetic":
        ensure_synthetic_dataset()
    label = dataset_is_labeled(cfg)
    train = MonoTextData(cfg.train_data, label=label)
    val = MonoTextData(cfg.val_data, label=label, vocab=train.vocab)
    test = MonoTextData(cfg.test_data, label=label, vocab=train.vocab)
    return train, val, test


def run_final_eval(cfg: ExperimentConfig, vae: VAE, pool: Pool, log: Logger,
                   noise: Optional[Noise] = None, eval_loss_fn: Optional[Callable] = None,
                   prep: Callable = unpack) -> Dict:
    """ELBO decomposition, MI, AU, IW-NLL + PPL over ``pool``.

    ``noise`` (see train/epoch.py) defaults to a generator seeded with
    ``cfg.seed + 1``, shared by the evaluators in the order they run.
    ``eval_loss_fn`` and ``prep`` default to the text versions."""
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
    elbo = make_eval_fn(vae, pool, loss_fn=eval_loss_fn)(noise)
    t.append(time.perf_counter())
    mi = make_mi_fn(vae, pool, prep=prep)(noise)
    t.append(time.perf_counter())
    au, _ = make_au_fn(vae, pool, prep=prep)(noise)
    t.append(time.perf_counter())
    iw = make_iwnll_fn(vae, pool, nsamples=cfg.iw_nsamples, ns=cfg.iw_batch, prep=prep)(noise)
    t.append(time.perf_counter())
    seconds = dict(zip(("elbo", "mi", "au", "iw"), (b - a for a, b in zip(t, t[1:]))))
    unit = "sentences" if cfg.model_type == "text" else "images"
    log.info("[time] " + " ".join(f"{k} {v:.3f}s" for k, v in seconds.items())
             + f"; iw-nll {iw['n_sents'] / seconds['iw']:.2f} {unit}/s")
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


def _snapshot(vae: VAE) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in vae.state_dict().items()}


def run_training(cfg: ExperimentConfig, vae: VAE, train_pool: Pool, val_pool: Pool,
                 test_pool: Pool, log: Logger, loss_fn: Optional[Callable] = None,
                 eval_loss_fn: Optional[Callable] = None, prep: Callable = unpack,
                 resume_state: Optional[Dict] = None,
                 noise_for: Optional[NoiseFor] = None) -> Dict:
    """The training lifecycle (module docstring); ``vae`` holds the initial
    (or loaded) parameters and ends holding the best ones. ``loss_fn``
    (training mode), ``eval_loss_fn`` and ``prep`` default to the text
    versions. Returns the final evaluation's results plus ``history``,
    ``best_val_loss``, ``save_path``."""
    if cfg.resume and not cfg.load_path:
        raise SystemExit("--resume requires --load_path (a checkpoint to "
                         "continue from)")
    if cfg.iw_nsamples > cfg.iw_batch and cfg.iw_nsamples % cfg.iw_batch:
        raise SystemExit(
            f"--iw_nsamples {cfg.iw_nsamples} must be divisible by "
            f"--iw_batch {cfg.iw_batch} (the IW estimator runs in "
            f"iw_batch-sample chunks)")
    if cfg.warm_up <= 0 and cfg.kl_start < 1.0:
        raise SystemExit(
            f"--warm_up {cfg.warm_up} with --kl_start {cfg.kl_start}: a "
            "non-positive anneal window cannot reach kl_weight 1.0; use "
            "--kl_start 1.0 for no annealing or a positive --warm_up")
    dev = next(vae.parameters()).device
    noise_for = noise_for or make_noise_for(cfg.seed, dev)
    epoch_fn, opt_init = make_train_epoch(vae, train_pool, cfg, loss_fn=loss_fn)
    opt_state = opt_init()
    val_eval = make_eval_fn(vae, val_pool, loss_fn=eval_loss_fn)
    val_mi = make_mi_fn(vae, val_pool, prep=prep)
    test_eval = make_eval_fn(vae, test_pool, loss_fn=eval_loss_fn)

    kl_weight = np.float32(cfg.kl_start)
    lr = float(cfg.lr)
    aggressive = bool(cfg.aggressive)
    pre_mi = 0.0
    best_loss = math.inf
    best_params = _snapshot(vae)
    decay_cnt = 0
    not_improved = 0
    start_epoch = 0
    save_path = cfg.save_path or f"models/{cfg.dataset}/model.ckpt"
    if resume_state:
        if resume_state.get("mid_epoch"):
            raise SystemExit("this checkpoint holds a mid-epoch position (an autosave); "
                             "mid-epoch resume is not ported to this package — resume "
                             "from the best-val checkpoint instead")
        kl_weight = np.float32(resume_state.get("kl_weight", kl_weight))
        lr = float(resume_state.get("lr", lr))
        aggressive = bool(resume_state.get("aggressive", aggressive))
        pre_mi = float(resume_state.get("pre_mi", pre_mi))
        best_loss = float(resume_state.get("best_loss",
                                           resume_state.get("val", {}).get("loss", best_loss)))
        decay_cnt = int(resume_state.get("decay_cnt", 0))
        not_improved = int(resume_state.get("not_improved", 0))
        start_epoch = int(resume_state.get("epoch", -1)) + 1
        if "opt_state" in resume_state:
            opt_state = state_from_tree(resume_state["opt_state"], dev)
        log.info(f"[resume] from epoch {start_epoch} (kl_weight {float(kl_weight):.4f}, "
                 f"lr {lr:.4f}, aggressive {aggressive})")
    rng = np.random.RandomState(cfg.seed)
    for _ in range(start_epoch):  # keep the shuffle stream aligned
        rng.permutation(train_pool.num_batches)
    history = []
    log.info(f"[train] {cfg.epochs} epochs, {train_pool.num_batches} "
             f"batches/epoch, aggressive={aggressive}")

    global_step = start_epoch * train_pool.num_batches
    t_start = time.time()
    report = torch.zeros(5, device=dev)

    def on_step(i, kl_w, aux):
        nonlocal report, global_step
        report = report + aux
        global_step += 1
        if cfg.log_niter and global_step % cfg.log_niter == 0:
            rl, rr, rk, rn, _ = report.tolist()
            rn = max(rn, 1.0)
            log.info(f"epoch {epoch}, iter {global_step}: avg_loss {rl / rn:.4f}, "
                     f"kl {rk / rn:.4f}, recon {rr / rn:.4f}, kl_weight "
                     f"{float(kl_w):.4f}, time {time.time() - t_start:.1f}s")
            report = torch.zeros(5, device=dev)

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        order = rng.permutation(train_pool.num_batches)
        was_aggressive = aggressive
        opt_state, kl_weight, sums, inner_iters = epoch_fn(
            opt_state, noise_for("train", epoch), kl_weight, lr, order, aggressive,
            on_step=on_step)
        loss_s, rec_s, kl_s, n_sent, n_words = sums.tolist()
        dt = time.time() - t0
        ran = train_pool.num_batches + inner_iters
        log.info(f"epoch {epoch}: loss {loss_s / n_sent:.4f} "
                 f"rec {rec_s / n_sent:.4f} kl {kl_s / n_sent:.4f} "
                 f"kl_weight {float(kl_weight):.4f} inner_iters {inner_iters} "
                 f"({dt:.1f}s, {ran / max(dt, 1e-9):.1f} steps/s)")

        # --- epoch-level MI plateau: permanent aggressive switch-off ----
        if aggressive:
            with torch.no_grad():
                cur_mi = val_mi(noise_for("val_mi", epoch))
            log.info(f"epoch {epoch}: val MI {cur_mi:.4f} (prev {pre_mi:.4f})")
            if cur_mi < pre_mi:
                aggressive = False
                log.info(f"epoch {epoch}: MI plateau — aggressive OFF permanently")
            pre_mi = cur_mi

        # --- validation ELBO + best checkpoint + LR plateau decay -------
        with torch.no_grad():
            val = val_eval(noise_for("val", epoch))
        log.info(f"epoch {epoch}: VAL loss {val['loss']:.4f} rec {val['rec']:.4f} "
                 f"kl {val['kl']:.4f} nll {val['nll']:.4f} ppl {val['ppl']:.2f}")
        log.metric(epoch=epoch, train_loss=loss_s / n_sent, val_loss=val["loss"],
                   val_kl=val["kl"], kl_weight=float(kl_weight), lr=lr,
                   inner_iters=inner_iters, aggressive=aggressive,
                   epoch_aggressive=was_aggressive, epoch_seconds=dt,
                   steps_per_sec=ran / max(dt, 1e-9))
        history.append({"epoch": epoch, **{f"val_{k}": v for k, v in val.items()}})

        if cfg.test_nepoch and (epoch + 1) % cfg.test_nepoch == 0:
            with torch.no_grad():
                te = test_eval(noise_for("test", epoch))
            log.info(f"epoch {epoch}: TEST loss {te['loss']:.4f} "
                     f"rec {te['rec']:.4f} kl {te['kl']:.4f} ppl {te['ppl']:.2f}")
            log.metric(epoch=epoch, split="test_cadence", **{k: float(v) for k, v in te.items()})

        if val["loss"] < best_loss:
            best_loss = val["loss"]
            best_params = _snapshot(vae)
            not_improved = 0
            save_checkpoint(save_path, to_jax_params(best_params), {
                "opt_state": state_to_tree(opt_state),
                "epoch": epoch, "kl_weight": float(kl_weight), "lr": lr,
                "aggressive": aggressive, "pre_mi": pre_mi,
                "best_loss": best_loss, "decay_cnt": decay_cnt,
                "not_improved": not_improved,
                "val": {k: float(v) for k, v in val.items()},
                "dataset": cfg.dataset,
            })
        else:
            not_improved += 1
            if not_improved >= cfg.decay_epoch and epoch >= cfg.warm_up:
                # the reference's plateau decay: lr * lr_decay, RELOAD the best
                # parameters, rebuild both optimizers (fresh state)
                lr *= cfg.lr_decay
                decay_cnt += 1
                not_improved = 0
                vae.load_state_dict(best_params)
                opt_state = opt_init()
                log.info(f"epoch {epoch}: plateau — lr -> {lr:.4f} "
                         f"(decay {decay_cnt}/{cfg.max_decay}), rolled back to best")
                if decay_cnt >= cfg.max_decay:
                    log.info("max decays reached — stopping")
                    break

    vae.load_state_dict(best_params)
    with torch.no_grad():
        results = run_final_eval(cfg, vae, test_pool, log, noise=noise_for("final", 0),
                                 eval_loss_fn=eval_loss_fn, prep=prep)
    results["history"] = history
    results["best_val_loss"] = best_loss
    results["save_path"] = save_path
    return results


def train_text(cfg: ExperimentConfig, logger: Optional[Logger] = None,
               device="cuda") -> Dict:
    """``cfg.eval``: the final evaluation of ``cfg.load_path`` (or of the
    seeded initial model when no checkpoint is given); otherwise training
    (``run_training``) from the seeded initial model or, with ``--resume``,
    from ``cfg.load_path`` and its saved state."""
    dev = resolve_device(device)
    log = logger or Logger()
    train_data, val_data, test_data = load_text_datasets(cfg)
    log.info(f"[data] train {len(train_data)} / val {len(val_data)} / "
             f"test {len(test_data)} sentences, vocab {len(train_data.vocab)}")

    def pool(d):
        return BucketedPool(d.create_data_batch(cfg.batch_size, cfg.length_buckets), dev)

    test_pool = pool(test_data)
    vae = build_text_vae(cfg, len(train_data.vocab), device=dev)
    extra = {}
    if cfg.load_path:
        params, extra = load_checkpoint(cfg.load_path)
        vae.load_state_dict(from_jax_params(params))
        log.info(f"[ckpt] loaded {cfg.load_path} (extra keys: {list(extra)})")
    if cfg.eval:
        with torch.no_grad():
            return run_final_eval(cfg, vae, test_pool, log)
    train_pool, val_pool = pool(train_data), pool(val_data)
    log.info(f"[data] train batches {train_pool.num_batches} over buckets "
             f"{train_pool.lengths}")
    return run_training(cfg, vae, train_pool, val_pool, test_pool, log,
                        resume_state=extra if cfg.resume else None)


def train_image(cfg: ExperimentConfig, logger: Optional[Logger] = None,
                device="cuda") -> Dict:
    """``train_text`` for the OmniGlot model: the splits of
    ``load_omniglot(cfg.train_data)`` (the synthetic substitute, with a
    warning, when the file is missing), the image loss and the eval
    binarization."""
    dev = resolve_device(device)
    log = logger or Logger()
    train_imgs, val_imgs, test_imgs = load_omniglot(cfg.train_data)
    log.info(f"[data] omniglot train {len(train_imgs)} / val {len(val_imgs)} / "
             f"test {len(test_imgs)} images")
    test_pool = ImagePool(test_imgs, cfg.batch_size, dev)
    vae = build_image_vae(cfg, device=dev)
    eval_loss_fn = make_image_loss_fn(vae, nsamples=1, train=False)
    extra = {}
    if cfg.load_path:
        params, extra = load_checkpoint(cfg.load_path)
        vae.load_state_dict(from_jax_params(params))
        log.info(f"[ckpt] loaded {cfg.load_path} (extra keys: {list(extra)})")
    if cfg.eval:
        with torch.no_grad():
            return run_final_eval(cfg, vae, test_pool, log, eval_loss_fn=eval_loss_fn,
                                  prep=binarize_prep)
    return run_training(cfg, vae, ImagePool(train_imgs, cfg.batch_size, dev),
                        ImagePool(val_imgs, cfg.batch_size, dev), test_pool, log,
                        loss_fn=make_image_loss_fn(vae, nsamples=cfg.nsamples, train=True),
                        eval_loss_fn=eval_loss_fn, prep=binarize_prep,
                        resume_state=extra if cfg.resume else None)
