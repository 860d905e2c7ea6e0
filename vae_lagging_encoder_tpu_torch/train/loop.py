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

Also as there: the mid-epoch autosave (``--autosave_niter``: every N outer
steps the parameters, optimizer state, counters and epoch position are
written atomically to ``<save_path>.auto``, which ``--resume`` re-enters at
the next step; the epoch's metric record holds ``autosaves`` and their
``autosave_seconds``, state gathering and write) and ``--profile_dir`` (a ``torch.profiler`` trace of one
epoch, distilled into ``DOSSIER.md`` by utils/profiling.py). Not ported:
data and tensor parallelism, and the XLA dispatch knobs
``--epoch_segment`` / ``--loop_unroll`` (an epoch here is a host loop of
steps, logged every ``log_niter`` steps as the reference does).

Noise: ``run_training`` takes ``noise_for(stage, epoch) -> noise`` (see
train/epoch.py for the provider's sites) with stages ``"train"``,
``"val_mi"``, ``"val"``, ``"test"`` and ``"final"``. The default,
``make_noise_for``, seeds one generator per (stage, epoch) from the
config's seed, so a resumed run draws what the uninterrupted run would
have drawn from that epoch on; an autosave also carries the training
noise's generator states (``NOISE_STATE_KEY``), so a run resumed mid-epoch
draws what the uninterrupted run would have from that step on. A test can
replay the JAX package's keys. The autosave's ``mid_epoch`` record has the
JAX package's fields and meanings, so the port also reads the position and
counters of an autosave the JAX package wrote; lacking this package's
generator states, it continues from there on its own draws (and logs so).
"""
from __future__ import annotations

import math
import os
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
from .epoch import (GeneratorNoise, Noise, binarize_prep, make_au_fn, make_eval_fn,
                    make_image_loss_fn, make_iwnll_fn, make_mi_fn, make_train_epoch, unpack)
from .optim import state_from_tree, state_to_tree

NoiseFor = Callable[[str, int], Noise]
STAGES = ("train", "val_mi", "val", "test")
# the autosave's entry for the training noise's generator states
NOISE_STATE_KEY = "torch_noise_state"


def make_noise_for(seed: int, device) -> NoiseFor:
    """One generator per (stage, epoch), seeded from ``seed``; the final
    evaluation's is seeded with ``seed + 1`` as in a standalone ``--eval``."""

    def noise_for(stage: str, epoch: int) -> Noise:
        if stage == "final":
            return GeneratorNoise(seed + 1, device)
        return GeneratorNoise((seed * 8 + STAGES.index(stage)) * 100_003 + epoch, device)

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
        noise = GeneratorNoise(cfg.seed + 1, pool.arrays[0][0].device)
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


def _check_mid_epoch(mid: Dict, cfg: ExperimentConfig, num_batches: int, best_loss: float,
                     save_path: str) -> None:
    """The refusals of a mid-epoch resume (JAX ``run_training``'s): another
    ``--seed`` (the epoch's shuffle and the step offset would not match),
    another number of training batches, or a missing best-val checkpoint
    when one exists for the run (the rollback and the final evaluation
    need the best parameters, and the autosave holds the current ones)."""
    saved_seed = mid.get("seed")
    if saved_seed is not None and int(saved_seed) != int(cfg.seed):
        raise SystemExit(
            f"mid-epoch resume: autosave was written with --seed {int(saved_seed)} but this "
            f"run uses --seed {int(cfg.seed)} — the epoch shuffle would diverge and the "
            f"skipped-batch offset would be meaningless. Resume with the original seed.")
    saved_nb = mid.get("num_batches")
    if saved_nb is not None and int(saved_nb) != int(num_batches):
        raise SystemExit(
            f"mid-epoch resume: autosave expects {int(saved_nb)} train batches but the pool "
            f"has {num_batches} — the corpus or batching changed since the autosave; "
            f"mid-epoch positions don't transfer.")
    if math.isfinite(best_loss) and not os.path.exists(save_path):
        raise SystemExit(
            f"mid-epoch resume: a best-val checkpoint exists for this run (best_loss "
            f"{best_loss:.4f}) but {save_path!r} is missing — LR-decay rollback and the "
            f"final eval would silently use non-best params. Restore the best checkpoint "
            f"or pass its --save_path.")


def _write_dossier(cfg: ExperimentConfig, log: Logger, epoch: int, ran: int) -> None:
    """DOSSIER.md of the profiled epoch's trace; skipped (and logged) when
    the epoch ran no step or the trace has no device timeline."""
    from ..utils.profiling import write_dossier

    dossier_path = os.path.join(cfg.profile_dir, "DOSSIER.md")
    if ran <= 0:
        log.info("[profile] resumed epoch executed zero steps (autosave landed exactly at "
                 "the epoch boundary) — nothing to distill, dossier skipped")
        return
    summary = write_dossier(cfg.profile_dir, steps=ran, out_path=dossier_path,
                            title=f"Epoch-{epoch} profiler dossier ({cfg.dataset})")
    if summary is None:
        log.info("[profile] no device timeline in the trace (CPU runs emit none) — "
                 "dossier skipped")
        return
    top = summary["table"][0]
    log.info(f"[profile] dossier -> {dossier_path}: {summary['ms_per_step_device']:.2f} "
             f"ms/step device; top op {top['op']} ({top['category']}) "
             f"{top['pct_device']:.0f}%")


def run_training(cfg: ExperimentConfig, vae: VAE, train_pool: Pool, val_pool: Pool,
                 test_pool: Pool, log: Logger, loss_fn: Optional[Callable] = None,
                 eval_loss_fn: Optional[Callable] = None, prep: Callable = unpack,
                 resume_state: Optional[Dict] = None,
                 noise_for: Optional[NoiseFor] = None,
                 _stop_after_steps: Optional[int] = None) -> Dict:
    """The training lifecycle (module docstring); ``vae`` holds the initial
    (or loaded) parameters and ends holding the best ones. ``loss_fn``
    (training mode), ``eval_loss_fn`` and ``prep`` default to the text
    versions. Returns the final evaluation's results plus ``history``,
    ``best_val_loss``, ``save_path``. ``_stop_after_steps`` (a test hook)
    returns ``{"interrupted": True, ...}`` right after that many outer steps
    of this call, as a crash there would leave the run."""
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
    nb = train_pool.num_batches

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
    autosave_path = save_path + ".auto"
    mid = None
    if resume_state:
        kl_weight = np.float32(resume_state.get("kl_weight", kl_weight))
        lr = float(resume_state.get("lr", lr))
        aggressive = bool(resume_state.get("aggressive", aggressive))
        pre_mi = float(resume_state.get("pre_mi", pre_mi))
        best_loss = float(resume_state.get("best_loss",
                                           resume_state.get("val", {}).get("loss", best_loss)))
        decay_cnt = int(resume_state.get("decay_cnt", 0))
        not_improved = int(resume_state.get("not_improved", 0))
        mid = resume_state.get("mid_epoch")
        if mid:
            # an autosave: re-enter the SAME epoch at the step after the save
            start_epoch = int(mid["epoch"])
            _check_mid_epoch(mid, cfg, nb, best_loss, save_path)
            if math.isfinite(best_loss):
                best_params = {k: v.to(dev) for k, v in
                               from_jax_params(load_checkpoint(save_path)[0]).items()}
        else:
            start_epoch = int(resume_state.get("epoch", -1)) + 1
        if "opt_state" in resume_state:
            opt_state = state_from_tree(resume_state["opt_state"], dev)
        log.info(f"[resume] from epoch {start_epoch}"
                 + (f" step {int(mid['global_step'])}" if mid else "")
                 + f" (kl_weight {float(kl_weight):.4f}, lr {lr:.4f}, aggressive {aggressive})")
    rng = np.random.RandomState(cfg.seed)
    for _ in range(start_epoch):  # keep the shuffle stream aligned
        rng.permutation(nb)
    history = []
    log.info(f"[train] {cfg.epochs} epochs, {nb} batches/epoch, aggressive={aggressive}")

    global_step = start_epoch * nb
    steps_since_log = 0
    report = torch.zeros(5, device=dev)
    if mid:
        global_step = int(mid["global_step"])
        steps_since_log = int(mid.get("steps_since_log", 0))
        report = torch.tensor([float(x) for x in mid["report"]], device=dev)
    last_autosave = global_step
    steps_run = 0
    autosave_s = []  # this epoch's autosaves: seconds each, state gathering and write
    t_start = time.time()

    def on_step(i, kl_w, aux, opt_now, sums, inner_iters):
        nonlocal report, global_step, steps_since_log, last_autosave, steps_run
        report = report + aux
        global_step += 1
        steps_since_log += 1
        steps_run += 1
        if cfg.log_niter and steps_since_log >= cfg.log_niter:
            rl, rr, rk, rn, _ = report.tolist()
            rn = max(rn, 1.0)
            log.info(f"epoch {epoch}, iter {global_step}: avg_loss {rl / rn:.4f}, "
                     f"kl {rk / rn:.4f}, recon {rr / rn:.4f}, kl_weight "
                     f"{float(kl_w):.4f}, time {time.time() - t_start:.1f}s")
            report = torch.zeros(5, device=dev)
            steps_since_log = 0
        if cfg.autosave_niter and global_step - last_autosave >= cfg.autosave_niter:
            last_autosave = global_step
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # time the autosave, not the queued steps
            t_save = time.perf_counter()
            extra = {
                "opt_state": state_to_tree(opt_now),
                "epoch": epoch - 1, "kl_weight": float(kl_w), "lr": lr,
                "aggressive": aggressive, "pre_mi": pre_mi, "best_loss": best_loss,
                "decay_cnt": decay_cnt, "not_improved": not_improved, "dataset": cfg.dataset,
                "mid_epoch": {
                    "epoch": epoch, "seg": 1, "seed": int(cfg.seed), "num_batches": nb,
                    "next_start": i + 1, "sums": sums.tolist(),
                    "inner_iters": int(inner_iters), "report": report.tolist(),
                    "steps_since_log": steps_since_log, "global_step": global_step,
                },
            }
            if hasattr(noise, "get_state"):
                extra[NOISE_STATE_KEY] = noise.get_state()
            save_checkpoint(autosave_path, to_jax_params(vae.state_dict()), extra)
            autosave_s.append(time.perf_counter() - t_save)
            log.info(f"[autosave] step {global_step} -> {autosave_path} "
                     f"({autosave_s[-1]:.3f}s)")
        return _stop_after_steps is not None and steps_run >= _stop_after_steps

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        autosave_s.clear()
        order = rng.permutation(nb)
        was_aggressive = aggressive
        noise = noise_for("train", epoch)
        start, sums, inner0 = 0, None, 0
        resumed = bool(mid) and epoch == start_epoch
        if resumed:
            start, inner0 = int(mid["next_start"]), int(mid["inner_iters"])
            sums = torch.tensor([float(x) for x in mid["sums"]], device=dev)
            if NOISE_STATE_KEY in resume_state and hasattr(noise, "set_state"):
                noise.set_state(resume_state[NOISE_STATE_KEY])
            elif hasattr(noise, "set_state"):
                log.info(f"[resume] the autosave holds no generator state of this package "
                         f"(written by the JAX package?): epoch {epoch} continues from step "
                         f"{start} on this run's own draws")
        # the first epoch after epoch 0 (or the only epoch this run executes)
        profiler = None
        if cfg.profile_dir and epoch == max(start_epoch, min(1, cfg.epochs - 1)):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                             else [])
            profiler = profile(activities=acts)
            profiler.start()
        opt_state, kl_weight, sums, inner_iters = epoch_fn(
            opt_state, noise, kl_weight, lr, order, aggressive, on_step=on_step,
            start=start, sums=sums, inner_iters=inner0)
        if _stop_after_steps is not None and steps_run >= _stop_after_steps:
            if profiler is not None:
                profiler.stop()
            log.info(f"[stop] after {steps_run} steps (test hook)")
            return {"interrupted": True, "autosave_path": autosave_path,
                    "autosave_taken": os.path.exists(autosave_path)}
        loss_s, rec_s, kl_s, n_sent, n_words = sums.tolist()
        # a resumed epoch counts only the steps this process ran
        ran = nb - start + inner_iters - inner0
        if profiler is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            profiler.stop()
            os.makedirs(cfg.profile_dir, exist_ok=True)
            trace = os.path.join(cfg.profile_dir, f"epoch{epoch}.pt.trace.json.gz")
            profiler.export_chrome_trace(trace)
            log.info(f"[profile] trace for epoch {epoch} written to {trace}")
            _write_dossier(cfg, log, epoch, ran)
        dt = time.time() - t0
        log.info(f"epoch {epoch}: loss {loss_s / n_sent:.4f} "
                 f"rec {rec_s / n_sent:.4f} kl {kl_s / n_sent:.4f} "
                 f"kl_weight {float(kl_weight):.4f} inner_iters {inner_iters} "
                 f"({dt:.1f}s, {ran / max(dt, 1e-9):.1f} steps/s"
                 f"{' post-resume' if resumed else ''})")

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
                   steps_per_sec=ran / max(dt, 1e-9), autosaves=len(autosave_s),
                   autosave_seconds=sum(autosave_s))
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
