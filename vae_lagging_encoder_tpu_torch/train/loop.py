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
``autosave_seconds``, state gathering and write) and ``--profile_dir`` (a
``torch.profiler`` trace of one epoch, distilled into ``DOSSIER.md`` by
utils/profiling.py). An epoch runs in segments (``--epoch_segment``,
``pick_segment``): inside a segment the steps are replays of CUDA graphs
of the training step on the card (train/graphs.py), queued without a read
of the device; at its end the host reads the segment's sums, logs when
``log_niter`` steps have passed and autosaves when ``autosave_niter`` have,
so logs and autosaves fall on segment boundaries, and a mid-epoch resume
must re-enter on one. ``--loop_unroll`` is accepted with the JAX meaning
(a scheduling knob, bit for bit at any k) and each step stays one replay
(train/epoch.py). The epoch's metric record holds the graphs captured and
replayed in it. The JAX package's ``EVAL_SEGMENT`` has no counterpart: the
evaluators' sums stay on the device until one read at the end
(train/epoch.py), so there is no dispatch to bound.

Data and tensor parallelism (``--dp_devices D``, ``--tp_devices T``, D*T > 1):
``train_text`` / ``train_image`` start D*T ranks (parallel/launch.py) and
return rank 0's results; each rank loads the data, builds the model and
its ``Mesh`` and runs the same lifecycle with ``mesh=``: the training pool
keeps the rank's rows of every batch, gradients are summed over dp,
``dec.pred`` and its CE are vocab-sharded over tp (text only, the vocab
divisible by T), the evaluators split their pools by batch over dp.
Every host decision (the inner loop's stop, the MI switch-off, the best
checkpoint and LR decay, the early stop, ``_stop_after_steps``) reads
values that are the same on every rank. Rank 0 alone writes the log,
the checkpoints and the autosaves, with ``dec.pred`` and its moments
gathered dense (the files stay exchangeable with the JAX package's and
with one process's); an autosave carries every dp rank's noise state.
``--profile_dir`` profiles rank 0. A standalone ``--eval`` with T that
cannot shard the model (the image model, a vocab not divisible by T)
folds T into the batch-parallel axis, as the JAX package does.

Noise: ``run_training`` takes ``noise_for(stage, epoch) -> noise`` (see
train/epoch.py for the provider's sites) with stages ``"train"``,
``"val_mi"``, ``"val"``, ``"test"`` and ``"final"``. The default,
``make_noise_for``, seeds one provider per (stage, epoch) from the config's
seed (training: ``GeneratorNoise``, folded with the dp index under a mesh;
evaluation: ``IndexedNoise``, per batch), so a resumed run draws what the
uninterrupted run would have drawn from that epoch on; an autosave also
carries the training noise's generator states (``NOISE_STATE_KEY``), so a
run resumed mid-epoch draws what the uninterrupted run would have from that
step on. A test can replay the JAX package's keys. The autosave's
``mid_epoch`` record has the JAX package's fields and meanings, so the port
also reads the position and counters of an autosave the JAX package wrote;
lacking this package's generator states, it continues from there on its own
draws (and logs so).
"""
from __future__ import annotations

import functools
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import ExperimentConfig
from ..data import (BucketedPool, ImagePool, MonoTextData, Pool, ensure_synthetic_dataset,
                    load_omniglot)
from ..models import VAE, build_image_vae, build_text_vae
from ..ops.build import GRAPHS, resolve_device
from ..utils.exp_utils import Logger
from ..utils.jax_params import from_jax_params, to_jax_params
from .checkpoint import load_checkpoint, save_checkpoint
from .epoch import (GeneratorNoise, IndexedNoise, Noise, binarize_prep, make_au_fn,
                    make_eval_fn, make_image_loss_fn, make_iwnll_fn, make_mi_fn,
                    make_train_epoch, unpack)
from .optim import state_from_tree, state_to_tree

NoiseFor = Callable[[str, int], Noise]
STAGES = ("train", "val_mi", "val", "test")
# the autosave's entry for the training noise's generator states
NOISE_STATE_KEY = "torch_noise_state"


# Auto --epoch_segment (the JAX package's defaults, kept so that a command
# line segments alike in both): outer steps per segment while aggressive
# (each embeds up to burn_max_iters sub-iterations) and plain.
AGGRESSIVE_SEGMENT = 32
PLAIN_SEGMENT = 256


def pick_segment(cfg: ExperimentConfig, aggressive: bool, num_batches: int) -> int:
    """Outer steps per segment of one training epoch (the JAX package's
    rule). An explicit ``--epoch_segment`` N is capped by ``log_niter``, so
    that a log boundary comes at least every log_niter steps; 0 is the
    whole epoch (no cap). The default picks per mode: AGGRESSIVE_SEGMENT or
    PLAIN_SEGMENT (logs then come every segment). Every path is capped by
    ``--autosave_niter``: autosaves happen only at segment boundaries, so
    the crash-loss window always wins."""
    if cfg.epoch_segment is None:
        seg = AGGRESSIVE_SEGMENT if aggressive else PLAIN_SEGMENT
    else:
        seg = cfg.epoch_segment or num_batches
        if cfg.epoch_segment and cfg.log_niter:
            seg = min(seg, cfg.log_niter)
    if cfg.autosave_niter:
        seg = min(seg, cfg.autosave_niter)
    return max(1, min(seg, num_batches))


def make_noise_for(seed: int, device, fold: int = 0) -> NoiseFor:
    """One provider per (stage, epoch), seeded from ``seed``: training's a
    ``GeneratorNoise`` (``fold``: the dp index under a mesh), the
    evaluators' an ``IndexedNoise``; the final evaluation's is seeded with
    ``seed + 1`` as in a standalone ``--eval``."""

    def noise_for(stage: str, epoch: int) -> Noise:
        if stage == "final":
            return IndexedNoise(seed + 1, device)
        stage_seed = (seed * 8 + STAGES.index(stage)) * 100_003 + epoch
        if stage == "train":
            return GeneratorNoise(stage_seed, device, fold)
        return IndexedNoise(stage_seed, device)

    return noise_for


def check_layout(cfg: ExperimentConfig, image: bool, vocab: Optional[int] = None) -> None:
    """The refusals of a ``--dp_devices`` / ``--tp_devices`` training run
    (the JAX package's ``run_training``): the batch must divide over dp,
    tp shards the text decoder's projection only, and the vocab must
    divide over tp."""
    if cfg.batch_size % cfg.dp_devices:
        raise SystemExit(
            f"--batch_size {cfg.batch_size} must be divisible by "
            f"--dp_devices {cfg.dp_devices} (the batch dim is sharded "
            f"over the mesh; e.g. omniglot's default 50 needs 48 or 56 "
            f"on an 8-chip mesh)")
    if cfg.tp_devices > 1:
        if image:
            raise SystemExit(
                "--tp_devices shards the TEXT decoder's [nh, V] output "
                "projection; it does not apply to the image model")
        if vocab is not None and vocab % cfg.tp_devices:
            raise SystemExit(
                f"vocab size {vocab} must be divisible "
                f"by --tp_devices {cfg.tp_devices} (the projection is "
                f"column-sharded over the tp axis)")


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
                   prep: Callable = unpack, mesh=None) -> Dict:
    """ELBO decomposition, MI, AU, IW-NLL + PPL over ``pool``.

    ``noise`` (see train/epoch.py) defaults to an ``IndexedNoise`` seeded
    with ``cfg.seed + 1``, shared by the evaluators (their sites differ).
    ``eval_loss_fn`` and ``prep`` default to the text versions. Under a
    ``mesh`` every evaluator splits the pool by batch over dp, and with a
    tp group ELBO and IW-NLL take the vocab-sharded likelihood."""
    if cfg.iw_nsamples > cfg.iw_batch and cfg.iw_nsamples % cfg.iw_batch:
        raise SystemExit(
            f"--iw_nsamples {cfg.iw_nsamples} must be divisible by "
            f"--iw_batch {cfg.iw_batch} (the IW estimator runs in "
            f"iw_batch-sample chunks)")
    if noise is None:
        noise = IndexedNoise(cfg.seed + 1, pool.arrays[0][0].device)
    # each evaluator ends in one device->host read, so host-clock spans are
    # complete device spans
    t = [time.perf_counter()]
    elbo = make_eval_fn(vae, pool, loss_fn=eval_loss_fn, mesh=mesh)(noise)
    t.append(time.perf_counter())
    mi = make_mi_fn(vae, pool, prep=prep, mesh=mesh)(noise)
    t.append(time.perf_counter())
    au, _ = make_au_fn(vae, pool, prep=prep, mesh=mesh)(noise)
    t.append(time.perf_counter())
    iw = make_iwnll_fn(vae, pool, nsamples=cfg.iw_nsamples, ns=cfg.iw_batch, prep=prep,
                       mesh=mesh)(noise)
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


def _local(mesh, tree):
    """A dense state (parameters or optimizer state) as this rank holds it:
    the pred leaves cut to its vocab shard under tp."""
    if mesh is None or mesh.tp == 1:
        return tree
    from ..parallel.tp import shard_tree

    return shard_tree(mesh, tree)


def _dense(mesh, tree, vocab: int):
    """The inverse of ``_local``: a collective on every rank of a tp group."""
    if mesh is None or mesh.tp == 1:
        return tree
    from ..parallel.tp import gather_tree

    return gather_tree(mesh, tree, vocab)


def _noise_state(mesh, noise) -> Optional[Dict]:
    """The training noise's generator states for an autosave: one process's
    ``get_state()``; under a mesh the device generators of every dp rank,
    stacked ``[dp, L]`` (gathered with an all-reduce over dp), and the
    host generator (the same on every rank)."""
    if not hasattr(noise, "get_state"):
        return None
    st = noise.get_state()
    if mesh is None:
        return st
    from ..parallel.dp import all_reduce

    buf = torch.zeros((mesh.dp, len(st["device"])), dtype=torch.int32, device=mesh.device)
    buf[mesh.dp_index] = torch.from_numpy(st["device"].astype(np.int32)).to(mesh.device)
    all_reduce(buf, mesh.dp_group)
    return {"device": buf.cpu().numpy().astype(np.uint8), "host": st["host"]}


def _restore_noise(mesh, noise, state: Dict) -> None:
    """``set_state`` from an autosave's ``_noise_state``: this dp rank's row."""
    dev_state = np.asarray(state["device"], dtype=np.uint8)
    dp = 1 if mesh is None else mesh.dp
    rows = dev_state[None] if dev_state.ndim == 1 else dev_state
    if rows.shape[0] != dp:
        raise SystemExit(f"mid-epoch resume: the autosave holds the noise of {rows.shape[0]} "
                         f"dp ranks but this run has {dp} (--dp_devices); resume with the "
                         f"original --dp_devices.")
    noise.set_state({"device": rows[0 if mesh is None else mesh.dp_index],
                     "host": state["host"]})


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
                 noise_for: Optional[NoiseFor] = None, mesh=None,
                 _stop_after_steps: Optional[int] = None) -> Dict:
    """The training lifecycle (module docstring); ``vae`` holds the initial
    (or loaded) parameters and ends holding the best ones (under tp, its
    vocab shard of ``dec.pred``). ``loss_fn`` (training mode),
    ``eval_loss_fn`` and ``prep`` default to the text versions. With a
    ``mesh`` (parallel/dp.py; this process one of its ranks) the lifecycle
    runs data- and tensor-parallel (module docstring): the training pool
    is sharded and the model's ``dec.pred`` cut to this rank's shard here.
    Returns the final evaluation's results plus ``history``,
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
    vocab = getattr(vae.dec, "vocab_size", 0)
    lead = mesh is None or mesh.rank == 0  # writes the checkpoints and autosaves
    if mesh is not None or cfg.dp_devices * cfg.tp_devices > 1:
        check_layout(cfg, image=loss_fn is not None or not vocab, vocab=vocab)
    if mesh is not None:
        if mesh.tp > 1:
            from ..parallel.tp import shard_model

            shard_model(mesh, vae)
        train_pool.shard(mesh)
        log.info(f"[parallel] {'DPxTP' if mesh.tp > 1 else 'DP'} over {mesh.world} ranks "
                 f"(dp {mesh.dp} x tp {mesh.tp}), backend {dist.get_backend()}, rank 0 on "
                 f"{dev}; pool batch-sharded"
                 + (f"; dec.pred vocab-sharded /{mesh.tp}" if mesh.tp > 1 else ""))
    same = mesh.same if mesh is not None else (lambda values: [float(v) for v in values])
    noise_for = noise_for or make_noise_for(cfg.seed, dev, 0 if mesh is None else mesh.dp_index)
    epoch_fn, opt_init = make_train_epoch(vae, train_pool, cfg, loss_fn=loss_fn, mesh=mesh)
    opt_state = opt_init()
    off = epoch_fn.steps.off
    log.info("[graphs] " + (f"off: {off}" if off else
                            "on: each training step replays a captured CUDA graph"))
    val_eval = make_eval_fn(vae, val_pool, loss_fn=eval_loss_fn, mesh=mesh)
    val_mi = make_mi_fn(vae, val_pool, prep=prep, mesh=mesh)
    test_eval = make_eval_fn(vae, test_pool, loss_fn=eval_loss_fn, mesh=mesh)
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
                best_params = _local(mesh, {k: v.to(dev) for k, v in
                                            from_jax_params(load_checkpoint(save_path)[0]).items()})
        else:
            start_epoch = int(resume_state.get("epoch", -1)) + 1
        if "opt_state" in resume_state:
            opt_state = _local(mesh, state_from_tree(resume_state["opt_state"], dev))
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
    report = [0.0] * 5
    if mid:
        global_step = int(mid["global_step"])
        steps_since_log = int(mid.get("steps_since_log", 0))
        report = [float(x) for x in mid["report"]]
    last_autosave = global_step
    steps_run = 0
    autosave_s = []  # this epoch's autosaves: seconds each, state gathering and write
    t_start = time.time()

    def on_segment(end, n, kl_w, seg_sums, opt_now, sums, inner_iters):
        nonlocal report, global_step, steps_since_log, last_autosave
        report = [a + b for a, b in zip(report, seg_sums)]
        global_step += n
        steps_since_log += n
        if cfg.log_niter and steps_since_log >= cfg.log_niter:
            rl, rr, rk, rn, _ = report
            rn = max(rn, 1.0)
            log.info(f"epoch {epoch}, iter {global_step}: avg_loss {rl / rn:.4f}, "
                     f"kl {rk / rn:.4f}, recon {rr / rn:.4f}, kl_weight "
                     f"{float(kl_w):.4f}, time {time.time() - t_start:.1f}s")
            report = [0.0] * 5
            steps_since_log = 0
        if cfg.autosave_niter and global_step - last_autosave >= cfg.autosave_niter:
            last_autosave = global_step
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # time the autosave, not the queued steps
            t_save = time.perf_counter()
            params_now = _dense(mesh, vae.state_dict(), vocab)  # collectives: every rank
            opt_dense = _dense(mesh, opt_now, vocab)
            noise_state = _noise_state(mesh, noise)
            extra = {
                "opt_state": state_to_tree(opt_dense),
                "epoch": epoch - 1, "kl_weight": float(kl_w), "lr": lr,
                "aggressive": aggressive, "pre_mi": pre_mi, "best_loss": best_loss,
                "decay_cnt": decay_cnt, "not_improved": not_improved, "dataset": cfg.dataset,
                "mid_epoch": {
                    "epoch": epoch, "seg": seg, "seed": int(cfg.seed), "num_batches": nb,
                    "next_start": end, "sums": list(sums),
                    "inner_iters": int(inner_iters), "report": list(report),
                    "steps_since_log": steps_since_log, "global_step": global_step,
                },
            }
            if noise_state is not None:
                extra[NOISE_STATE_KEY] = noise_state
            if lead:
                save_checkpoint(autosave_path, to_jax_params(params_now), extra)
            autosave_s.append(time.perf_counter() - t_save)
            log.info(f"[autosave] step {global_step} -> {autosave_path} "
                     f"({autosave_s[-1]:.3f}s)")

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        autosave_s.clear()
        # recomputed per epoch: the auto default depends on the aggressive
        # flag, which the MI plateau turns off for good
        seg = pick_segment(cfg, aggressive, nb)
        order = rng.permutation(nb)
        was_aggressive = aggressive
        noise = noise_for("train", epoch)
        start, sums, inner0 = 0, None, 0
        resumed = bool(mid) and epoch == start_epoch
        if resumed:
            start, inner0 = int(mid["next_start"]), int(mid["inner_iters"])
            sums = [float(x) for x in mid["sums"]]
            # the skip is by batch offset: the segment grid must line up with
            # the autosave's, else batches would be skipped or run twice
            if start % seg != 0 and start != nb:
                raise SystemExit(
                    f"mid-epoch resume: autosave position {start} is not a boundary of "
                    f"the current segmentation (seg={seg}; autosave was written with "
                    f"seg={mid.get('seg', '?')}) — resume with the same "
                    f"--epoch_segment/--log_niter as the saved run.")
            if NOISE_STATE_KEY in resume_state and hasattr(noise, "set_state"):
                _restore_noise(mesh, noise, resume_state[NOISE_STATE_KEY])
            elif hasattr(noise, "set_state"):
                log.info(f"[resume] the autosave holds no generator state of this package "
                         f"(written by the JAX package?): epoch {epoch} continues from step "
                         f"{start} on this run's own draws")
        # the first epoch after epoch 0 (or the only epoch this run executes)
        profiler = None
        if lead and cfg.profile_dir and epoch == max(start_epoch, min(1, cfg.epochs - 1)):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                             else [])
            profiler = profile(activities=acts)
            profiler.start()
        budget = None if _stop_after_steps is None else _stop_after_steps - steps_run
        graphs0 = dict(GRAPHS)
        opt_state, kl_weight, sums, inner_iters = epoch_fn(
            opt_state, noise, kl_weight, lr, order, aggressive, seg=seg,
            on_segment=on_segment, start=start, sums=sums, inner_iters=inner0,
            max_steps=budget)
        steps_run += nb - start if budget is None else min(nb - start, budget)
        if _stop_after_steps is not None and steps_run >= _stop_after_steps:
            if profiler is not None:
                profiler.stop()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            log.info(f"[stop] after {steps_run} steps (test hook)")
            log.metric(split="stopped", epoch=epoch, steps=steps_run,
                       inner_iters=inner_iters - inner0, seconds=time.time() - t0)
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
                (cur_mi,) = same([val_mi(noise_for("val_mi", epoch))])
            log.info(f"epoch {epoch}: val MI {cur_mi:.4f} (prev {pre_mi:.4f})")
            if cur_mi < pre_mi:
                aggressive = False
                log.info(f"epoch {epoch}: MI plateau — aggressive OFF permanently")
            pre_mi = cur_mi

        # --- validation ELBO + best checkpoint + LR plateau decay -------
        with torch.no_grad():
            val = val_eval(noise_for("val", epoch))
        (val["loss"],) = same([val["loss"]])
        log.info(f"epoch {epoch}: VAL loss {val['loss']:.4f} rec {val['rec']:.4f} "
                 f"kl {val['kl']:.4f} nll {val['nll']:.4f} ppl {val['ppl']:.2f}")
        log.metric(epoch=epoch, train_loss=loss_s / n_sent, val_loss=val["loss"],
                   val_kl=val["kl"], kl_weight=float(kl_weight), lr=lr,
                   inner_iters=inner_iters, aggressive=aggressive,
                   epoch_aggressive=was_aggressive, epoch_seconds=dt,
                   steps_per_sec=ran / max(dt, 1e-9), autosaves=len(autosave_s),
                   autosave_seconds=sum(autosave_s), segment=seg,
                   graphs_captured=GRAPHS["captured"] - graphs0["captured"],
                   graph_replays=GRAPHS["replays"] - graphs0["replays"])
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
            best_dense = _dense(mesh, best_params, vocab)  # collectives: every rank
            opt_dense = _dense(mesh, opt_state, vocab)
            if lead:
                save_checkpoint(save_path, to_jax_params(best_dense), {
                    "opt_state": state_to_tree(opt_dense),
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
                                 eval_loss_fn=eval_loss_fn, prep=prep, mesh=mesh)
    results["history"] = history
    results["best_val_loss"] = best_loss
    results["save_path"] = save_path
    return results


def train_text(cfg: ExperimentConfig, logger: Optional[Logger] = None,
               device="cuda") -> Dict:
    """``cfg.eval``: the final evaluation of ``cfg.load_path`` (or of the
    seeded initial model when no checkpoint is given); otherwise training
    (``run_training``) from the seeded initial model or, with ``--resume``,
    from ``cfg.load_path`` and its saved state. With ``cfg.dp_devices *
    cfg.tp_devices > 1`` in that many ranks (``run_parallel``)."""
    log = logger or Logger()
    if cfg.dp_devices * cfg.tp_devices > 1:
        return run_parallel(_train_text, cfg, log, device)
    return _train_text(resolve_device(device), cfg, log)


def _train_text(dev, cfg: ExperimentConfig, log: Logger, parallel: bool = False,
                run: Optional[Callable] = None) -> Dict:
    """``train_text`` in one process or, with ``parallel``, in one rank."""
    train_data, val_data, test_data = load_text_datasets(cfg)
    log.info(f"[data] train {len(train_data)} / val {len(val_data)} / "
             f"test {len(test_data)} sentences, vocab {len(train_data.vocab)}")

    def pool(d):
        return BucketedPool(d.create_data_batch(cfg.batch_size, cfg.length_buckets), dev)

    test_pool = pool(test_data)
    vae = build_text_vae(cfg, len(train_data.vocab), device=dev)
    extra = _load(cfg, vae, log)
    mesh = _make_mesh(cfg, dev, log, len(train_data.vocab) % cfg.tp_devices == 0) \
        if parallel else None
    if cfg.eval:
        if mesh is not None and mesh.tp > 1:
            from ..parallel.tp import shard_model

            shard_model(mesh, vae)
        with torch.no_grad():
            return run_final_eval(cfg, vae, test_pool, log, mesh=mesh)
    train_pool, val_pool = pool(train_data), pool(val_data)
    log.info(f"[data] train batches {train_pool.num_batches} over buckets "
             f"{train_pool.lengths}")
    return (run or run_training)(cfg, vae, train_pool, val_pool, test_pool, log,
                                 resume_state=extra if cfg.resume else None, mesh=mesh)


def train_image(cfg: ExperimentConfig, logger: Optional[Logger] = None,
                device="cuda") -> Dict:
    """``train_text`` for the OmniGlot model: the splits of
    ``load_omniglot(cfg.train_data)`` (the synthetic substitute, with a
    warning, when the file is missing), the image loss and the eval
    binarization. ``--tp_devices`` trains no image model (its refusal is
    the JAX package's); a standalone ``--eval`` folds it into dp."""
    log = logger or Logger()
    if cfg.dp_devices * cfg.tp_devices > 1:
        return run_parallel(_train_image, cfg, log, device)
    return _train_image(resolve_device(device), cfg, log)


def _train_image(dev, cfg: ExperimentConfig, log: Logger, parallel: bool = False,
                 run: Optional[Callable] = None) -> Dict:
    """``train_image`` in one process or, with ``parallel``, in one rank."""
    train_imgs, val_imgs, test_imgs = load_omniglot(cfg.train_data)
    log.info(f"[data] omniglot train {len(train_imgs)} / val {len(val_imgs)} / "
             f"test {len(test_imgs)} images")
    test_pool = ImagePool(test_imgs, cfg.batch_size, dev)
    vae = build_image_vae(cfg, device=dev)
    eval_loss_fn = make_image_loss_fn(vae, nsamples=1, train=False)
    extra = _load(cfg, vae, log)
    mesh = _make_mesh(cfg, dev, log, shardable=False) if parallel else None
    if cfg.eval:
        with torch.no_grad():
            return run_final_eval(cfg, vae, test_pool, log, eval_loss_fn=eval_loss_fn,
                                  prep=binarize_prep, mesh=mesh)
    return (run or run_training)(
        cfg, vae, ImagePool(train_imgs, cfg.batch_size, dev),
        ImagePool(val_imgs, cfg.batch_size, dev), test_pool, log,
        loss_fn=make_image_loss_fn(vae, nsamples=cfg.nsamples, train=True),
        eval_loss_fn=eval_loss_fn, prep=binarize_prep,
        resume_state=extra if cfg.resume else None, mesh=mesh)


def _load(cfg: ExperimentConfig, vae: VAE, log: Logger) -> Dict:
    """Load ``cfg.load_path`` into ``vae`` (when given); its extra state."""
    if not cfg.load_path:
        return {}
    params, extra = load_checkpoint(cfg.load_path)
    vae.load_state_dict(from_jax_params(params))
    log.info(f"[ckpt] loaded {cfg.load_path} (extra keys: {list(extra)})")
    return extra


def _make_mesh(cfg: ExperimentConfig, dev, log: Logger, shardable: bool):
    """This rank's mesh: ``dp_devices x tp_devices``; for a standalone
    ``--eval`` whose model the tp ranks cannot shard (the image model, a
    vocab not divisible by T), ``dp_devices * tp_devices`` batch-parallel
    ranks (the JAX package's ``run_final_eval`` folds them likewise)."""
    from ..parallel.dp import make_tp_mesh

    dp, tp = cfg.dp_devices, cfg.tp_devices
    if cfg.eval and tp > 1 and not shardable:
        log.info(f"[parallel] eval-only run: folding --tp_devices {tp} into the "
                 f"batch-parallel axis (model not vocab-shardable)")
        return make_tp_mesh(dp * tp, 1, dev)
    if cfg.eval:
        log.info(f"[parallel] eval-only run: {dp} x {tp} ranks"
                 + (", dec.pred vocab-sharded" if tp > 1 else ""))
    return make_tp_mesh(dp, tp, dev)


def _rank_main(dev, body: Callable, cfg: ExperimentConfig, log_path: Optional[str],
               quiet: bool, run_kwargs: Dict) -> Dict:
    """A rank of ``run_parallel``: ``body(dev, cfg, log, parallel=True,
    run=...)`` with ``run_training(..., **run_kwargs)``, rank 0 logging to
    ``log_path``, the others silent."""
    lead = dist.get_rank() == 0
    with Logger(log_path if lead else None, quiet=quiet or not lead) as log:
        return body(dev, cfg, log, parallel=True,
                    run=functools.partial(run_training, **run_kwargs))


def run_parallel(body: Callable, cfg: ExperimentConfig, log: Logger, device) -> Dict:
    """``body`` (``_train_text`` or ``_train_image``) in ``cfg.dp_devices *
    cfg.tp_devices`` ranks (parallel/launch.py): rank 0's result; each
    rank's device, backend, kernel launches, peak device memory and seconds
    go on a ``split="ranks"`` metric record. The refusals of
    ``check_layout`` that need no data come first, in this process, and the
    synthetic corpus is written here, before the ranks read it. Where this
    module holds a ``functools.partial`` of ``run_training`` at the call (a
    test's, with ``_stop_after_steps``), the ranks run ``run_training`` with
    its keywords."""
    from ..parallel.launch import run_ranks

    if not cfg.eval:
        check_layout(cfg, image=cfg.model_type == "image")
    if cfg.dataset == "synthetic":
        ensure_synthetic_dataset()
    outcomes = run_ranks(_rank_main, cfg.dp_devices * cfg.tp_devices, device,
                         args=(body, cfg, getattr(log, "log_path", None),
                               getattr(log, "quiet", False),
                               run_training.keywords
                               if isinstance(run_training, functools.partial) else {}))
    log.metric(split="ranks", ranks=[
        {"rank": o.rank, "device": o.device, "backend": o.backend, "launches": o.launches,
         "max_memory_allocated": o.max_memory_allocated, "seconds": o.seconds}
        for o in outcomes])
    return outcomes[0].result
