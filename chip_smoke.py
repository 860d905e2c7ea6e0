#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. device and build: prints the card and its power limit, builds the CUDA
   kernels from ``vae_lagging_encoder_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and prints each tensor-core kernel's registers,
   spills and its count of tensor-core (HMMA: mma.sync, HGMMA: wgmma) and
   asynchronous-copy (LDGSTS: cp.async; UTMALDG, UBLKCP: TMA) instructions
   from the build logs; a tensor-core source without both fails the run,
   and so do ``lstm_infer`` and ``lstm_bwd`` without a wide-row kernel,
   and ``ce_bwd`` without a product kernel, that has both HGMMA and UTMALDG,
   and ``lstm_infer`` and ``lstm_bwd`` without a narrow-row kernel that has
   both HMMA and UBLKCP, and ``lstm_f32`` without FFMA and UTMALDG (or with a
   tensor-core instruction) in both its kernels, and ``ce_f32`` so in both
   modes of its kernel, or with local-memory spills; then it builds
   ``lstm_ablation.py``'s empty-step copies of the kernels that the 32- and
   20-row plans run and of the f32 kernels (the floor below);
2. kernel checks at the Yahoo shapes of the evaluation and the training
   paths: each kernel against its plain PyTorch version on the card, in
   bf16 and f32 operand mode, with timings (CUDA events), the plain
   version's and a library call's time, and the least time the card could
   take (``bound_ms``); the forward without residuals also at the
   encoder's 32 rows (``*_rows32``), the residual-saving forward and the
   backward also at a short last batch of 20 (``*_b20``), the CE also at a
   ragged N and at the training shape's split plan (``*_n1000``,
   ``*_n3040``); the shapes of ``--nsamples 40`` training, a decoder chunk
   of 20 samples x 32 sentences: the residual-saving forward and the
   backward at 640 rows (``*_rows640``), the grad-mode CE at N 60800
   (``*_n60800``, a 2.4 GB bf16 spill); the three LSTM kernels also at a
   ragged 600 rows (``err_*_rows600``, untimed); the CE backward (dh and dW
   on the grad-mode residuals) at N 3040, 1000 and 60800, each twice (equal
   bits), with its kernels' device times (``kernel_ms``) and its extra peak
   memory beside the plain version's; the mma.sync LSTM kernels, which
   serve the rows between the narrow and the wide plans, through the
   wrappers at 96 rows (forwards) and 64 (backward) and under their own
   plan at 32 rows, timed there beside the narrow kernels, each twice
   (``*_mma_rows96``, ``*_mma_rows64``, ``*_mma_rows32``). Each LSTM kernel's
   launch plans print with their bf16 operand bytes a step into each SM
   and from L2 (``plan*``, ``sm_bytes_per_step*``, ``l2_bytes_per_step*``;
   ``*_mma_rows640`` and ``*_mma_rows32``: the mma.sync plan at 640 and 32
   rows, for comparison), and below the wide path each timed shape its
   empty-step floor (``floor_ms*``: the kernel's step reduced to the
   barrier and the operand exchange, ``lstm_ablation.py``'s "empty_step"
   copy timed under the same plan; T times its step is the least the
   design reaches).
   Library yardsticks compute what the kernel computes and
   are timed in turns with it (library, port, port, library;
   ``*_turns``): cuDNN's training forward for the residual-saving forward,
   the library's forward alone for the grad-mode CE (its forward and
   backward beside ``FusedCEFn``'s), for the CE backward d by torch ops and
   two bf16 ``torch.mm`` with f32 output, and, for the LSTM backward, the
   port's whole backward of the layer (``port_bwd_ms``) against cuDNN's.
   Then the f32-wh route (``csrc/lstm_f32.cu``; ``check_f32``): its three
   kernels at ``F32_SHAPES`` (H 512 at 32, 20, 600 and 640 rows, H 128, H
   50, H 1024), each against its plain version, twice (equal bits), with
   ``ms``, ``kernel_ms``, the plain version's, cuDNN's f32 LSTM with TF32
   off in turns, the bound at the f32 rate (``PEAK_F32``) and the empty-step
   floor (``{"f32_check"}`` lines); and the CE with f32 operands
   (``csrc/ce_f32.cu``'s ``ce_f32_kernel``, on no model path) in both modes
   at N 3040, 60800 and 1000 against its plain version, twice (equal bits),
   timed at N 3040 and 60800 with its kernels' device ms and its plan
   beside the f32 library forward in turns and the bound at the f32 rate
   (``{"ce_f32_check"}`` lines);
3. the evaluation slice end to end through the normal entry point: a
   Yahoo-shaped corpus and a Yahoo-width random model (seeded) are written
   to a temporary directory, ``cli.text.main([... "--eval" ...])`` runs the
   final evaluation (ELBO, MI, AU, 500-sample IW-NLL), the launch counters
   show the kernels ran, and one test batch is cross-checked against the
   plain versions at reduced ``iw_nsamples`` on the same injected noise;
   one IW-NLL batch then runs under ``torch.profiler``: the top device ops
   and the device's idle share go on a ``{"trace_iw": ...}`` line (a
   failure there is printed, not raised);
4. the training slice end to end through the same entry point, without
   ``--eval``: ``--epochs 2 --aggressive 1`` at Yahoo width on an 8-batch
   training split (vocabulary exactly 20004), then one plain epoch; the
   launch counters must equal 2 LSTM forwards, 2 LSTM backwards and 1
   grad-mode CE per forward+backward plus the evaluation's launches; plain
   and aggressive steps/s are printed and the best checkpoint is loaded
   back; then one training step's loss and every gradient are cross-checked
   against the plain versions on the same eps and dropout draws, and three
   forward+backward steps run under ``torch.profiler``: the top device
   ops and the device's idle share go on a ``{"trace": ...}`` line (a
   failure there is printed, not raised);
5. the image slice end to end through ``cli.image.main`` at the full
   OmniGlot config (B 50, ResNet encoder (64, 64, 64), PixelCNN 8 x 64 with
   a 7x7 first kernel, nz 32, Adam 1e-3): a synthetic-substitute ``.npz``
   (400 training images, 8 batches; 100 validation, 200 test), ``--epochs 2
   --aggressive 1 --warm_up 1 --kl_start 0.1``, then one plain epoch, then
   ``--eval`` of the best checkpoint at the default 500/100 IW; results
   finite, AU in [0, 32], the checkpoints load strictly, no kernel of the
   text path launched; one training batch's loss and gradients and a
   16-image IW-NLL at 30 samples on the card against the port's CPU f32
   path (tolerances stated there); three training steps and one IW batch
   under ``torch.profiler``. The convs are cuDNN's (no hand-written kernel
   is owed on this path: the JAX package's are XLA convs, not Pallas).
   The precision flags stay at PyTorch's defaults, as the CLI runs them;
6. generation and the toy probe through the CLIs: (a) ``cli.text.main``
   with ``--sample_from_prior`` (greedy, sample, beam; 32 sentences, at most
   100 tokens) and ``--reconstruct`` (greedy, beam; the 96 sentences of
   phase 3's test split) on phase 4's best checkpoint, line and launch counts
   checked (the encoder's ``lstm_fwd_infer`` once per reconstructed batch,
   nothing else), then greedy, sample and beam decoding on the card against
   the port's CPU path on the same z and Gumbel draws, tolerant of
   near-ties (``GEN_TOL``), on phase 4's weights and on phase 3's random
   ones times 10; (b) ``cli.image.main`` with
   ``--sample_from_prior`` and ``--reconstruct`` (50 images each) on phase
   5's best checkpoint, the PNGs' sizes checked, then the sampled canvas
   teacher-forced through the incremental sampler against the dense logits
   on the card and on the CPU (``IMG_LOGIT_TOL``), and the dense sampler
   on 4 images against the fast one on the same uniforms; (c) the synthetic
   corpus written by the port's ``ensure_synthetic_dataset`` into the
   temporary directory, then ``cli.toy.main`` with ``--aggressive 0`` and
   ``1`` (2 epochs on 96 training sentences, 96 probe sentences), the
   pickles read back and their epoch -1 pairs held against the CPU path;
7. the rest of the single-card training lifecycle through ``cli.text`` at
   the Yahoo width, on phase 4's corpus, from phase 3's random model: (a)
   ``--epochs 2 --aggressive 1 --autosave_niter 4``, uninterrupted; the
   same run stopped by ``run_training``'s ``_stop_after_steps`` hook after
   14 steps (epoch 1; the last autosave, step 12, two steps behind) and
   resumed with ``--resume --load_path <save_path>.auto``; then resumed
   again from the autosave that run wrote at the end of epoch 1, with
   ``--profile_dir`` (an epoch of 0 steps: trace, no dossier); every epoch
   metric, final result and parameter against the uninterrupted run's,
   within RESUME_BOUND (autosave every 4 steps rather than 3, so that an
   autosave lands on the epoch's end); (b) one plain epoch of
   ``--nsamples 40``: launch counts (per step the encoder's forward and
   backward, and per chunk the forward, its recompute and the backward),
   steps/s, peak memory, and one step's loss and gradients against the
   plain versions on the card; (c) ``--profile_dir`` on one plain epoch:
   ``DOSSIER.md`` with the epoch's 8 steps and the port's training kernels
   among its top ops; (d) phase 3's model exported as the reference's
   ``torch.save`` state_dict and as a legacy round-1 pickle, each through
   ``--eval --load_path``: the numbers of phase 3's evaluation of the
   ``.npz``; ref.pt -> .npz -> ref2.pt through ``torch_import.main``, bit
   for bit; (e) ``docs_english`` built from this machine's site-packages by
   the port's ``python -m vae_lagging_encoder_tpu_torch.data.english``, cut
   to 2200 documents, and one plain epoch on the longest prefix of its
   training split that makes at most 8 batches;
8. data and tensor parallelism on the one card: two ranks share it over
   ``gloo`` (NCCL refuses two ranks on one card), started by the port's
   launcher. First one start of the ranks checks (a) one outer DP step of
   the Yahoo-width model (16 rows a rank, dropout on) against the port's
   single-process emulated-DP oracle on the card (``DP_STEP_TOL``) and
   times one flat all-reduce of its 216 MB gradient, (b)
   ``tp_token_logp`` forward and backward at N 3040, V 20004 (two shards of
   10002) against ``ce_logp_plain`` in f32, (c) one outer DP step of the
   OmniGlot model (25 rows a rank) on its all-reduced gradient against the
   oracle's (``IMG_DP_GRAD_TOL``). Then through the CLIs on phase 4's
   corpus: (a) ``cli.text --dp_devices 2``, an aggressive stretch stopped
   after a few outer steps (sized from the all-reduce time) and a plain
   epoch with the final suite at 500/100, every rank's training launches
   counted per forward+backward; (b) ``--dp_devices 1 --tp_devices 2``, a
   plain epoch, and ``--eval`` of phase 4's checkpoint at 500/100 against
   its dense evaluation (``TP_EVAL_RTOL``; no CE kernel runs on the TP
   path, the LSTM kernels do); (c) ``cli.image --dp_devices 2``, one
   aggressive epoch on phase 5's cut;
9. the training epoch as CUDA-graph replays (train/graphs.py; phases 4, 5
   and 7 already train this way, the card's default): through
   ``make_train_epoch`` at full width, the Yahoo-config text model on phase
   4's corpus and the OmniGlot model on phase 5's cut, plain and
   aggressive, and the text model on a corpus over all ten Yahoo length
   buckets (16-512: a graph per mode and bucket), each the same windows of
   steps graphed and eager (``graphs=False``) from the same seeded weights,
   orders and noise: steps/s, the idle share and the host's launch calls a
   step (from a profiled window), kernel launches and graph replays a step,
   graphs captured, eager warm-up steps, capture seconds and peak memory;
   every parameter against the eager run's (``GRAPH_PARAM_TOL``; expected
   0.0), the kernel launches against ``step_launches``, and in each
   profiled window the port's kernels counted by name among the device
   events against the ``LAUNCHES`` the window added. The image convs:
   which cuDNN products (forward, input and weight gradient) differ from
   run to run under cuDNN's default algorithms, at the shapes of one
   training step, with their times with and without the deterministic
   ones; and the graphed image plain windows once more with cuDNN's default
   algorithms in the convs' backward too, for the device time a step that
   the restriction (``ops/conv.py``) costs;
10. the Yahoo model narrowed to ``--enc_nh 512 --dec_nh 512`` (f32 compute,
   the kernel route: every LSTM launch is the f32 kernels') through
   ``cli.text`` on phase 4's corpus: an aggressive and a plain epoch
   (graphed), four ``--nsamples 40`` steps (640 LSTM rows a decoder chunk),
   ``--eval`` at IW 500/100 over 48 sentences; then phase 9's steady
   windows at this width, plain and aggressive, graphed against eager bit
   for bit, every profiled window's LSTM launches traced as the f32
   kernels; a ``{"h512"}`` line (steps/s, IW sentences/s, launches).

Prints one JSON line per kernel, ``{"trace_iw": ...}``, ``{"trace": ...}``,
``{"image": ...}`` (steps/s, IW images/s, per-evaluator seconds, peak
device memory), ``{"image_cross_check": ...}``, ``{"trace_image": ...}``,
``{"trace_image_iw": ...}``, ``{"generate": ...}`` (sentences/s,
images/s, the cross-checks, the toy's seconds per probe and per epoch) and
``{"lifecycle": ...}`` (phase 7), ``{"parallel": ...}`` (phase 8: each
run's backend, world size, steps/s, peak memory and kernel launches per
rank, the all-reduce time, the checks) and ``{"graphs": ...}`` (phase 9)
lines, a ``{"kernels": [...]}`` line (its ``launches_by_path`` with the
image, generation, toy, phase 7 paths', the ``dp`` / ``tp`` ranks' and
phase 9's ``graphs`` counts; the f32 kernels' entries, ``*_f32``, count
phase 10's launches; the f32-operand CE's entry, ``ce_f32``, on no model
path, counts none), a ``{"ce_f32"}`` line, the card's name and power
limit, and as the last line ``{"ok": true,
"device": {...}}``. Exits non-zero, printing no result, when no CUDA
device is available or the port's package is missing.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor-core rate
# (the main path's operands are bf16) and HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# Yahoo config widths (config/base.py) and the IW decoder's row count
NI, NH, NZ, B, VOCAB = 512, 1024, 32, 32, 20004
IW_CHUNK = 20
T_CHECK = 96  # the bucket length of a typical Yahoo sentence (~80 words + <s>, </s>)

# Tolerances of the kernel-vs-plain checks (max abs error).
# f32 operands: only the order of f32 accumulation differs; over ~96
#   recurrent steps the LSTM's differences stay ~1e-5, the CE's (one 1024-long
#   dot + one 20k-long logsumexp) ~1e-5.
# bf16 operands: both sides round the same inputs to bf16, so the products
#   are exact and only accumulation order differs — but the LSTM feeds h_t
#   back rounded to bf16, so a last-bit difference in h_t can flip a bf16
#   rounding at the next step; 2e-3 leaves room for that over 96 steps.
TOL = {("lstm", "f32"): 1e-4, ("lstm", "bf16"): 2e-3,
       ("ce", "f32"): 1e-4, ("ce", "bf16"): 1e-3,
       # LSTM backward at T 96, B 32, H 1024 (gates from the same forward on
       # both sides): f32 differs in summation order only (3e-7 on da values
       # up to 1.5 when the plain sweep's product runs in f64 instead of f32,
       # on the CPU); bf16 rounds da before the product, so a last-bit
       # difference flips a rounding that the carry takes back through the
       # remaining steps (6e-5 in the same experiment): ~10x that.
       ("lstm_bwd", "f32"): 1e-5, ("lstm_bwd", "bf16"): 5e-4,
       # grad-mode CE: logp and lse as the forward CE; the spill is held
       # separately, within one bf16 step of each element (see check_ce_train)
       ("ce_train", "f32"): 1e-4, ("ce_train", "bf16"): 1e-3}
# CE backward: dh and dW are held apart, each at ``ce_bwd_tol`` (no TOL
# entry). Both sides form d by the same f32 operations from the same spill,
# so the products' bf16 operands are equal. The plain products round every
# f32 sum; the tensor cores' f32 accumulation does not round as they do, and
# its difference grows with the K / 16 steps of a sum (K = Vp for dh, N for
# dW): one unit in the last place of the output's largest value (2^-23 of
# it) a step, plus CE_BWD_TOL_FLOOR for the plain side's own rounding (as
# tests/test_torch_port_cuda.py::_acc_bound). At N 3040 that is ~1.5e-4 of
# dh's largest value: an output rounded to bf16 (up to 2^-9 of it) or a d
# without its softmax term fails it. f32 operands take the plain products
# on the card (no kernel).
CE_BWD_TOL_FLOOR = 1e-6


def ce_bwd_tol(ref: torch.Tensor, k: int) -> float:
    """The CE backward's limit for one output of a K-long sum (see above)."""
    return (k / 16) * 2.0 ** -23 * float(ref.abs().max()) + CE_BWD_TOL_FLOOR



BF16_STEP = 2.0 ** -7  # the largest relative spacing of bf16 values (8-bit significand)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(ops: float, nbytes: float, peak_ops: float):
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lengths_like_yahoo(rng, n, cap):
    """Sentence lengths incl. <s>/</s> as in the smoke corpus, capped to ``cap``."""
    return np.minimum(np.clip(rng.normal(80, 25, n), 20, 160).astype(int) + 2, cap)


# ---------------------------------------------------------------- phase 2
def time_turns(fns, reps: int = 10):
    """``fns`` = {"library": f, "port": g}: each timed (``time_ms``) in
    turns library, port, port, library, so that a drift of the card's
    clocks falls on both; returns the median and the turns of each."""
    turns = {k: [] for k in fns}
    for k in ("library", "port", "port", "library"):
        turns[k].append(time_ms(fns[k], reps=reps))
    return {k: (float(np.median(v)), v) for k, v in turns.items()}


def check_lstm(save_residuals: bool, rows: int, ni: int, launches_key: str, dev):
    """The LSTM forward at ``rows`` with the launch plan the wrapper picks;
    the forward without residuals also at the encoder's 32 rows, the
    residual-saving forward also at a short last batch of 20 (``*_b20``) and
    at the decoder's 640 rows of ``--nsamples 40`` training (``*_rows640``)."""
    from vae_lagging_encoder_tpu_torch.ops import lstm_cuda

    r = _check_lstm(save_residuals, rows, ni, launches_key, dev)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    extras = [(B, NI, "rows32")] if not save_residuals else [
        (20, NI, "b20"), (NSAMPLES_ROWS, NI + NZ, "rows640")]
    for n, n_in, tag in extras:
        more = _check_lstm(save_residuals, n, n_in, launches_key, dev)
        r.update({f"{k}_{tag}": more[k] for k in ("err_f32", "err_bf16", "ms", "plain_ms",
                                                  "library_ms", "bound_ms", "floor_ms")
                  if k in more})
        if tag == "rows640":
            r.update(library_ms_turns_rows640=more["library_ms_turns"],
                     ms_turns_rows640=more["ms_turns"])
    more = _check_lstm(save_residuals, RAGGED_ROWS, NI + NZ, launches_key, dev, timed=False)
    r.update(err_f32_rows600=more["err_f32"], err_bf16_rows600=more["err_bf16"])
    for n in sorted({rows, B, NSAMPLES_ROWS}):
        r.update(plan_bytes(port_plan("infer", n, dev, save_residuals),
                            f"_rows{n}" if n != rows else ""))
    r.update(plan_bytes(lstm_cuda.mma_infer_plan(NSAMPLES_ROWS, NH, nsm, save_residuals),
                        "_mma_rows640"))
    r.update(plan_bytes(lstm_cuda.mma_infer_plan(B, NH, nsm, save_residuals), "_mma_rows32"))
    r.update(check_mma("infer", save_residuals, dev))
    return r


# The mma.sync kernels serve the rows between the narrow plans and the wide
# ones (at H 1024 on 132 SMs the forwards' 65-127 rows, the backward's
# 33-95): each is held against its plain version through the wrapper at
# MMA_ROWS (``*_mma_rows96`` / ``*_mma_rows64``), and under its own plan at
# the main path's 32 rows (``*_mma_rows32``), timed there beside the narrow
# kernel; each twice (equal bits).
MMA_ROWS = {"infer": 96, "bwd": 64}


def check_mma(kind: str, save_residuals: bool, dev):
    from vae_lagging_encoder_tpu_torch.ops import lstm_cuda

    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    T, H = T_CHECK, NH
    out = {}
    for rows in (B, MMA_ROWS[kind]):
        g = torch.Generator(device="cpu").manual_seed(30 + rows + 2 * save_residuals)
        xw = (0.5 * torch.randn(T, rows, 4 * H, generator=g)).to(dev)
        wh = torch.empty(H, 4 * H).uniform_(-1 / math.sqrt(H), 1 / math.sqrt(H), generator=g)
        wh = wh.bfloat16().to(dev)
        h0, c0 = (0.1 * torch.randn(2, rows, H, generator=g)).to(dev)
        lens = lengths_like_yahoo(np.random.RandomState(rows), rows, T)
        mask = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(np.float32)).to(dev)
        h0, c0 = h0.contiguous(), c0.contiguous()
        if kind == "bwd":
            _, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
            dhs = (0.1 * torch.randn(T, rows, H, generator=g)).to(dev)
            dhT, dcT = (0.1 * torch.randn(2, rows, H, generator=g)).to(dev)
            args = (gates, mask, wh, torch.cat([c0[None], cs[:-1]]), dhs, dhT.contiguous(),
                    dcT.contiguous())
            plan = lstm_cuda.mma_bwd_plan(rows, H, nsm)
            wrapped = port_plan("bwd", rows, dev)
            run = ((lambda: lstm_cuda.lstm_bwd_bf16(*args, plan)) if rows == B
                   else (lambda: lstm_cuda.lstm_bwd(*args)))
            ref, tol = lstm_cuda.lstm_bwd_plain(*args), TOL[("lstm_bwd", "bf16")]
        else:
            plan = lstm_cuda.mma_infer_plan(rows, H, nsm, save_residuals)
            wrapped = port_plan("infer", rows, dev, save_residuals)
            run = ((lambda: lstm_cuda.lstm_infer(xw, mask, wh, h0, c0, plan, save_residuals))
                   if rows == B else (lambda: lstm_cuda.lstm_seq(xw, mask, wh, h0, c0,
                                                                 save_residuals)))
            ref = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, save_residuals)
            tol = TOL[("lstm", "bf16")]
        if rows != B and wrapped != plan:
            raise AssertionError(f"{kind} rows {rows}: the wrapper runs {wrapped}, not the "
                                 f"mma.sync plan {plan}")
        got, again = run(), run()
        torch.cuda.synchronize()
        err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        if not err <= tol or not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{kind} mma.sync rows {rows}: max abs err {err} (tolerance "
                                 f"{tol}), equal bits {[torch.equal(a, b) for a, b in zip(got, again)]}")
        out[f"err_bf16_mma_rows{rows}"] = err
        out[f"ms_mma_rows{rows}"] = time_ms(run)
    return out


RAGGED_ROWS = 600  # a ragged wide-row shape: row groups of 320 and 280


def plan_bytes(plan, tag: str = ""):
    """A launch plan and its bf16 operand bytes a step: into each SM, and
    from L2 over the grid (``NarrowPlan`` / ``MMAPlan`` / ``WidePlan``)."""
    return {f"plan{tag}": repr(plan), f"sm_bytes_per_step{tag}": plan.sm_bytes_per_step,
            f"l2_bytes_per_step{tag}": plan.l2_bytes_per_step}


# The empty-step floor of the plans below WIDE_MIN_ROWS: lstm_ablation.py's
# "empty_step" copy of the kernel the plan runs, a step of only the barrier
# and the operand exchange (no product, no cell); T times its step is the
# least this design can reach, whatever the byte bound says. Built in phase
# 1 beside the kernels; {group: library}.
FLOORS = {}


def floor_group(plan) -> str:
    """lstm_ablation.py's group of the kernel a plan below the wide path runs."""
    from vae_lagging_encoder_tpu_torch.ops import lstm_cuda

    name = "lstm_bwd" if plan.kind == "bwd" else "lstm_infer"
    return name + ("_narrow" if isinstance(plan, lstm_cuda.NarrowPlan) else "")


def port_plan(kind: str, rows: int, dev, save_residuals: bool = False):
    """The plan the wrappers pick at ``rows``, H ``NH`` on this card (the
    narrow plans within the blocks its pairs hold, ``narrow_blocks``)."""
    from vae_lagging_encoder_tpu_torch.ops import lstm_cuda

    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    if kind == "bwd":
        return lstm_cuda.bwd_plan(rows, NH, nsm, lstm_cuda.narrow_blocks(dev, "bwd"))
    return lstm_cuda.infer_plan(rows, NH, nsm, save_residuals,
                                lstm_cuda.narrow_blocks(dev, "infer", save_residuals))


def build_floors(dev) -> float:
    """Build the empty-step copies of the kernels of the 32-row plans and of
    the f32 kernels (``lstm_f32``: both directions, every plan)."""
    import lstm_ablation

    t0 = time.perf_counter()
    plans = [port_plan("infer", n, dev, res) for n in (B, 20) for res in (False, True)]
    plans += [port_plan("bwd", n, dev) for n in (B, 20)]
    groups = sorted({floor_group(p) for p in plans}) + ["lstm_f32"]
    FLOORS.update({g: libs["empty_step"] for g, libs in
                   lstm_ablation.build_variants(groups, kinds=("empty_step",)).items()})
    return time.perf_counter() - t0


def floor_ms(plan, fn) -> float:
    """``fn`` (a launch under ``plan``) timed with the empty-step copy."""
    import lstm_ablation

    g = floor_group(plan)
    return lstm_ablation.time_with(lstm_ablation.source_of(g), FLOORS[g], fn)


def _check_lstm(save_residuals: bool, rows: int, ni: int, launches_key: str, dev,
                timed: bool = True):
    from vae_lagging_encoder_tpu_torch.ops import lstm_cuda

    g = torch.Generator(device="cpu").manual_seed((1 if save_residuals else 2) + rows)
    T, H = T_CHECK, NH
    x = torch.randn(T, rows, ni, generator=g)
    wx = torch.empty(ni, 4 * H).uniform_(-0.05, 0.05, generator=g)
    wh32 = torch.empty(H, 4 * H).uniform_(-1 / math.sqrt(H), 1 / math.sqrt(H), generator=g)
    b = torch.empty(4 * H).uniform_(-0.1, 0.1, generator=g)
    h0 = 0.1 * torch.randn(rows, H, generator=g)
    c0 = 0.1 * torch.randn(rows, H, generator=g)
    lens = lengths_like_yahoo(np.random.RandomState(3), rows, T)
    mask = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(np.float32))
    x, wx, wh32, b, h0, c0, mask = (a.to(dev) for a in (x, wx, wh32, b, h0, c0, mask))
    xw = (x.reshape(T * rows, ni) @ wx + b).reshape(T, rows, 4 * H)
    errs = {}
    for mode, wh in (("f32", wh32), ("bf16", wh32.bfloat16())):
        got = lstm_cuda.lstm_seq(xw, mask, wh, h0, c0, save_residuals)
        ref = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, save_residuals)
        torch.cuda.synchronize()
        err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        errs[mode] = err
        if not err <= TOL[("lstm", mode)]:
            raise AssertionError(f"{launches_key} rows {rows} {mode}: max abs err {err} > "
                                 f"{TOL[('lstm', mode)]}")
    if not timed:
        return dict(err_f32=errs["f32"], err_bf16=errs["bf16"])
    whb = wh32.bfloat16()
    port = lambda: lstm_cuda.lstm_seq(xw, mask, whb, h0, c0, save_residuals)
    ms = time_ms(port)
    plain_ms = time_ms(lambda: lstm_cuda.lstm_seq_plain(xw, mask, whb, h0, c0, save_residuals),
                       reps=5)
    ref_lstm = torch.nn.LSTM(ni, H, device=dev, dtype=torch.bfloat16)
    ref_lstm.flatten_parameters()
    xb = x.bfloat16()
    out = {}
    if save_residuals:
        # cuDNN's training forward (grad on, x requiring grad: cuDNN writes
        # the reserve space its backward reads), the like-for-like yardstick
        # of a residual-saving forward; it also does the input projection
        # (~13 GFLOP at B 32, tens of us), which the port does before the
        # kernel. Timed in turns with the port's kernel.
        xg = xb.clone().requires_grad_()
        with torch.enable_grad():
            t = time_turns({"library": lambda: ref_lstm(xg), "port": port})
        lib_ms = t["library"][0]
        out.update(library="cuDNN nn.LSTM bf16 training forward (grad on, reserve space)",
                   library_ms_turns=t["library"][1], ms_turns=t["port"][1])
    else:
        lib_ms = time_ms(lambda: ref_lstm(xb))
        out.update(library="cuDNN nn.LSTM bf16 forward (no grad)")
    ops = 2.0 * T * rows * H * 4 * H
    out_f = T * rows * H * (2 + 4 if save_residuals else 1) + 2 * rows * H
    nbytes = 4.0 * (T * rows * 4 * H + T * rows + 2 * rows * H + out_f) + 2.0 * H * 4 * H
    bms, by = bound(ops, nbytes, PEAK_BF16)
    plan = port_plan("infer", rows, dev, save_residuals)
    if not isinstance(plan, lstm_cuda.WidePlan):
        out.update(floor_ms=floor_ms(plan, port), floor_plan=repr(plan))
    return dict(err_f32=errs["f32"], err_bf16=errs["bf16"], ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by,
                shape=f"T {T}, rows {rows}, input {ni}, H {H}, wh bf16", **out)


CE_RAGGED_N = 1000  # not a multiple of the kernel's 128-row tile
NSAMPLES = 40       # phase 7's --nsamples: two decoder chunks of IW_CHUNK samples
NSAMPLES_ROWS = B * IW_CHUNK  # 640 LSTM rows in one chunk of --nsamples 40 training
CE_SPLIT_N = B * (T_CHECK - 1)  # 3040, the training shape: row groups split between clusters


def ce_inputs(N: int, seed: int, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = torch.tanh(torch.randn(N, NH, generator=g)).to(dev)
    w = torch.empty(NH, VOCAB).uniform_(-0.05, 0.05, generator=g).to(dev)
    tgt = torch.randint(0, VOCAB, (N,), generator=g).to(dev)
    return h, w, tgt


def ce_errors(h, w, tgt, save: bool):
    """The CE kernel (either mode) against ``ce_logp_plain`` in f32 and bf16
    operand mode; raises beyond the tolerances. Returns {mode: max abs err
    of logp and lse} and {mode: the spill's max abs err}."""
    from vae_lagging_encoder_tpu_torch.ops import ce_cuda

    kind, name = ("ce_train", "ce_fwd_train") if save else ("ce", "ce_fwd")
    errs, spill_errs = {}, {}
    for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
        got = ce_cuda.ce_forward(h, w, tgt, dt, save_logits=save)
        ref = ce_cuda.ce_logp_plain(h, w, tgt, dt, save_logits=save)
        torch.cuda.synchronize()
        errs[mode] = max(float((a - r).abs().max()) for a, r in zip(got[:2], ref[:2]))
        spill_ok = True
        if save:
            if tuple(got[2].shape) != tuple(ref[2].shape) or got[2].dtype != ref[2].dtype:
                raise AssertionError(f"{name} {mode}: spill {tuple(got[2].shape)} {got[2].dtype}, "
                                     f"expected {tuple(ref[2].shape)} {ref[2].dtype}")
            d = (got[2].float() - ref[2].float()).abs()
            spill_errs[mode] = float(d.max())
            # f32: summation order; bf16: the two f32 logits may round to
            # neighbouring bf16 values (one step), plus the f32 difference itself
            spill_ok = bool((d <= (BF16_STEP * ref[2].float().abs() + 1e-5)).all()) \
                if dt is not None else spill_errs[mode] <= TOL[(kind, "f32")]
        if not (errs[mode] <= TOL[(kind, mode)] and spill_ok):
            raise AssertionError(f"{name} N {h.shape[0]} {mode}: max abs err {errs[mode]} "
                                 f"(tolerance {TOL[(kind, mode)]}), spill {spill_errs.get(mode)}")
    return errs, spill_errs


def ce_same_bits(port, what: str) -> None:
    """Two calls of the CE forward give the same bits in every output (the
    partials are merged in one order); raises otherwise."""
    a, b = port(), port()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: two calls differ")


def ce_plan_of(N: int, dev):
    """The bf16 CE kernel's plan on this card at h [N, NH], W [NH, VOCAB]."""
    from vae_lagging_encoder_tpu_torch.ops import ce_cuda

    return ce_cuda.ce_plan(N, NH, VOCAB, ce_cuda.ce_clusters(
        dev, ce_cuda.CEPlan(N, NH, VOCAB, 1).smem_bytes))


def ce_kernel_ms(port, name: str, N: int, reps: int = 5, pack: bool = True) -> dict:
    """The device ms a call of the CE forward's kernels (the W^T pack of the
    bf16 kernel, the products and epilogue, the merge) from one profiled
    window of ``reps`` calls; raises unless the window holds those kernels
    and ``reps`` launches."""
    prof = profiled(lambda: [port() for _ in range(reps)], cpu=False)
    parts = (("ce_pack_wt",) if pack else ()) + (name, "ce_merge")
    kernel_ms = {o["op"]: o["ms_total"] / reps for o in prof["top_device_ops"]
                 if o["op"] in parts}
    if sorted(kernel_ms) != sorted(parts) or prof["port_kernel_calls"].get(name) != reps:
        raise AssertionError(f"{name} N {N}: the profiled window's kernels {kernel_ms} and "
                             f"launches {prof['port_kernel_calls']}, expected {parts} and "
                             f"{reps} launches")
    return {**kernel_ms, "total": sum(kernel_ms.values())}


def check_ce(dev):
    """The forward CE at the IW shape (N = 32 x 20 x 95 = 60800 rows), and at
    a ragged N and the training shape's N 3040; equal bits across calls at
    N 3040 and 60800; the launch's kernels' device ms (``kernel_ms``) and the
    plan's L2 -> shared bytes (``l2_bytes``) at both."""
    from vae_lagging_encoder_tpu_torch.ops import ce_cuda

    N = B * IW_CHUNK * (T_CHECK - 1)
    h, w, tgt = ce_inputs(N, 4, dev)
    errs, _ = ce_errors(h, w, tgt, False)
    more = {}
    for n, seed in ((CE_RAGGED_N, 14), (CE_SPLIT_N, 15)):
        hn, wn, tn = ce_inputs(n, seed, dev)
        e, _ = ce_errors(hn, wn, tn, False)
        more.update({f"err_bf16_n{n}": e["bf16"], f"err_f32_n{n}": e["f32"]})
        if n == CE_SPLIT_N:
            hn, wn = hn.bfloat16(), wn.bfloat16()
            small = lambda: ce_cuda.ce_forward(hn, wn, tn)
            ce_same_bits(small, f"ce_fwd N {n}")
            more.update({f"ms_n{n}": time_ms(small),
                         f"kernel_ms_n{n}": ce_kernel_ms(small, "ce_fwd", n),
                         f"l2_bytes_n{n}": ce_plan_of(n, dev).l2_bytes})
    hb, wb = h.bfloat16(), w.bfloat16()
    port = lambda: ce_cuda.ce_forward(hb, wb, tgt)
    ce_same_bits(port, f"ce_fwd N {N}")
    more.update(kernel_ms=ce_kernel_ms(port, "ce_fwd", N), l2_bytes=ce_plan_of(N, dev).l2_bytes)
    ms = time_ms(port)
    plain_ms = time_ms(lambda: ce_cuda.ce_logp_plain(hb, wb, tgt), reps=5)

    def library():
        logits = torch.matmul(hb, wb).float()
        return logits.gather(1, tgt[:, None])[:, 0] - torch.logsumexp(logits, -1)

    t = time_turns({"library": library, "port": port}, reps=5)
    ops = 2.0 * N * NH * VOCAB
    nbytes = 2.0 * (N * NH + NH * VOCAB) + 4.0 * N + 8.0 * N
    bms, by = bound(ops, nbytes, PEAK_BF16)
    return dict(err_f32=errs["f32"], err_bf16=errs["bf16"], ms=ms, plain_ms=plain_ms,
                library_ms=t["library"][0], library_ms_turns=t["library"][1],
                ms_turns=t["port"][1], bound_ms=bms, bound_by=by,
                library="bf16 matmul, f32 logsumexp, gather", plan=repr(ce_plan_of(N, dev)),
                shape=f"N {N}, nh {NH}, V {VOCAB}, bf16 operands", **more)


def check_lstm_bwd(dev):
    """``lstm_bwd`` against ``lstm_bwd_plain`` on the residuals of one
    masked forward at the training shape (T 96, B 32, H 1024), at a short
    last batch of 20 rows (``*_b20``) and at the 640 rows of a 20-sample
    chunk of ``--nsamples 40`` training (``*_rows640``)."""
    from vae_lagging_encoder_tpu_torch.ops import lstm_cuda

    r = _check_lstm_bwd(B, 5, dev)
    for n, seed, tag in ((20, 9, "b20"), (NSAMPLES_ROWS, 10, "rows640")):
        more = _check_lstm_bwd(n, seed, dev)
        r.update({f"{k}_{tag}": more[k] for k in ("err_f32", "err_bf16", "ms", "plain_ms",
                                                  "library_ms", "port_bwd_ms", "bound_ms",
                                                  "floor_ms") if k in more})
        if tag == "rows640":
            r.update(library_ms_turns_rows640=more["library_ms_turns"],
                     port_bwd_ms_turns_rows640=more["port_bwd_ms_turns"])
    more = _check_lstm_bwd(RAGGED_ROWS, 11, dev, timed=False)
    r.update(err_f32_rows600=more["err_f32"], err_bf16_rows600=more["err_bf16"])
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    r.update(plan_bytes(port_plan("bwd", B, dev)))
    r.update(plan_bytes(port_plan("bwd", NSAMPLES_ROWS, dev), "_rows640"))
    r.update(plan_bytes(lstm_cuda.mma_bwd_plan(NSAMPLES_ROWS, NH, nsm), "_mma_rows640"))
    r.update(plan_bytes(lstm_cuda.mma_bwd_plan(B, NH, nsm), "_mma_rows32"))
    r.update(check_mma("bwd", False, dev))
    return r


def _check_lstm_bwd(rows: int, seed: int, dev, timed: bool = True):
    from vae_lagging_encoder_tpu_torch.ops import lstm_cuda

    g = torch.Generator(device="cpu").manual_seed(seed)
    T, H = T_CHECK, NH
    x = torch.randn(T, rows, NI, generator=g)
    wx = torch.empty(NI, 4 * H).uniform_(-0.05, 0.05, generator=g)
    wh32 = torch.empty(H, 4 * H).uniform_(-1 / math.sqrt(H), 1 / math.sqrt(H), generator=g)
    b = torch.empty(4 * H).uniform_(-0.1, 0.1, generator=g)
    h0 = 0.1 * torch.randn(rows, H, generator=g)
    c0 = 0.1 * torch.randn(rows, H, generator=g)
    dhs = 0.1 * torch.randn(T, rows, H, generator=g)
    dhT = 0.1 * torch.randn(rows, H, generator=g)
    dcT = 0.1 * torch.randn(rows, H, generator=g)
    lens = lengths_like_yahoo(np.random.RandomState(seed + 1), rows, T)
    mask = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(np.float32))
    x, wx, wh32, b, h0, c0, dhs, dhT, dcT, mask = (
        a.to(dev) for a in (x, wx, wh32, b, h0, c0, dhs, dhT, dcT, mask))
    xw = (x.reshape(T * rows, NI) @ wx + b).reshape(T, rows, 4 * H)
    errs, args = {}, {}
    for mode, wh in (("f32", wh32), ("bf16", wh32.bfloat16())):
        _, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
        args[mode] = (gates, mask, wh, torch.cat([c0[None], cs[:-1]]), dhs, dhT, dcT)
        got = lstm_cuda.lstm_bwd(*args[mode])
        ref = lstm_cuda.lstm_bwd_plain(*args[mode])
        torch.cuda.synchronize()
        errs[mode] = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        if not errs[mode] <= TOL[("lstm_bwd", mode)]:
            raise AssertionError(f"lstm_bwd B {rows} {mode}: max abs err {errs[mode]} > "
                                 f"{TOL[('lstm_bwd', mode)]}")
    if not timed:
        return dict(err_f32=errs["f32"], err_bf16=errs["bf16"])
    ms = time_ms(lambda: lstm_cuda.lstm_bwd(*args["bf16"]))
    plain_ms = time_ms(lambda: lstm_cuda.lstm_bwd_plain(*args["bf16"]), reps=5)
    # This kernel computes da, dh0 and dc0 only. cuDNN's nn.LSTM (bf16)
    # backward computes the layer's whole backward: dx, dW_ih, dW_hh and the
    # biases. Like for like is the port's whole backward of the same layer:
    # LSTMSeqFn's (this kernel and the dWh product) and the input
    # projection's (dx, dWx, db). Each backward alone, on a retained graph,
    # timed in turns (cuDNN, port, port, cuDNN); cuDNN's forward+backward
    # minus its forward (PR 2's yardstick) beside them.
    ref_lstm = torch.nn.LSTM(NI, H, device=dev, dtype=torch.bfloat16)
    ref_lstm.flatten_parameters()
    xb = x.bfloat16().requires_grad_()
    gb = dhs.bfloat16()

    def fwd_bwd():
        out, _ = ref_lstm(xb)
        out.backward(gb)

    with torch.enable_grad():
        lib_out = ref_lstm(xb)[0]
        lib_leaves = (xb, *ref_lstm.parameters())
        leaves = [a.clone().requires_grad_() for a in (x, wx, b, wh32.bfloat16())]
        xr, wxr, br, whr = leaves
        port_out = lstm_cuda.LSTMSeqFn.apply(
            (xr.reshape(T * rows, NI) @ wxr + br).reshape(T, rows, 4 * H), mask, whr, h0, c0)[0]
        bwds = {"library": lambda: torch.autograd.grad(lib_out, lib_leaves, gb, retain_graph=True),
                "port": lambda: torch.autograd.grad(port_out, leaves, dhs, retain_graph=True)}
        turns = {"library": [], "port": []}
        for k in ("library", "port", "port", "library"):
            turns[k].append(time_ms(bwds[k], reps=10))
        lib_diff_ms = time_ms(fwd_bwd) - time_ms(lambda: ref_lstm(xb))
    # the products of the real (unmasked) steps; each input read once, each output written once
    ops = 2.0 * float(mask.sum()) * 4 * H * H
    nbytes = 4.0 * (T * rows * 4 * H + T * rows + 2 * T * rows * H + 2 * rows * H
                    + T * rows * 4 * H + 2 * rows * H) + 2.0 * H * 4 * H
    bms, by = bound(ops, nbytes, PEAK_BF16)
    plan = port_plan("bwd", rows, dev)
    floor = {}
    if not isinstance(plan, lstm_cuda.WidePlan):
        floor = dict(floor_ms=floor_ms(plan, lambda: lstm_cuda.lstm_bwd(*args["bf16"])),
                     floor_plan=repr(plan))
    return dict(err_f32=errs["f32"], err_bf16=errs["bf16"], ms=ms, plain_ms=plain_ms, **floor,
                library_ms=float(np.median(turns["library"])),
                port_bwd_ms=float(np.median(turns["port"])),
                library_ms_turns=turns["library"], port_bwd_ms_turns=turns["port"],
                library_fwd_bwd_minus_fwd_ms=lib_diff_ms, bound_ms=bms, bound_by=by,
                library="cuDNN nn.LSTM bf16 backward alone (dx, dW_ih, dW_hh, biases); "
                        "port_bwd_ms: the port's backward of the same layer",
                shape=f"T {T}, B {rows}, H {H}, wh bf16, masked")


# The f32-wh route: the kernel route keeps wh in f32 where H <= 512 and the
# compute dtype is f32 (models/lstm_core.py), so every text VAE narrowed to
# --enc_nh / --dec_nh <= 512 runs these kernels. The products are exact f32
# products on the FMA pipes: the bound takes the card's f32 rate without
# tensor cores (H100 SXM data sheet), and cuDNN's f32 LSTM is timed with
# TF32 off. Shapes: H 512 (the narrowed Yahoo model) at the training
# step's 32 rows, a short last batch of 20, --nsamples 40's and the IW
# decoder's 640 and a ragged 600; H 128 and the off-tile H 50 (the
# synthetic config's widths reach both); H 1024 at 32 and 640 rows.
PEAK_F32 = 67e12
F32_SHAPES = ((512, 32), (512, 20), (512, 640), (512, 600), (128, 32), (128, 640),
              (50, 32), (50, 640), (1024, 32), (1024, 640))
# kind -> the kernel's name in LAUNCHES and in the trace
F32_KERNELS = {"infer": "lstm_fwd_infer_f32", "resid": "lstm_fwd_residuals_f32",
               "bwd": "lstm_bwd_f32"}


def f32_inputs(H: int, rows: int, seed: int, dev, ni: int = NI):
    """Seeded inputs of the f32 route at ``H``, ``rows``, T ``T_CHECK``:
    x [T, rows, ni], the layer's f32 weights, the hoisted xw, the initial
    state, Yahoo-like lengths as the mask, the backward's incoming grads and
    the residuals of one plain forward."""
    from vae_lagging_encoder_tpu_torch.ops import lstm_cuda

    g = torch.Generator(device="cpu").manual_seed(seed)
    T = T_CHECK
    x = torch.randn(T, rows, ni, generator=g)
    wx = torch.empty(ni, 4 * H).uniform_(-0.05, 0.05, generator=g)
    wh = torch.empty(H, 4 * H).uniform_(-1 / math.sqrt(H), 1 / math.sqrt(H), generator=g)
    b = torch.empty(4 * H).uniform_(-0.1, 0.1, generator=g)
    h0, c0 = (0.1 * torch.randn(rows, H, generator=g) for _ in range(2))
    dhs = 0.1 * torch.randn(T, rows, H, generator=g)
    dhT, dcT = (0.1 * torch.randn(rows, H, generator=g) for _ in range(2))
    lens = lengths_like_yahoo(np.random.RandomState(seed), rows, T)
    mask = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(np.float32))
    d = dict(x=x, wx=wx, wh=wh, b=b, h0=h0, c0=c0, dhs=dhs, dhT=dhT, dcT=dcT, mask=mask)
    d = {k: v.to(dev) for k, v in d.items()}
    d["xw"] = (d["x"].reshape(T * rows, ni) @ d["wx"] + d["b"]).reshape(T, rows, 4 * H)
    _, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(d["xw"], d["mask"], d["wh"], d["h0"], d["c0"],
                                                  True)
    d["bwd_args"] = (gates, d["mask"], d["wh"], torch.cat([d["c0"][None], cs[:-1]]), d["dhs"],
                     d["dhT"], d["dcT"])
    return d


def f32_bound(kind: str, H: int, rows: int, mask) -> tuple:
    """The least time of one call at the f32 rate: the products at the
    unmasked steps (a masked step keeps h and c), except for the residual
    forward, whose ``gates`` output needs every step's; each input read
    once, each output written once (wh in f32)."""
    T = T_CHECK
    steps = T * rows if kind == "resid" else float(mask.sum())
    ops = 2.0 * steps * 4 * H * H
    if kind == "bwd":
        nbytes = 4.0 * (T * rows * 4 * H + T * rows + 2 * T * rows * H + 2 * rows * H
                        + T * rows * 4 * H + 2 * rows * H + H * 4 * H)
    else:
        out_f = T * rows * H * (2 + 4 if kind == "resid" else 1) + 2 * rows * H
        nbytes = 4.0 * (T * rows * 4 * H + T * rows + 2 * rows * H + out_f + H * 4 * H)
    return bound(ops, nbytes, PEAK_F32)


def f32_run(kind: str, d):
    """A call of the f32 route's wrapper of ``kind``."""
    from vae_lagging_encoder_tpu_torch.ops import lstm_cuda

    if kind == "bwd":
        return lambda: lstm_cuda.lstm_bwd(*d["bwd_args"])
    return lambda: lstm_cuda.lstm_seq(d["xw"], d["mask"], d["wh"], d["h0"], d["c0"],
                                      kind == "resid")


def f32_library(kind: str, d, H: int, port_fn):
    """cuDNN's f32 LSTM (TF32 off) for the same work, timed in turns with
    ``port_fn``: the inference forward, the training forward (grad on, its
    reserve space), or its whole backward against the port's whole backward
    of the same layer (``LSTMSeqFn`` and the input projection's). Returns
    (library ms, port ms, their turns)."""
    from vae_lagging_encoder_tpu_torch.ops import lstm_cuda

    ni, T, rows = d["x"].shape[-1], T_CHECK, d["x"].shape[1]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        lib = torch.nn.LSTM(ni, H, device=d["x"].device, dtype=torch.float32)
        lib.flatten_parameters()
        if kind == "infer":
            t = time_turns({"library": lambda: lib(d["x"]), "port": port_fn}, reps=5)
        elif kind == "resid":
            xg = d["x"].clone().requires_grad_()
            with torch.enable_grad():
                t = time_turns({"library": lambda: lib(xg), "port": port_fn}, reps=5)
        else:
            xg = d["x"].clone().requires_grad_()
            with torch.enable_grad():
                lib_out = lib(xg)[0]
                lib_leaves = (xg, *lib.parameters())
                leaves = [a.clone().requires_grad_() for a in (d["x"], d["wx"], d["b"], d["wh"])]
                xr, wxr, br, whr = leaves
                port_out = lstm_cuda.LSTMSeqFn.apply(
                    (xr.reshape(T * rows, ni) @ wxr + br).reshape(T, rows, 4 * H), d["mask"],
                    whr, d["h0"], d["c0"])[0]
                t = time_turns({
                    "library": lambda: torch.autograd.grad(lib_out, lib_leaves, d["dhs"],
                                                           retain_graph=True),
                    "port": lambda: torch.autograd.grad(port_out, leaves, d["dhs"],
                                                        retain_graph=True)}, reps=5)
    return t["library"][0], t["port"][0], {"library": t["library"][1], "port": t["port"][1]}


def check_f32(dev):
    """The f32-wh route's kernels (``F32_KERNELS``) at ``F32_SHAPES``: each
    against its plain version (``TOL``'s f32 limits), two calls equal bit
    for bit, its time (``ms``: one call from an idle stream), its device
    time (``kernel_ms``: a profiled window of 3 calls), the plain version's,
    cuDNN's f32 LSTM in turns, the bound at the f32 rate, the plan the
    wrapper launched and the empty-step floor (``lstm_ablation.py``'s copy
    of the f32 kernels). Returns {kind: {"H{H}_rows{rows}": figures}}."""
    from vae_lagging_encoder_tpu_torch.ops import build, lstm_cuda

    out = {k: {} for k in F32_KERNELS}
    for H, rows in F32_SHAPES:
        d = f32_inputs(H, rows, 500 + H + rows, dev)
        for kind, key in F32_KERNELS.items():
            run = f32_run(kind, d)
            plain = ((lambda: lstm_cuda.lstm_bwd_plain(*d["bwd_args"])) if kind == "bwd" else
                     (lambda: lstm_cuda.lstm_seq_plain(d["xw"], d["mask"], d["wh"], d["h0"],
                                                       d["c0"], kind == "resid")))
            before = dict(build.LAUNCHES)
            got, again = run(), run()
            ref = plain()
            torch.cuda.synchronize()
            launched = build.LAUNCHES[key] - before[key]
            err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
            tol = TOL[("lstm_bwd" if kind == "bwd" else "lstm", "f32")]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if not (err <= tol and same and launched == 2):
                raise AssertionError(f"f32 {kind} H {H} rows {rows}: max abs err {err} (tolerance "
                                     f"{tol}), equal bits {same}, launches {launched}")
            r = {"err": err, "tolerance": tol, "ms": time_ms(run, reps=10),
                 "plain_ms": time_ms(plain, reps=2, warmup=1)}
            prof = profiled(lambda: [run() for _ in range(3)], cpu=False)
            r["kernel_ms"] = prof.get("device_busy_ms", float("nan")) / 3
            r["kernel_ops"] = [o["op"] for o in prof.get("top_device_ops", [])]
            r["library_ms"], r["port_ms"], r["turns"] = f32_library(kind, d, H, run)
            if kind == "bwd":
                r["port_bwd_ms"] = r.pop("port_ms")
                r["library"] = "cuDNN nn.LSTM f32 backward alone, TF32 off; port_bwd_ms: the " \
                               "port's backward of the same layer"
            else:
                r["library"] = ("cuDNN nn.LSTM f32 " + ("training forward (grad on)" if
                                                        kind == "resid" else "forward (no grad)")
                                + ", TF32 off")
            r["bound_ms"], r["bound_by"] = f32_bound(kind, H, rows, d["mask"])
            plan = lstm_cuda.f32_device_plan("bwd" if kind == "bwd" else "infer", rows, H, dev)
            r.update(plan=repr(plan), sm_bytes_per_step=plan.sm_bytes_per_step,
                     l2_bytes_per_step=plan.l2_bytes_per_step, floor_ms=f32_floor_ms(run))
            out[kind][f"H{H}_rows{rows}"] = r
            log(json.dumps({"f32_check": kind, "H": H, "rows": rows, **r}))
        del d
    return out


def check_ce_f32(dev):
    """``ce_f32_kernel`` (``csrc/ce_f32.cu``: the CE forward with f32
    operands; no model path passes f32 operands: the decoder gives bf16) in
    both modes at the training shape's N 3040, the IW shape's N 60800 and a
    ragged N 1000 (nh 1024, V 20004): against the plain version (``TOL``,
    the spill within 1e-5), equal bits across calls; at N 3040 and 60800
    its time, the launch's kernels' device ms (``kernel_ms``: the products
    and epilogue, the merge), its plan, the plain version's time, the
    library's (one f32 matmul with TF32 off, logsumexp, gather: the logits
    it keeps are grad mode's spill) in turns, and the bound at the f32 rate
    without tensor cores (grad mode with the spill's bytes)."""
    from vae_lagging_encoder_tpu_torch.ops import ce_cuda

    out = {}
    for N, seed in ((CE_SPLIT_N, 15), (NSAMPLES_ROWS * (T_CHECK - 1), 4), (CE_RAGGED_N, 16)):
        h, w, tgt = ce_inputs(N, seed, dev)
        plan = ce_cuda.ce_f32_plan(N, NH, VOCAB, ce_cuda.ce_f32_blocks(dev))

        def library():
            logits = torch.matmul(h, w)
            return (logits.gather(1, tgt[:, None])[:, 0] - torch.logsumexp(logits, -1), logits)

        for save in (False, True):
            name, kind = ("ce_fwd_train", "ce_train") if save else ("ce_fwd", "ce")
            port = lambda: ce_cuda.ce_forward(h, w, tgt, None, save_logits=save)
            got = port()
            ref = ce_cuda.ce_logp_plain(h, w, tgt, None, save_logits=save)
            torch.cuda.synchronize()
            err = max(float((a - r).abs().max()) for a, r in zip(got[:2], ref[:2]))
            spill_err = float((got[2] - ref[2]).abs().max()) if save else None
            del got, ref
            if not (err <= TOL[(kind, "f32")] and (spill_err or 0.0) <= 1e-5):
                raise AssertionError(f"{name} f32 N {N}: max abs err {err} (tolerance "
                                     f"{TOL[(kind, 'f32')]}), spill {spill_err} (1e-5)")
            ce_same_bits(port, f"{name} f32 N {N}")
            r = dict(err=err, spill_err=spill_err, tolerance=TOL[(kind, "f32")],
                     plan=repr(plan), band=plan.band, lanes=plan.lanes, blocks=plan.blocks,
                     waves=plan.waves, l2_bytes=plan.l2_bytes, dram_bytes=plan.dram_bytes)
            if N != CE_RAGGED_N:
                with _no_tf32():
                    t = time_turns({"library": library, "port": port}, reps=3)
                nbytes = 4.0 * (N * NH + NH * VOCAB) + 4.0 * N + 8.0 * N \
                    + (4.0 * N * VOCAB if save else 0.0)
                bms, by = bound(2.0 * N * NH * VOCAB, nbytes, PEAK_F32)
                r.update(ms=time_ms(port, reps=5), kernel_ms=ce_kernel_ms(port, name, N,
                                                                           pack=False),
                         plain_ms=time_ms(lambda: ce_cuda.ce_logp_plain(
                             h, w, tgt, None, save_logits=save), reps=2, warmup=1),
                         library_ms=t["library"][0], library_ms_turns=t["library"][1],
                         ms_turns=t["port"][1], bound_ms=bms, bound_by=by,
                         library="f32 matmul (TF32 off), logsumexp, gather")
            out[f"{name}_n{N}"] = r
            log(json.dumps({"ce_f32_check": name, "N": N, **r}))
            torch.cuda.empty_cache()
        del h, w, tgt
    return out


class _no_tf32:
    """TF32 off for f32 matrix products inside the block (PyTorch's default
    too, set here so the yardstick does not depend on it)."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


def f32_floor_ms(fn) -> float:
    """``fn`` timed with the empty-step copy of the f32 kernels (built in
    phase 1, ``FLOORS["lstm_f32"]``)."""
    import lstm_ablation

    return lstm_ablation.time_with("lstm_f32", FLOORS["lstm_f32"], fn)


def check_ce_train(dev):
    """The grad-mode CE (logp, the logsumexp of the rounded logits and the
    spilled logits) against its plain version at the training shape
    (N = 32 x 95 rows), at a ragged N, and at the N 60800 of a 20-sample
    chunk of ``--nsamples 40`` training (``*_n60800``); at N 3040 and 60800
    equal bits across calls, the launch's kernels' device ms
    (``kernel_ms``) and the plan's L2 -> shared bytes (``l2_bytes``)."""
    r = _check_ce_train(CE_SPLIT_N, 8, dev)
    e, se = ce_errors(*ce_inputs(CE_RAGGED_N, 18, dev), True)
    r.update({f"err_bf16_n{CE_RAGGED_N}": e["bf16"], f"err_f32_n{CE_RAGGED_N}": e["f32"],
              f"spill_err_bf16_n{CE_RAGGED_N}": se["bf16"]})
    big = _check_ce_train(NSAMPLES_ROWS * (T_CHECK - 1), 19, dev)
    r.update({f"{k}_n60800": big[k] for k in (
        "err_f32", "err_bf16", "spill_err_bf16", "ms", "plain_ms", "library_ms",
        "library_ms_turns", "ms_turns", "library_fwd_bwd_ms", "port_fwd_bwd_ms", "bound_ms",
        "kernel_ms", "l2_bytes", "plan")})
    return r


def _check_ce_train(N: int, seed: int, dev):
    from vae_lagging_encoder_tpu_torch.ops import ce_cuda

    h, w, tgt = ce_inputs(N, seed, dev)
    errs, spill_errs = ce_errors(h, w, tgt, True)
    hb, wb = h.bfloat16(), w.bfloat16()
    port = lambda: ce_cuda.ce_forward(hb, wb, tgt, save_logits=True)
    ce_same_bits(port, f"ce_fwd_train N {N}")
    kernel_ms = ce_kernel_ms(port, "ce_fwd_train", N)
    ms = time_ms(port)
    plain_ms = time_ms(lambda: ce_cuda.ce_logp_plain(hb, wb, tgt, save_logits=True), reps=5)
    gout = torch.randn(N, generator=torch.Generator().manual_seed(9)).to(dev)

    def library_fwd():  # the same function: bf16 logits, lse of the rounded logits, gather
        logits = torch.matmul(hb, wb)
        lf = logits.float()
        lse = torch.logsumexp(lf, -1)
        return lf.gather(1, tgt[:, None])[:, 0] - lse, lse, logits

    def library():  # bf16 matmul + log_softmax + gather, forward and backward
        logits = torch.matmul(hr, wr).float()
        torch.log_softmax(logits, -1).gather(1, tgt[:, None])[:, 0].backward(gout)

    def port_fwd_bwd():  # the port's FusedCEFn forward (this kernel) + backward
        ce_cuda.FusedCEFn.apply(hr, wr, tgt, torch.bfloat16).backward(gout)

    t = time_turns({"library": library_fwd, "port": port})
    hr, wr = hb.clone().requires_grad_(), wb.clone().requires_grad_()
    with torch.enable_grad():
        tb = time_turns({"library": library, "port": port_fwd_bwd}, reps=5)
    ops = 2.0 * N * NH * VOCAB
    nbytes = 2.0 * (N * NH + NH * VOCAB + N * VOCAB) + 4.0 * N + 8.0 * N
    bms, by = bound(ops, nbytes, PEAK_BF16)
    return dict(err_f32=errs["f32"], err_bf16=errs["bf16"], spill_err_bf16=spill_errs["bf16"],
                ms=ms, plain_ms=plain_ms, kernel_ms=kernel_ms,
                l2_bytes=ce_plan_of(N, dev).l2_bytes, library_ms=t["library"][0],
                library_ms_turns=t["library"][1], ms_turns=t["port"][1],
                library="bf16 matmul (bf16 logits), f32 logsumexp of them, gather: forward only",
                library_fwd_bwd_ms=tb["library"][0], library_fwd_bwd_ms_turns=tb["library"][1],
                port_fwd_bwd_ms=tb["port"][0], port_fwd_bwd_ms_turns=tb["port"][1],
                bound_ms=bms, bound_by=by, plan=repr(ce_plan_of(N, dev)),
                shape=f"N {N}, nh {NH}, V {VOCAB}, bf16 operands, bf16 spill")


def check_ce_bwd(dev):
    """The CE backward (dh and dW) against ``ce_backward_plain`` on the card,
    on the residuals of one grad-mode forward: at the training shape N 3040
    (dh's K split over blocks), at a ragged N, and at the N 60800 of a
    20-sample chunk of ``--nsamples 40`` training (``*_n60800``); timed at
    N 3040 and 60800 against its bound, its plain version and the library's
    bf16 products (in turns), with its kernels' device times from one
    profiled window (``kernel_ms``) and its extra peak memory beside the
    plain version's."""
    r = _check_ce_bwd(CE_SPLIT_N, 21, dev)
    ragged = _check_ce_bwd(CE_RAGGED_N, 23, dev, timed=False)
    r.update({f"{k}_n{CE_RAGGED_N}": ragged[k] for k in ragged})
    big = _check_ce_bwd(NSAMPLES_ROWS * (T_CHECK - 1), 22, dev)
    r.update({f"{k}_n60800": big[k] for k in (
        "err_bf16", "err_dh", "err_dw", "tolerance", "max_abs_ref", "ms", "plain_ms", "library_ms", "library_ms_turns", "ms_turns", "bound_ms",
        "kernel_ms", "extra_peak_bytes", "plain_extra_peak_bytes", "plan")})
    return r


def _check_ce_bwd(N: int, seed: int, dev, timed: bool = True):
    from vae_lagging_encoder_tpu_torch.ops import ce_cuda

    h, w, tgt = ce_inputs(N, seed, dev)
    tgt[0], tgt[-1] = 0, VOCAB - 1
    g = torch.randn(N, generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    g[::5] = 0.0  # masked tokens
    (_, lse, spill), operands = ce_cuda._ce_forward(h, w, tgt, torch.bfloat16, True)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ce_cuda.ce_bwd_plan(N, NH, VOCAB, nsm)

    def port():
        return ce_cuda.ce_backward(h, w, tgt, lse, spill, g, torch.bfloat16, operands=operands)

    def plain():
        return ce_cuda.ce_backward_plain(h, w, tgt, lse, spill, g, torch.bfloat16)

    got, again, ref = port(), port(), plain()
    torch.cuda.synchronize()
    outs = ("dh", "dw")
    errs = {k: float((a - b).abs().max()) for k, a, b in zip(outs, got, ref)}
    tol = {k: ce_bwd_tol(b, kk) for k, b, kk in zip(outs, ref, (plan.Vp, N))}
    checked = dict(err_bf16=max(errs.values()), err_dh=errs["dh"], err_dw=errs["dw"],
                   tolerance=tol,
                   max_abs_ref={k: float(b.abs().max()) for k, b in zip(outs, ref)})
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if not (all(errs[k] <= tol[k] for k in outs) and same):
        raise AssertionError(f"ce_bwd N {N}: max abs err {errs} (tolerance {tol}), two calls "
                             f"equal {same}")
    if not timed:
        return checked
    del got, again, ref
    out_bytes = 4 * (N * NH + NH * VOCAB)  # dh and dW

    def extra_peak(fn):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before - out_bytes
        del res
        return peak

    extra, plain_extra = extra_peak(port), extra_peak(plain)
    ms = time_ms(port)
    plain_ms = time_ms(plain, reps=3)
    hb, wb = operands[0][:, :NH], w.bfloat16()

    def library():  # d from torch ops (bf16), then the two products with f32 output
        d = spill.float().sub_(lse[:, None]).exp_().mul_(-g[:, None])
        d = d.scatter_add_(1, tgt[:, None], g[:, None]).to(torch.bfloat16)
        return (torch.mm(d, wb.T, out_dtype=torch.float32),
                torch.mm(hb.T, d, out_dtype=torch.float32))

    t = time_turns({"library": library, "port": port}, reps=5)
    # the kernels of the launch (the d pass, the products, the merge): PERF.md
    # reads this split, so a failed profile fails the phase
    reps = 5
    prof = profiled(lambda: [port() for _ in range(reps)], cpu=False)
    kernel_ms = {o["op"]: o["ms_total"] / reps for o in prof["top_device_ops"]
                 if o["op"].startswith("ce_bwd_")}
    parts = ("ce_bwd_d", "ce_bwd_dh", "ce_bwd_dw") + ("ce_bwd_merge",) * (plan.splits > 1)
    if sorted(kernel_ms) != sorted(parts) or prof["port_kernel_calls"].get("ce_bwd") != reps:
        raise AssertionError(f"ce_bwd N {N}: the profiled window's kernels {kernel_ms} and "
                             f"launches {prof['port_kernel_calls']}, expected {parts} and "
                             f"{reps} launches")
    ops = 4.0 * N * NH * VOCAB
    nbytes = (2.0 * N * VOCAB + 2.0 * (N * NH + NH * VOCAB) + 12.0 * N
              + 4.0 * (N * NH + NH * VOCAB))
    bms, by = bound(ops, nbytes, PEAK_BF16)
    return dict(**checked, ms=ms, plain_ms=plain_ms, library_ms=t["library"][0],
                library_ms_turns=t["library"][1], ms_turns=t["port"][1], bound_ms=bms,
                bound_by=by, kernel_ms=kernel_ms, extra_peak_bytes=extra,
                plain_extra_peak_bytes=plain_extra,
                extra_peak_budget=plan.d_bytes + plan.part_bytes, plan=repr(plan),
                library="d by torch ops (bf16), then torch.mm(d, W^T) and torch.mm(h^T, d) "
                        "of bf16 operands with out_dtype f32",
                shape=f"N {N}, nh {NH}, V {VOCAB}, bf16 operands, the forward's bf16 spill "
                      f"and W^T")


# ---------------------------------------------------------------- phase 3
N_WORDS = 20000       # corpus words; the vocabulary adds <pad> <unk> <s> </s>
N_TRAIN, N_VAL, N_TEST = 3200, 64, 96
IW_CROSS_SAMPLES = 20
CROSS_TOL = 5e-2  # nats, on per-sentence NLLs of ~8e2 (see cross_check)


def yahoo_like_sentences(rng, n):
    """Yahoo-like synthetic sentences (~80 words, zipf(1.3) over 20k words)."""
    lens = np.clip(rng.normal(80, 25, n), 20, 160).astype(int)
    ids = rng.zipf(1.3, size=int(lens.sum())) % N_WORDS
    out, pos = [], 0
    for ln in lens:
        out.append(" ".join(f"w{i}" for i in ids[pos:pos + ln]))
        pos += int(ln)
    return out


def write_corpus(d: Path):
    """label<TAB>sentence files; the train split also carries every word
    once, so the vocabulary is exactly N_WORDS + 4 = 20004 (Yahoo's size)."""
    rng = np.random.RandomState(0)
    train = yahoo_like_sentences(rng, N_TRAIN)
    train += [" ".join(f"w{i}" for i in range(s, s + 100)) for s in range(0, N_WORDS, 100)]
    paths = {}
    for split, sents in (("train", train), ("valid", yahoo_like_sentences(rng, N_VAL)),
                         ("test", yahoo_like_sentences(rng, N_TEST))):
        paths[split] = d / f"yahoo.{split}.txt"
        paths[split].write_text("".join(f"{i % 10}\t{s}\n" for i, s in enumerate(sents)))
    return paths


def run_slice(tmp: Path, dev):
    """Drive ``cli.text.main --eval`` at Yahoo width; return its results,
    per-evaluator seconds, launch counts and wall time, plus the test pool,
    checkpoint, config and vocabulary size for the cross-check."""
    from vae_lagging_encoder_tpu_torch.cli import text as cli_text
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.data import BucketedPool, MonoTextData
    from vae_lagging_encoder_tpu_torch.models import build_text_vae
    from vae_lagging_encoder_tpu_torch.ops import build
    from vae_lagging_encoder_tpu_torch.train.checkpoint import save_checkpoint
    from vae_lagging_encoder_tpu_torch.utils.jax_params import to_jax_params

    paths = write_corpus(tmp)
    cfg = get_config("yahoo")
    vocab = MonoTextData(str(paths["train"]), label=True).vocab
    if len(vocab) != VOCAB:
        raise AssertionError(f"vocabulary {len(vocab)} != {VOCAB}")
    vae = build_text_vae(cfg, len(vocab), device="cpu",
                         generator=torch.Generator().manual_seed(20240))
    ck = tmp / "model.ckpt"
    save_checkpoint(str(ck), to_jax_params(vae.state_dict()), {"note": "random init"})
    exp_dir = tmp / "exp"
    argv = ["--dataset", "yahoo", "--eval", "--load_path", str(ck),
            "--train_data", str(paths["train"]), "--val_data", str(paths["valid"]),
            "--test_data", str(paths["test"]), "--exp_dir", str(exp_dir)]
    log(f"[slice] python -m vae_lagging_encoder_tpu_torch.cli.text {' '.join(argv)}")
    build.reset_launches()
    t0 = time.perf_counter()
    rc = cli_text.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"cli.text.main returned {rc}")
    records = [json.loads(l) for l in (exp_dir / "log.metrics.jsonl").read_text().splitlines()]
    results = next(r for r in records if r.get("split") == "test")
    seconds = next(r for r in records if r.get("split") == "test_seconds")
    test = MonoTextData(str(paths["test"]), label=True, vocab=vocab)
    pool = BucketedPool(test.create_data_batch(cfg.batch_size, cfg.length_buckets), dev)
    return results, seconds, launches, wall, pool, ck, cfg, len(vocab)


def expected_launches(pool, cfg):
    """Launches of the eval suite per batch: the encoder runs in ELBO, MI,
    AU (two passes) and once per IW chunk; the decoder LSTM and the CE once
    in ELBO and once per iw_chunk samples of IW."""
    from vae_lagging_encoder_tpu_torch.ops import build

    n = pool.num_batches
    iw_chunks = cfg.iw_nsamples // cfg.iw_batch
    dec_calls = 1 + cfg.iw_nsamples // IW_CHUNK
    return {**{k: 0 for k in build.LAUNCHES},
            "lstm_fwd_infer": n * (1 + 1 + 2 + iw_chunks + dec_calls), "ce_fwd": n * dec_calls}


def cross_check(pool, ck, cfg, vocab_size, dev):
    """One test batch: ELBO terms and IW-NLL at IW_CROSS_SAMPLES samples,
    the kernels against the plain versions on the card, on the same noise.
    The checkpoint's weights are scaled by 10 here: at the init scale
    (U(-0.01, 0.01)) states and logits are so small that the two sides
    agree to the last f32 bit, and the check would see nothing. The
    tolerance CROSS_TOL (nats per sentence) covers ~80-token sums of the CE
    check's and the bf16 LSTM check's per-element differences."""
    from vae_lagging_encoder_tpu_torch.models import build_text_vae, dec_lstm, lstm_core
    from vae_lagging_encoder_tpu_torch.ops import build, ce_cuda, lstm_cuda
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

    vae = build_text_vae(cfg, vocab_size, device=dev)
    vae.load_state_dict(from_jax_params(load_checkpoint(str(ck))[0]))
    with torch.no_grad():
        for p in vae.parameters():
            p.mul_(10.0)
    x, mask, rw = next(iter(pool))
    g = torch.Generator(device=dev).manual_seed(7)
    eps1 = torch.randn((x.shape[0], 1, NZ), generator=g, device=dev)
    epsk = torch.randn((x.shape[0], IW_CROSS_SAMPLES, NZ), generator=g, device=dev)

    def run():
        loss, rec, kl = vae.loss(x, mask, rw, eps=eps1)
        nll = vae.nll_iw(x, mask, IW_CROSS_SAMPLES, cfg.iw_batch, noise=lambda j, s: epsk)
        return torch.stack([rec, kl, nll * rw])

    with torch.no_grad():
        build.reset_launches()
        got = run()
        kernel_launches = dict(build.LAUNCHES)
        saved = lstm_core.lstm_seq, dec_lstm.ce_forward
        lstm_core.lstm_seq, dec_lstm.ce_forward = lstm_cuda.lstm_seq_plain, ce_cuda.ce_logp_plain
        try:
            build.reset_launches()
            ref = run()
        finally:
            lstm_core.lstm_seq, dec_lstm.ce_forward = saved
        if not (kernel_launches["lstm_fwd_infer"] and kernel_launches["ce_fwd"]
                and not any(build.LAUNCHES.values())):
            raise AssertionError(f"cross-check routing: kernel run launched {kernel_launches}, "
                                 f"plain run launched {build.LAUNCHES}")
    err = float((got - ref).abs().max())
    if not (torch.isfinite(got).all() and err <= CROSS_TOL):
        raise AssertionError(f"cross-check: max abs err {err} > {CROSS_TOL} or non-finite")
    return err, float(got[2].sum() / rw.sum())


# ---------------------------------------------------------------- phase 4
N_TRAIN_SMOKE = 256   # 8 batches of 32, all in the 96 bucket
TRAIN_EPOCHS = 2
TRAIN_IW = 100        # --iw_nsamples of the training run's final evaluation


def write_train_corpus(d: Path):
    """An 8-batch training split of 79-94-word sentences (one bucket, T 96)
    whose tokens hold every one of the N_WORDS words, so the vocabulary is
    exactly 20004; the validation split is Yahoo-like."""
    rng = np.random.RandomState(1)
    lens = rng.randint(79, 95, N_TRAIN_SMOKE)
    ids = np.concatenate([rng.permutation(N_WORDS),
                          rng.zipf(1.3, size=int(lens.sum()) - N_WORDS) % N_WORDS])
    rng.shuffle(ids)
    pos, train = 0, []
    for ln in lens:
        train.append(" ".join(f"w{i}" for i in ids[pos:pos + ln]))
        pos += int(ln)
    paths = {"train": d / "smoke.train.txt", "valid": d / "smoke.valid.txt"}
    for split, sents in (("train", train), ("valid", yahoo_like_sentences(rng, N_VAL))):
        paths[split].write_text("".join(f"{i % 10}\t{s}\n" for i, s in enumerate(sents)))
    return paths


def run_cli(main, argv, exp_dir: Path, name: str, stop=None):
    """``main(argv + --exp_dir)`` (``name`` is the module under the port's
    package) with the counters and the peak device memory reset just
    before it; with ``stop``, ``run_training`` stops after that many steps
    (its ``_stop_after_steps`` hook). Returns the launches, the metric
    records and the wall seconds."""
    import functools

    from vae_lagging_encoder_tpu_torch.ops import build
    from vae_lagging_encoder_tpu_torch.train import loop

    log(f"[cli] python -m vae_lagging_encoder_tpu_torch.{name} {' '.join(argv)}"
        + (f" (stopped after {stop} steps)" if stop else ""))
    run_training = loop.run_training
    if stop is not None:
        loop.run_training = functools.partial(run_training, _stop_after_steps=stop)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = main(argv + ["--exp_dir", str(exp_dir)])
    finally:
        loop.run_training = run_training
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"{name} returned {rc}")
    records = [json.loads(l) for l in (exp_dir / "log.metrics.jsonl").read_text().splitlines()]
    return launches, records, wall


def run_train_cli(argv, exp_dir: Path, stop=None):
    """``run_cli`` of ``cli.text``: the launches, the per-epoch metrics, the
    final results (None when stopped), the wall seconds and the peak device
    memory."""
    from vae_lagging_encoder_tpu_torch.cli import text as cli_text

    launches, records, wall = run_cli(cli_text.main, argv, exp_dir, "cli.text", stop)
    return dict(launches=launches, epochs=[r for r in records if "val_loss" in r],
                results=next((r for r in records if r.get("split") == "test"), None),
                wall=wall, max_memory_allocated=torch.cuda.max_memory_allocated())


def expected_train_launches(epochs, n_train, val_pool, test_pool, cfg, nsamples: int = 1):
    """Per forward+backward (outer step or inner sub-iteration) the
    launches of ``step_launches(nsamples)``. Per epoch the validation ELBO
    (encoder + decoder forward, CE per batch) and, after an aggressive
    epoch, the validation MI (encoder); then the final evaluation."""
    fb = sum(n_train + e["inner_iters"] for e in epochs)
    n_val = val_pool.num_batches
    mi_epochs = sum(bool(e["epoch_aggressive"]) for e in epochs)
    final = expected_launches(test_pool, cfg)
    return {**{k: v * fb for k, v in step_launches(nsamples).items()},
            "lstm_fwd_infer": n_val * (2 * len(epochs) + mi_epochs) + final["lstm_fwd_infer"],
            "ce_fwd": n_val * len(epochs) + final["ce_fwd"]}


def run_training_slice(tmp: Path, test_path: Path, dev):
    """Phase 4: the aggressive run, then one plain epoch, through the CLI;
    the test split is phase 3's."""
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.data import BucketedPool, MonoTextData
    from vae_lagging_encoder_tpu_torch.models import build_text_vae
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

    tp = write_train_corpus(tmp)
    files = ["--train_data", str(tp["train"]), "--val_data", str(tp["valid"]),
             "--test_data", str(test_path)]
    train = MonoTextData(str(tp["train"]), label=True)
    if len(train.vocab) != VOCAB:
        raise AssertionError(f"training vocabulary {len(train.vocab)} != {VOCAB}")
    dims = dict(ni=NI, enc_nh=NH, dec_nh=NH, nz=NZ)  # the Yahoo config's widths
    cfg = get_config("yahoo", iw_nsamples=TRAIN_IW, **dims)
    pool = lambda f: BucketedPool(MonoTextData(str(f), label=True, vocab=train.vocab)
                                  .create_data_batch(cfg.batch_size, cfg.length_buckets), dev)
    train_pool, val_pool, test_pool = pool(tp["train"]), pool(tp["valid"]), pool(test_path)
    if train_pool.lengths != (T_CHECK,) or train_pool.num_batches != N_TRAIN_SMOKE // B:
        raise AssertionError(f"training pool {train_pool.lengths} {train_pool.num_batches}")
    out = {}
    for name, extra in (("aggressive", ["--epochs", str(TRAIN_EPOCHS), "--aggressive", "1"]),
                        ("plain", ["--epochs", "1", "--aggressive", "0"])):
        ck = tmp / f"{name}.ckpt"
        argv = ["--dataset", "yahoo", *extra, "--warm_up", "1", "--kl_start", "0.1",
                "--iw_nsamples", str(TRAIN_IW), "--save_path", str(ck), *files,
                *(f"--{k}={v}" for k, v in dims.items())]
        run = run_train_cli(argv, tmp / f"exp_{name}")
        launches, epochs, res, wall = (run[k] for k in ("launches", "epochs", "results", "wall"))
        want = expected_train_launches(epochs, train_pool.num_batches, val_pool, test_pool, cfg)
        log(f"[train] {name}: epochs {json.dumps(epochs)}")
        log(f"[train] {name}: results {json.dumps(res)}; whole CLI {wall:.2f} s; launches "
            f"{json.dumps(launches)} (expected {json.dumps(want)})")
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"{name} training launch counts {launches} != expected {want}")
        vals = [res[k] for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll")] + \
            [e[k] for e in epochs for k in ("train_loss", "val_loss")]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{name}: non-finite training or evaluation values")
        params, extra_state = load_checkpoint(str(ck))
        vae = build_text_vae(cfg, VOCAB, device=dev)
        vae.load_state_dict(from_jax_params(params))  # strict: every name and shape
        if "opt_state" not in extra_state or extra_state["epoch"] not in range(len(epochs)):
            raise AssertionError(f"{name}: checkpoint extras {sorted(extra_state)}")
        out[name] = dict(launches=launches, epochs=epochs, results=res, wall=wall)
    steps = {mode: [e["steps_per_sec"] for r in out.values() for e in r["epochs"]
                    if bool(e["epoch_aggressive"]) == (mode == "aggressive")]
             for mode in ("aggressive", "plain")}
    return out, steps, train_pool, cfg


def grad_cross_check(train_pool, cfg, dev, nsamples: int = 1):
    """One training step at Yahoo width, dropout on: loss and every gradient
    with the kernels, and again with ``lstm_seq``, ``lstm_bwd`` and the CE's
    forward and backward swapped for their plain versions, on the same eps
    and dropout draws. The
    weights are the seeded init scaled by 10, as in ``cross_check``, so that
    the two sides' differences are visible. GRAD_TOL (relative to each
    leaf's largest entry, and to the global norm) covers bf16 roundings of
    h (forward) and da (backward) that one side flips and the other not,
    compounding over 96 steps: the kernels' own checks bound each call's
    difference at ~1e-3 of its scale."""
    from vae_lagging_encoder_tpu_torch.models import build_text_vae
    from vae_lagging_encoder_tpu_torch.ops import build, ce_cuda, lstm_cuda
    from vae_lagging_encoder_tpu_torch.train.aggressive import grads_of, make_grad_on
    from vae_lagging_encoder_tpu_torch.train.epoch import make_loss_fn
    from vae_lagging_encoder_tpu_torch.train.optim import clip_scale

    vae = build_text_vae(cfg, VOCAB, device=dev, generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        for p in vae.parameters():
            p.mul_(10.0)
    batch = train_pool.batch(0)
    g = torch.Generator(device=dev).manual_seed(12)
    draws = {}

    def draw(site, shape):  # the same draws for both runs
        if site not in draws:
            draws[site] = (torch.randn if site == "eps" else torch.rand)(
                shape, generator=g, device=dev)
        return draws[site]

    grad_on = make_grad_on(vae, make_loss_fn(vae, nsamples=nsamples, train=True))
    params = dict(vae.named_parameters())

    def run():
        build.reset_launches()
        with torch.enable_grad():
            aux = grad_on(batch, draw, 0.5)
        grads = {k: v.clone() for k, v in grads_of(params).items()}
        torch.cuda.synchronize()
        return (float(aux[0].detach()), grads, float(clip_scale(grads, cfg.clip_grad)[1]),
                dict(build.LAUNCHES))

    loss_k, grads_k, norm_k, launches_k = run()
    saved = lstm_cuda.lstm_seq, lstm_cuda.lstm_bwd, ce_cuda._ce_forward, ce_cuda.ce_backward
    lstm_cuda.lstm_seq, lstm_cuda.lstm_bwd = lstm_cuda.lstm_seq_plain, lstm_cuda.lstm_bwd_plain
    ce_cuda._ce_forward = (lambda h, w, tgt, dt, save_logits:
                           (ce_cuda.ce_logp_plain(h, w, tgt, dt, save_logits), None))
    ce_cuda.ce_backward = lambda *args, operands=None: ce_cuda.ce_backward_plain(*args)
    try:
        loss_p, grads_p, norm_p, launches_p = run()
    finally:
        lstm_cuda.lstm_seq, lstm_cuda.lstm_bwd, ce_cuda._ce_forward, ce_cuda.ce_backward = saved
    want = step_launches(nsamples)
    if {k: launches_k[k] for k in want} != want or any(launches_p.values()):
        raise AssertionError(f"gradient cross-check routing: kernel run launched {launches_k}, "
                             f"plain run launched {launches_p}")
    rel = {k: float((grads_k[k] - grads_p[k]).abs().max()) / max(float(grads_p[k].abs().max()),
                                                                  1e-30)
           for k in grads_p}
    worst = max(rel, key=rel.get)
    norm_rel = abs(norm_k - norm_p) / norm_p
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    finite = all(torch.isfinite(v).all() for v in grads_k.values())
    if not (finite and rel[worst] <= GRAD_TOL and norm_rel <= GRAD_TOL and loss_rel <= GRAD_TOL):
        raise AssertionError(f"gradient cross-check: worst leaf {worst} {rel[worst]:.3e}, norm "
                             f"{norm_rel:.3e}, loss {loss_rel:.3e} (tolerance {GRAD_TOL}), "
                             f"finite {finite}")
    return dict(loss=loss_k, loss_rel=loss_rel, norm=norm_k, norm_rel=norm_rel,
                worst_leaf=worst, worst_rel=rel[worst], leaves=len(rel), nsamples=nsamples,
                launches=launches_k)


def step_launches(nsamples: int = 1, f32: bool = False):
    """Kernel launches of one forward+backward: the encoder's forward and
    backward sweep, and per decoder chunk of IW_CHUNK samples its forward,
    backward sweep, grad-mode CE and CE backward; above one chunk each
    chunk's forward (LSTM and CE) runs again in the backward
    (``torch.utils.checkpoint``). With ``f32`` (wh in f32) the LSTM
    launches are the f32 kernels' (``*_f32``) and the bf16 ones' none."""
    chunks = -(-nsamples // IW_CHUNK)
    fwd = 2 if chunks > 1 else 1
    lstm = {"lstm_fwd_residuals": 1 + fwd * chunks, "lstm_bwd": 1 + chunks}
    if f32:
        lstm = {**{k + "_f32": v for k, v in lstm.items()}, **{k: 0 for k in lstm}}
    return {**lstm, "ce_fwd_train": fwd * chunks, "ce_bwd": chunks}


GRAD_TOL = 5e-2
TRACE_STEPS = 3


def trace_steps(train_pool, cfg, dev):
    """Three forward+backward steps (the gradient cross-check's step, its
    weights unscaled) under ``torch.profiler`` after one warm-up step
    (``profiled``)."""
    from vae_lagging_encoder_tpu_torch.models import build_text_vae
    from vae_lagging_encoder_tpu_torch.train.aggressive import make_grad_on
    from vae_lagging_encoder_tpu_torch.train.epoch import make_loss_fn

    vae = build_text_vae(cfg, VOCAB, device=dev, generator=torch.Generator().manual_seed(13))
    grad_on = make_grad_on(vae, make_loss_fn(vae, nsamples=1, train=True))
    g = torch.Generator(device=dev).manual_seed(14)

    def draw(site, shape):
        return (torch.randn if site == "eps" else torch.rand)(shape, generator=g, device=dev)

    def step(i):
        with torch.enable_grad():
            grad_on(train_pool.batch(i % train_pool.num_batches), draw, 0.5)

    step(0)
    torch.cuda.synchronize()
    return profiled(lambda: [step(i + 1) for i in range(TRACE_STEPS)], steps=TRACE_STEPS)


def profiled(fn, cpu: bool = True, **head):
    """``fn()`` under ``torch.profiler``, ending in a synchronize; its Chrome
    trace distilled by ``utils/profiling.py::distill_trace``, the summarizer
    of ``--profile_dir``'s ``DOSSIER.md``: the top device ops by self time,
    the device-busy time, the device's idle share, the part of the window's
    host wall time that no device op covers (1 - busy / wall), the host's
    calls that launched work (``utils/profiling.py::LAUNCH_APIS``, by name; CUPTI records them
    with the device activity) and the port's kernels counted by name among
    the device events (``port_kernel_calls``). ``cpu=False`` leaves out the
    host's operator events, which make an eager window's trace slow to
    export and read. The primer and the postamble (``utils/profiling.py``:
    ``primer``, ``PRIMER_*``) run around the window and are cut from the
    trace (``window_trace``); every launch call of the window must have its
    device events there."""
    from torch.profiler import ProfilerActivity, profile

    from vae_lagging_encoder_tpu_torch.utils.profiling import (PRIMER_PAUSE_S, distill_trace,
                                                               primer, window_trace)

    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        primer()
        time.sleep(PRIMER_PAUSE_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PRIMER_PAUSE_S)
        primer()  # the postamble
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "window.pt.trace.json.gz"
        prof.export_chrome_trace(str(path))
        calls, untraced = window_trace(path)
        summary = distill_trace(td, steps=head.get("steps", 1))
    if untraced:
        raise AssertionError(f"{len(untraced)} launch calls of the profiled window have no "
                             f"device events in its trace: {untraced[:8]}")
    if summary is None:
        return {**head, "device_time": "none: the trace has no device timeline",
                "wall_ms": wall_ms, "launch_calls": calls}
    busy = summary["device_busy_ms"]
    return {**head, "wall_ms": wall_ms, "device_busy_ms": busy, "launch_calls": calls,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "port_kernel_calls": {**{r["op"]: r["calls"] for r in summary["table"]
                                     if r["category"] == "port kernel"},
                                  **{k: r["calls"] for k, r in summary["launches"].items()}},
            "top_device_ops": [{k: r[k] for k in ("op", "category", "calls", "ms_total",
                                                  "pct_device")}
                               for r in summary["table"][:10]]}


def trace_iw(pool, ck, cfg, vocab_size, dev):
    """One IW-NLL batch (the first test batch, ``cfg.iw_nsamples`` samples
    in chunks of ``cfg.iw_batch``, the smoke checkpoint's weights) under
    ``torch.profiler`` after one untraced warm-up batch."""
    from vae_lagging_encoder_tpu_torch.models import build_text_vae
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

    vae = build_text_vae(cfg, vocab_size, device=dev)
    vae.load_state_dict(from_jax_params(load_checkpoint(str(ck))[0]))
    x, mask, _ = next(iter(pool))
    g = torch.Generator(device=dev).manual_seed(15)

    def batch():
        with torch.no_grad():
            vae.nll_iw(x, mask, cfg.iw_nsamples, cfg.iw_batch, generator=g)

    batch()
    torch.cuda.synchronize()
    return profiled(batch, batches=1, sentences=int(x.shape[0]), iw_nsamples=cfg.iw_nsamples)


# ---------------------------------------------------------------- phase 5
IMG_SPLITS = {"train": 400, "val": 100, "test": 200}  # 8 training batches of 50
IMG_NZ = 32
IMG_TRAIN_IW = 100       # --iw_nsamples of the training runs' final evaluations
IMG_CROSS_ROWS, IMG_CROSS_IW = 16, 30  # IW cross-check: 2 chunks of 25, the second padded
# Card against the port's CPU f32 path, both f32 with TF32 off, on the same
# weights, binarization and eps: only the order of the sums (cuDNN's
# algorithms against the CPU's) differs. Per-image BCE sums of ~100-300
# nats then agree to ~1e-6 relative; gradients, sums over 50 x 784 pixels,
# to ~1e-5 of each leaf's scale. TF32 (10-bit mantissa) would miss both by
# ~10x.
IMG_LOSS_RTOL = 2e-5
IMG_GRAD_TOL = 2e-4      # of each leaf's largest entry, and of the global norm
IMG_IW_RTOL = 2e-5       # per-image IW-NLL


def write_omniglot_npz(path: Path):
    """The port's synthetic OmniGlot substitute (class-structured glyphs;
    train, val and test on disjoint prototypes) at IMG_SPLITS' sizes."""
    from vae_lagging_encoder_tpu_torch.data import omniglot as og

    sizes, og._SYNTH_SIZES = og._SYNTH_SIZES, dict(IMG_SPLITS)
    try:
        data = og._synthetic_omniglot(seed=1)
    finally:
        og._SYNTH_SIZES = sizes
        og._SYNTH_CACHE.pop(1, None)
    np.savez(path, **data)
    return data


def run_image_cli(argv, exp_dir: Path):
    """``run_cli`` of ``cli.image``: the launches, the per-epoch metrics, the
    test results and the per-evaluator seconds, the wall seconds and the
    peak device memory."""
    from vae_lagging_encoder_tpu_torch.cli import image as cli_image

    launches, records, wall = run_cli(cli_image.main, argv, exp_dir, "cli.image")
    return dict(launches=launches, epochs=[r for r in records if "val_loss" in r],
                results=next(r for r in records if r.get("split") == "test"),
                seconds=next(r for r in records if r.get("split") == "test_seconds"),
                wall=wall, max_memory_allocated=torch.cuda.max_memory_allocated())


def check_image_results(name, run):
    res = run["results"]
    vals = [res[k] for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "iw_ppl")] + \
        [e[k] for e in run["epochs"] for k in ("train_loss", "val_loss")]
    if not all(math.isfinite(v) for v in vals) or not 0 <= res["au"] <= IMG_NZ:
        raise AssertionError(f"image {name}: non-finite or out-of-range results {res}")
    if any(run["launches"].values()):
        raise AssertionError(f"image {name}: the image path launched a text kernel "
                             f"{run['launches']}")


def run_image_slice(tmp: Path, dev):
    """Phase 5: the aggressive run, one plain epoch and ``--eval`` of the
    best checkpoint through ``cli.image.main`` at the full OmniGlot config."""
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.models import build_image_vae
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

    npz = tmp / "omniglot.npz"
    data = write_omniglot_npz(npz)
    cfg = get_config("omniglot", train_data=str(npz))
    runs = {}
    for name, extra in (("aggressive", ["--epochs", "2", "--aggressive", "1"]),
                        ("plain", ["--epochs", "1", "--aggressive", "0"])):
        ck = tmp / f"image_{name}.ckpt"
        argv = ["--dataset", "omniglot", "--train_data", str(npz), *extra, "--warm_up", "1",
                "--kl_start", "0.1", "--iw_nsamples", str(IMG_TRAIN_IW), "--save_path", str(ck)]
        runs[name] = run_image_cli(argv, tmp / f"exp_image_{name}")
        check_image_results(name, runs[name])
        log(f"[image] {name}: epochs {json.dumps(runs[name]['epochs'])}; results "
            f"{json.dumps(runs[name]['results'])}; whole CLI {runs[name]['wall']:.2f} s")
        params, extra_state = load_checkpoint(str(ck))
        vae = build_image_vae(cfg, device=dev)
        vae.load_state_dict(from_jax_params(params))  # strict: every name and shape
        if "opt_state" not in extra_state or extra_state["epoch"] not in range(
                len(runs[name]["epochs"])):
            raise AssertionError(f"image {name}: checkpoint extras {sorted(extra_state)}")
    ck = tmp / "image_aggressive.ckpt"
    runs["eval"] = run_image_cli(["--dataset", "omniglot", "--train_data", str(npz), "--eval",
                                  "--load_path", str(ck)], tmp / "exp_image_eval")
    check_image_results("eval", runs["eval"])
    steps = {mode: [e["steps_per_sec"] for r in (runs["aggressive"], runs["plain"])
                    for e in r["epochs"] if bool(e["epoch_aggressive"]) == (mode == "aggressive")]
             for mode in ("aggressive", "plain")}
    return runs, steps, data, ck, cfg


def image_cross_check(data, ck, cfg, dev):
    """One training batch (loss and every gradient leaf) and the IW-NLL of
    IMG_CROSS_ROWS test images at IMG_CROSS_IW samples, on the card and with
    the port's CPU f32 path, on the best checkpoint's weights and the same
    binarization and eps."""
    from vae_lagging_encoder_tpu_torch.models import build_image_vae
    from vae_lagging_encoder_tpu_torch.train.aggressive import grads_of, make_grad_on
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    from vae_lagging_encoder_tpu_torch.train.epoch import make_image_loss_fn
    from vae_lagging_encoder_tpu_torch.train.optim import clip_scale
    from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

    g = torch.Generator().manual_seed(21)
    probs = torch.from_numpy(data["train"][:cfg.batch_size])
    rw = torch.ones(cfg.batch_size)
    draws = {"bin": torch.rand(probs.shape, generator=g),
             "eps": torch.randn((cfg.batch_size, 1, IMG_NZ), generator=g)}
    x_iw = (torch.rand((IMG_CROSS_ROWS, 28, 28, 1), generator=g)
            < torch.from_numpy(data["test"][:IMG_CROSS_ROWS])).float()
    eps_iw = torch.randn((IMG_CROSS_ROWS, IMG_CROSS_IW, IMG_NZ), generator=g)
    params = from_jax_params(load_checkpoint(str(ck))[0])

    def run(device):
        vae = build_image_vae(cfg, device=device)
        vae.load_state_dict(params)
        grad_on = make_grad_on(vae, make_image_loss_fn(vae, nsamples=1, train=True))
        with torch.enable_grad():
            aux = grad_on((probs.to(device), rw.to(device)),
                          lambda site, shape: draws[site].to(device), 0.7)
        grads = {k: v.double().cpu() for k, v in grads_of(dict(vae.named_parameters())).items()}
        with torch.no_grad():
            nll = vae.nll_iw(x_iw.to(device), None, IMG_CROSS_IW, IMG_CROSS_IW,
                             noise=lambda j, shape: eps_iw.to(device))
        return (float(aux[0].detach()), grads, float(clip_scale(grads, cfg.clip_grad)[1]),
                nll.double().cpu())

    loss_c, grads_c, norm_c, nll_c = run(dev)
    loss_p, grads_p, norm_p, nll_p = run("cpu")
    rel = {k: float((grads_c[k] - grads_p[k]).abs().max()) / max(float(grads_p[k].abs().max()),
                                                                  1e-30) for k in grads_p}
    worst = max(rel, key=rel.get)
    out = dict(loss=loss_c, loss_rel=abs(loss_c - loss_p) / abs(loss_p), norm=norm_c,
               norm_rel=abs(norm_c - norm_p) / norm_p, worst_leaf=worst, worst_rel=rel[worst],
               leaves=len(rel), iw_nll_mean=float(nll_c.mean()),
               iw_rel=float(((nll_c - nll_p).abs() / nll_p.abs()).max()))
    finite = all(torch.isfinite(v).all() for v in grads_c.values()) and bool(
        torch.isfinite(nll_c).all())
    if not (finite and out["loss_rel"] <= IMG_LOSS_RTOL and rel[worst] <= IMG_GRAD_TOL
            and out["norm_rel"] <= IMG_GRAD_TOL and out["iw_rel"] <= IMG_IW_RTOL):
        raise AssertionError(f"image cross-check against the CPU: {out} (tolerances loss "
                             f"{IMG_LOSS_RTOL}, gradients {IMG_GRAD_TOL}, IW {IMG_IW_RTOL}), "
                             f"finite {finite}")
    return out


def trace_image(data, ck, cfg, dev):
    """``{"trace_image"}``: three training steps (forward+backward, B 50)
    after one warm-up step; ``{"trace_image_iw"}``: one IW-NLL batch (50
    test images, ``cfg.iw_nsamples`` samples in chunks of ``cfg.iw_batch``)
    after one warm-up batch. Both on the best checkpoint's weights."""
    from vae_lagging_encoder_tpu_torch.models import build_image_vae
    from vae_lagging_encoder_tpu_torch.train.aggressive import make_grad_on
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    from vae_lagging_encoder_tpu_torch.train.epoch import make_image_loss_fn
    from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

    vae = build_image_vae(cfg, device=dev)
    vae.load_state_dict(from_jax_params(load_checkpoint(str(ck))[0]))
    g = torch.Generator(device=dev).manual_seed(22)
    probs = torch.from_numpy(data["train"][:cfg.batch_size]).to(dev)
    rw = torch.ones(cfg.batch_size, device=dev)
    grad_on = make_grad_on(vae, make_image_loss_fn(vae, nsamples=1, train=True))

    def draw(site, shape):
        return (torch.rand if site == "bin" else torch.randn)(shape, generator=g, device=dev)

    def step():
        with torch.enable_grad():
            grad_on((probs, rw), draw, 0.5)

    step()
    torch.cuda.synchronize()
    train = profiled(lambda: [step() for _ in range(TRACE_STEPS)], steps=TRACE_STEPS)
    x = (torch.rand(probs.shape, generator=g, device=dev)
         < torch.from_numpy(data["test"][:cfg.batch_size]).to(dev)).float()

    def batch():
        with torch.no_grad():
            vae.nll_iw(x, None, cfg.iw_nsamples, cfg.iw_batch, generator=g)

    batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iw = profiled(batch, batches=1, images=int(x.shape[0]), iw_nsamples=cfg.iw_nsamples)
    iw["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return train, iw


# ---------------------------------------------------------------- phase 6
GEN_N, GEN_LEN = 32, 100       # --num_samples and --max_decode_len of the prior runs
GEN_REC_N = 224                # --num_samples of the reconstructions: the 7 test batches
GEN_BEAM_ROWS = 8              # rows of the beam cross-check (the CPU side is slow)
# Card against the port's CPU path, f32 on both (TF32 off), the order of
# the sums aside: a decode step's logits (O(10)) agree to ~1e-5. A chosen token's logit (+ Gumbel) must be within this of
# the CPU's maximum at its step; a beam hypothesis that differs must score
# (length-normalized log-prob, rescored on the CPU) within it of the CPU's.
GEN_TOL = 1e-4
IMG_GEN_N = 50
IMG_DENSE_N = 4                # images of the dense sampler
IMG_TIE = 1e-5                 # |u - sigmoid(logit)| below which a pixel may flip
# PixelCNN logits: incremental against dense on the card, both against the
# CPU's dense logits; f32 with TF32 off everywhere, so only the order of
# the sums differs: ~1e-6 on logits of O(1) (measured on an H100 80GB
# HBM3 at 700 W); 100x that leaves room for cuDNN's choice of algorithm.
IMG_LOGIT_TOL = 1e-4
TOY_TRAIN, TOY_EPOCHS, TOY_PLOT = 96, 2, 96  # training sentences, epochs, probe sentences
TOY_TOL = 1e-4                 # epoch -1 pairs, card against the CPU


def run_text_generation(tmp: Path, train_path: Path, test_path: Path, ck: Path, cfg):
    """6a: ``cli.text.main`` with ``--sample_from_prior`` (greedy, sample,
    beam) and ``--reconstruct`` (greedy, beam) on phase 4's best checkpoint;
    line counts and launch counts checked, sentences/s from the CLI's record."""
    from vae_lagging_encoder_tpu_torch.cli import text as cli_text
    from vae_lagging_encoder_tpu_torch.data import MonoTextData

    vocab = MonoTextData(str(train_path), label=True).vocab
    test_batches = MonoTextData(str(test_path), label=True, vocab=vocab).create_data_batch(
        cfg.batch_size, cfg.length_buckets)
    out = {}
    for mode, strategy in (("sample_from_prior", "greedy"), ("sample_from_prior", "sample"),
                           ("sample_from_prior", "beam"), ("reconstruct", "greedy"),
                           ("reconstruct", "beam")):
        prior = mode == "sample_from_prior"
        n = GEN_N if prior else GEN_REC_N
        path = tmp / f"gen_{mode}_{strategy}.txt"
        argv = ["--dataset", "yahoo", f"--{mode}", "--decoding_strategy", strategy,
                "--load_path", str(ck), "--num_samples", str(n), "--max_decode_len",
                str(GEN_LEN), "--output_file", str(path), "--train_data", str(train_path),
                "--test_data", str(test_path)]
        launches, records, wall = run_cli(cli_text.main, argv, tmp / f"exp_gen_{mode}_{strategy}",
                                          "cli.text")
        rec = next(r for r in records if r.get("split") == "generate")
        lines = path.read_text().split("\n")[:-1]
        n_batches = 0 if prior else len(test_batches[:-(-n // cfg.batch_size)])
        want_lines = n if prior else min(n, int(sum(b.row_weight.sum()
                                                    for b in test_batches[:n_batches])))
        want = {k: 0 for k in launches}
        want["lstm_fwd_infer"] = n_batches  # the encoder, once per test batch
        if len(lines) != want_lines or rec["sentences"] != want_lines or launches != want:
            raise AssertionError(f"cli.text {mode} {strategy}: {len(lines)} lines (expected "
                                 f"{want_lines}), launches {launches} (expected {want})")
        key = f"{'prior' if prior else 'reconstruct'}_{strategy}"
        out[key] = dict(sentences=len(lines), seconds=rec["seconds"],
                        sentences_per_sec=len(lines) / rec["seconds"], cli_wall=wall,
                        launches=launches, words=sum(len(l.split()) for l in lines),
                        first_line=lines[0][:120] if lines else "")
        log(f"[generate] text {key}: {json.dumps(out[key])}")
    return out


def gumbel_cpu(step: int, shape):
    """Step ``step``'s Gumbel draws, made on the CPU from a seed of their own
    (the same for the card and the CPU run)."""
    g = torch.Generator().manual_seed(1000 + step)
    u = torch.rand(shape, generator=g).clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def teacher_forced_gaps(dec, z, toks, noise):
    """The card's tokens ``toks`` [N, L] fed through the CPU decoder ``dec``:
    per live step, the CPU's max of logits (+ noise) minus the chosen
    token's; returns the largest gap and the rows where the CPU's argmax
    differs somewhere."""
    from vae_lagging_encoder_tpu_torch.data.vocab import BOS_ID, EOS_ID
    from vae_lagging_encoder_tpu_torch.models.lstm_core import lstm_bias

    N, L = toks.shape
    h, c = dec._init_state(z)
    bias = lstm_bias(dec.lstm)
    tok = torch.full((N,), BOS_ID, dtype=torch.long)
    done = torch.zeros(N, dtype=torch.bool)
    worst, differ = 0.0, torch.zeros(N, dtype=torch.bool)
    for t in range(L):
        logits, h, c = dec._step(tok, z, h, c, bias)
        if noise is not None:
            logits = logits + noise(t, tuple(logits.shape))
        chosen = toks[:, t]
        gap = logits.max(-1).values - logits.gather(1, chosen[:, None])[:, 0]
        live = ~done
        if live.any():
            worst = max(worst, float(gap[live].max()))
        differ |= live & (chosen != logits.argmax(-1))
        tok = chosen
        done = done | (chosen == EOS_ID)
    return worst, int(differ.sum())


def rescore_cpu(dec, z_row, seq):
    """Length-normalized log-prob of ``seq`` (<s> .. ) under the CPU decode step."""
    from vae_lagging_encoder_tpu_torch.models.lstm_core import lstm_bias

    h, c = dec._init_state(z_row[None])
    bias = lstm_bias(dec.lstm)
    total = 0.0
    for a, b in zip(seq[:-1], seq[1:]):
        logits, h, c = dec._step(torch.tensor([a]), z_row[None], h, c, bias)
        total += float(torch.log_softmax(logits[0].double(), -1)[b])
    return total / len(seq)


def text_generation_cross_check(ck, cfg, dev, scale: float = 1.0):
    """Greedy, sample (on shared Gumbel draws) and beam decoding on the card
    against the port's CPU path on the same z, tolerant of near-ties; the
    checkpoint's weights times ``scale``."""
    from vae_lagging_encoder_tpu_torch.models import build_text_vae
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

    params = {k: v * scale for k, v in from_jax_params(load_checkpoint(str(ck))[0]).items()}
    vae_c, vae_p = (build_text_vae(cfg, VOCAB, device=d) for d in (dev, "cpu"))
    vae_c.load_state_dict(params)
    vae_p.load_state_dict(params)
    z = torch.randn((GEN_N, NZ), generator=torch.Generator().manual_seed(31))
    zc = z.to(dev)
    out = {}
    with torch.no_grad():
        for name, noise in (("greedy", None), ("sample", gumbel_cpu)):
            card_noise = None if noise is None else (lambda t, shape: gumbel_cpu(t, shape).to(dev))
            toks = vae_c.dec._generate(zc, GEN_LEN, card_noise).cpu()
            gap, differ = teacher_forced_gaps(vae_p.dec, z, toks, noise)
            out[name] = dict(max_gap=gap, rows_differing=differ, rows=GEN_N)
            if not gap <= GEN_TOL:
                raise AssertionError(f"{name} decoding: a chosen token is {gap} below the CPU's "
                                     f"maximum (tolerance {GEN_TOL})")
        zb = z[:GEN_BEAM_ROWS]
        card = vae_c.dec.beam_search_decode(zb.to(dev), 5, GEN_LEN)
        cpu = vae_p.dec.beam_search_decode(zb, 5, GEN_LEN)
        gaps = [abs(rescore_cpu(vae_p.dec, zb[n], a) - rescore_cpu(vae_p.dec, zb[n], b))
                for n, (a, b) in enumerate(zip(card, cpu)) if a != b]
        out["beam"] = dict(rows=GEN_BEAM_ROWS, rows_differing=len(gaps),
                           max_score_gap=max(gaps, default=0.0),
                           lengths=[len(a) for a in card])
        if not max(gaps, default=0.0) <= GEN_TOL:
            raise AssertionError(f"beam: hypotheses differ by {max(gaps)} in normalized score "
                                 f"(tolerance {GEN_TOL})")
    return out


def png_size(path: Path):
    blob = path.read_bytes()
    if blob[:8] != b"\x89PNG\r\n\x1a\n" or blob[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return tuple(int.from_bytes(blob[a:a + 4], "big") for a in (16, 20))  # (width, height)


def run_image_generation(tmp: Path, npz: Path, ck: Path):
    """6b: ``cli.image.main`` with ``--sample_from_prior`` and
    ``--reconstruct`` (50 each) on phase 5's best checkpoint."""
    from vae_lagging_encoder_tpu_torch.cli import image as cli_image

    out = {}
    for mode, cells in (("sample_from_prior", IMG_GEN_N), ("reconstruct", 2 * IMG_GEN_N)):
        png = tmp / f"gen_{mode}.png"
        argv = ["--dataset", "omniglot", "--train_data", str(npz), f"--{mode}",
                "--num_samples", str(IMG_GEN_N), "--load_path", str(ck), "--output_file", str(png)]
        launches, records, wall = run_cli(cli_image.main, argv, tmp / f"exp_gen_{mode}",
                                          "cli.image")
        rec = next(r for r in records if r.get("split") == "generate")
        size = png_size(png)
        want = (10 * 30, -(-cells // 10) * 30)  # 10 columns of 28 + 2 border pixels
        if size != want or any(launches.values()) or rec["images"] != IMG_GEN_N:
            raise AssertionError(f"cli.image {mode}: PNG {size} (expected {want}), launches "
                                 f"{launches}, record {rec}")
        key = "prior" if mode == "sample_from_prior" else "reconstruct"
        out[key] = dict(images=IMG_GEN_N, seconds=rec["seconds"],
                        images_per_sec=IMG_GEN_N / rec["seconds"], cli_wall=wall,
                        png=list(size), launches=launches)
        log(f"[generate] image {key}: {json.dumps(out[key])}")
    return out


def image_generation_cross_check(ck, cfg, dev):
    """The sampled canvas teacher-forced through the incremental sampler on
    the card against the dense logits on the card and on the CPU; the dense
    sampler on IMG_DENSE_N images against the fast one on the same uniforms."""
    from vae_lagging_encoder_tpu_torch.models import build_image_vae
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

    params = from_jax_params(load_checkpoint(str(ck))[0])
    vae_c, vae_p = (build_image_vae(cfg, device=d) for d in (dev, "cpu"))
    vae_c.load_state_dict(params)
    vae_p.load_state_dict(params)
    z = torch.randn((IMG_GEN_N, IMG_NZ), generator=torch.Generator().manual_seed(41))
    zc = z.to(dev)
    with torch.no_grad():
        canvas = vae_c.dec.sample(zc, generator=torch.Generator(dev).manual_seed(42))
        _, inc = vae_c.dec._incremental_pixels(zc, force_image=canvas)
        dense = vae_c.dec._logits(canvas, zc)
        dense_cpu = vae_p.dec._logits(canvas.cpu(), z)
        errs = dict(incremental_vs_dense=float((inc - dense).abs().max()),
                    dense_vs_cpu=float((dense.cpu() - dense_cpu).abs().max()),
                    incremental_vs_cpu=float((inc.cpu() - dense_cpu).abs().max()),
                    max_abs_logit=float(dense_cpu.abs().max()),
                    ink=float(canvas.mean()))
        if not max(errs[k] for k in ("incremental_vs_dense", "dense_vs_cpu",
                                     "incremental_vs_cpu")) <= IMG_LOGIT_TOL:
            raise AssertionError(f"PixelCNN logits: {errs} (tolerance {IMG_LOGIT_TOL})")
        H, W, C = cfg.img_size
        us = torch.rand((H * W, IMG_DENSE_N, C),
                        generator=torch.Generator().manual_seed(43)).to(dev)
        z4 = zc[:IMG_DENSE_N]
        t0 = time.perf_counter()
        fast = vae_c.dec.sample(z4, noise=lambda p, shape: us[p])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dense_s = vae_c.dec.sample(z4, noise=lambda p, shape: us[p], fast=False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, fast_logits = vae_c.dec._incremental_pixels(z4, force_image=fast)
        prob = torch.sigmoid(fast_logits).reshape(IMG_DENSE_N, H * W)
        diff = (fast != dense_s).reshape(IMG_DENSE_N, H * W)
        u = us[:, :, 0].T
        excused = 0
        for n in range(IMG_DENSE_N):  # after a near-tie flips, the rest may differ
            hits = torch.nonzero(diff[n])
            if len(hits):
                p = int(hits[0])
                if not float((u[n, p] - prob[n, p]).abs()) < IMG_TIE:
                    raise AssertionError(f"dense sampler image {n} differs from the fast one at "
                                         f"pixel {p}, |u - p| = "
                                         f"{float((u[n, p] - prob[n, p]).abs())}")
                excused += 1
    errs.update(dense_sampler_pixels_differing=int(diff.sum()), images_excused=excused,
                fast_sampler_ms=(t1 - t0) * 1e3, dense_sampler_ms=(t2 - t1) * 1e3,
                dense_images=IMG_DENSE_N)
    return errs


def run_toy(tmp: Path):
    """6c: the corpus written by the port's ``ensure_synthetic_dataset`` in a
    directory without one, then ``cli.toy.main`` with ``--aggressive 0`` and
    ``1`` on a training split cut to TOY_TRAIN sentences; the pickles are
    read back and the epoch -1 pairs held against the CPU path."""
    import os
    import pickle

    from vae_lagging_encoder_tpu_torch.cli import toy as cli_toy
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.data import BucketedPool, MonoTextData
    from vae_lagging_encoder_tpu_torch.data.synthetic import ensure_synthetic_dataset
    from vae_lagging_encoder_tpu_torch.models import build_text_vae

    root = tmp / "toy"
    root.mkdir()
    cwd = os.getcwd()
    os.chdir(root)  # the synthetic config's paths are relative to the working directory
    try:
        t0 = time.perf_counter()
        paths = ensure_synthetic_dataset()
        corpus = {s: dict(bytes=Path(p).stat().st_size,
                          sentences=len(Path(p).read_text().splitlines()))
                  for s, p in paths.items()}
        corpus["seconds"] = time.perf_counter() - t0
        log(f"[toy] corpus {json.dumps(corpus)}")
        cut = root / "toy.train.txt"
        cut.write_text("".join(Path(paths["train"]).read_text().splitlines(True)[:TOY_TRAIN]))
        grid = cli_toy.z_grid(-20.0, 20.0, 0.1)
        cfg = get_config("synthetic", train_data=str(cut))
        train = MonoTextData(str(cut), label=True)
        pool = BucketedPool(train.create_data_batch(cfg.batch_size, cfg.length_buckets), "cpu")
        vae = build_text_vae(cfg, len(train.vocab), device="cpu")  # the CLI's seeded init
        want = cli_toy.probe_pairs(vae, cli_toy.probe_batches(pool, TOY_PLOT), grid, TOY_PLOT)
        runs = {}
        for aggr in (0, 1):
            argv = ["--dataset", "synthetic", "--train_data", str(cut), "--epochs",
                    str(TOY_EPOCHS), "--aggressive", str(aggr), "--plot_niter", "1",
                    "--num_plot", str(TOY_PLOT), "--plot_dir", "plots"]
            launches, records, wall = run_cli(cli_toy.main, argv, root / f"exp_toy{aggr}",
                                              "cli.toy")
            with open(f"plots/synthetic_aggr{aggr}_seed{cfg.seed}.pkl", "rb") as fh:
                trace = pickle.load(fh)
            pairs = [t["pairs"] for t in trace]
            ok = ([t["epoch"] for t in trace] == list(range(-1, TOY_EPOCHS))
                  and all(isinstance(a, np.ndarray) and a.dtype == np.float32
                          and a.shape == want.shape and np.isfinite(a).all()
                          and (a[:, 0] >= float(grid[0])).all()
                          and (a[:, 0] <= float(grid[-1])).all() for a in pairs))
            err = float(np.abs(pairs[0] - want).max())
            if not ok or err > TOY_TOL or any(launches.values()):
                raise AssertionError(f"toy aggressive {aggr}: pickle well-formed {ok}, epoch -1 "
                                     f"err {err} (tolerance {TOY_TOL}), launches {launches}")
            probes = [r["seconds"] for r in records if r.get("split") == "toy_probe"]
            epochs = [r for r in records if r.get("split") == "toy_epoch"]
            runs[f"aggressive{aggr}"] = dict(
                probe_seconds=probes, epoch_seconds=[e["seconds"] for e in epochs],
                steps_per_sec=[e["steps"] / e["seconds"] for e in epochs],
                inner_iters=[e["inner_iters"] for e in epochs], epoch_minus_1_err=err,
                cli_wall=wall, launches=launches,
                mean_abs_mu_last=float(np.abs(pairs[-1][:, 1]).mean()))
            log(f"[toy] aggressive {aggr}: {json.dumps(runs[f'aggressive{aggr}'])}")
    finally:
        os.chdir(cwd)
    return dict(corpus=corpus, train_sentences=TOY_TRAIN, train_batches=pool.num_batches,
                probe_sentences=TOY_PLOT, grid_points=int(grid.shape[0]), **runs)


# ---------------------------------------------------------------- phase 7
AUTOSAVE_NITER = 4    # 8 batches an epoch: autosaves at steps 4, 8, 12, 16
STOP_AFTER = 14       # epoch 1, step 6: the last autosave (step 12) is 2 steps behind
# The resumed run against the uninterrupted one on the card: the same
# kernels and library calls on the same inputs in the same order. Measured
# (NVIDIA H100 80GB HBM3, 700 W) to be bit for bit equal, so no difference
# is allowed.
RESUME_BOUND = 0.0
ENGLISH_DOCS = 2200   # docs_english cut from 22000 documents
ENGLISH_MAX_BATCHES = 8


def text_pools(train_path: Path, others, cfg, dev):
    """``BucketedPool``s of ``others`` on the vocabulary of ``train_path``."""
    from vae_lagging_encoder_tpu_torch.data import BucketedPool, MonoTextData

    vocab = MonoTextData(str(train_path), label=True).vocab
    return [BucketedPool(MonoTextData(str(f), label=True, vocab=vocab)
                         .create_data_batch(cfg.batch_size, cfg.length_buckets), dev)
            for f in others]


def max_param_diff(a: Path, b: Path):
    """The largest difference of two checkpoints' parameters, each leaf's
    relative to its largest entry, and the leaf where it is."""
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

    pa, pb = (from_jax_params(load_checkpoint(str(p))[0]) for p in (a, b))
    if pa.keys() != pb.keys():
        raise AssertionError(f"{a} and {b} hold different leaves")
    rel = {k: float((pa[k] - pb[k]).abs().max()) / max(float(pa[k].abs().max()), 1e-30)
           for k in pa}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def autosave_resume(tmp: Path, files, init_ck: Path):
    """7a: ``--epochs 2 --aggressive 1 --autosave_niter 4`` from phase 3's
    random model, uninterrupted; the same run stopped after STOP_AFTER steps
    (epoch 1), resumed with ``--resume --load_path <save_path>.auto`` to the
    end; and resumed again from the autosave that run wrote at the end of
    epoch 1 (its resumed epoch runs 0 steps) with ``--profile_dir``. Every
    epoch metric, final result and parameter of the resumed runs against the
    uninterrupted run's."""
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint

    base = ["--dataset", "yahoo", "--epochs", "2", "--aggressive", "1", "--warm_up", "1",
            "--kl_start", "0.1", "--iw_nsamples", str(TRAIN_IW), "--autosave_niter",
            str(AUTOSAVE_NITER), *files]
    full_ck, ck = tmp / "life_full.ckpt", tmp / "life_run.ckpt"
    auto = Path(str(ck) + ".auto")
    runs = {"full": run_train_cli([*base, "--load_path", str(init_ck), "--save_path",
                                   str(full_ck)], tmp / "exp_life_full")}
    runs["stopped"] = run_train_cli([*base, "--load_path", str(init_ck), "--save_path", str(ck)],
                                    tmp / "exp_life_stopped", stop=STOP_AFTER)
    mid = load_checkpoint(str(auto))[1]["mid_epoch"]
    if not (mid["epoch"] == 1 and mid["global_step"] == STOP_AFTER // AUTOSAVE_NITER
            * AUTOSAVE_NITER and runs["stopped"]["results"] is None):
        raise AssertionError(f"7a: the stopped run's autosave {mid}")
    resume = [*base, "--save_path", str(ck), "--resume", "--load_path", str(auto)]
    runs["resumed"] = run_train_cli(resume, tmp / "exp_life_resumed")
    mid2 = load_checkpoint(str(auto))[1]["mid_epoch"]
    if not (mid2["epoch"] == 1 and mid2["next_start"] == mid2["num_batches"]):
        raise AssertionError(f"7a: the resumed run's last autosave {mid2}")
    auto_diff = max_param_diff(Path(str(full_ck) + ".auto"), auto)
    prof = tmp / "profile_zero"
    runs["resumed_at_end"] = run_train_cli([*resume, "--profile_dir", str(prof)],
                                           tmp / "exp_life_end")
    full = runs["full"]
    hist_diff = 0.0
    for name in ("resumed", "resumed_at_end"):
        r = runs[name]
        if [e["epoch"] for e in r["epochs"]] != [1]:
            raise AssertionError(f"7a {name}: epochs {[e['epoch'] for e in r['epochs']]}")
        for k in ("train_loss", "val_loss", "val_kl", "kl_weight"):
            hist_diff = max(hist_diff, abs(r["epochs"][0][k] - full["epochs"][1][k]))
        for k in ("inner_iters", "aggressive", "lr"):
            if r["epochs"][0][k] != full["epochs"][1][k]:
                raise AssertionError(f"7a {name}: {k} {r['epochs'][0][k]} != "
                                     f"{full['epochs'][1][k]}")
        for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll"):
            hist_diff = max(hist_diff, abs(r["results"][k] - full["results"][k]))
    best_diff = max_param_diff(full_ck, ck)
    if (prof / "DOSSIER.md").exists():
        raise AssertionError("7a: a dossier was written for an epoch that ran 0 steps")
    worst = max(auto_diff[0], best_diff[0], hist_diff)
    out = dict(param_rel_diff_last_autosave=auto_diff[0], param_leaf_last_autosave=auto_diff[1],
               param_rel_diff_best=best_diff[0], param_leaf_best=best_diff[1],
               history_and_results_max_abs_diff=hist_diff, bound=RESUME_BOUND,
               stop_after=STOP_AFTER, autosave_niter=AUTOSAVE_NITER, resumed_from=mid,
               steps_per_sec_resumed=runs["resumed"]["epochs"][0]["steps_per_sec"],
               autosaves_full={e["epoch"]: [e["autosaves"], e["autosave_seconds"]]
                               for e in full["epochs"]},
               walls={k: r["wall"] for k, r in runs.items()},
               zero_step_trace=sorted(p.name for p in prof.iterdir()))
    log(f"[lifecycle] 7a autosave/resume: {json.dumps(out)}")
    if not worst <= RESUME_BOUND:
        raise AssertionError(f"7a: the resumed run differs from the uninterrupted one by "
                             f"{worst} (bound {RESUME_BOUND})")
    return out, runs


def train_nsamples(tmp: Path, files, train_pool, val_pool, test_pool, cfg, dev):
    """7b: one plain epoch of ``--nsamples 40`` (two decoder chunks of 20)
    through ``cli.text``; launch counts, steps/s and peak memory; then one
    step's loss and gradients against the plain versions on the card."""
    argv = ["--dataset", "yahoo", "--epochs", "1", "--aggressive", "0", "--warm_up", "1",
            "--kl_start", "0.1", "--iw_nsamples", str(TRAIN_IW), "--nsamples", str(NSAMPLES),
            "--save_path", str(tmp / "nsamples.ckpt"), *files]
    run = run_train_cli(argv, tmp / "exp_nsamples")
    want = expected_train_launches(run["epochs"], train_pool.num_batches, val_pool, test_pool,
                                   cfg, nsamples=NSAMPLES)
    vals = [run["results"][k] for k in ("elbo_loss", "rec", "kl", "iw_nll")] + \
        [run["epochs"][0][k] for k in ("train_loss", "val_loss")]
    if {k: run["launches"][k] for k in want} != want or not all(map(math.isfinite, vals)):
        raise AssertionError(f"7b: launches {run['launches']} (expected {want}) or "
                             f"non-finite values {vals}")
    gx = grad_cross_check(train_pool, cfg, dev, nsamples=NSAMPLES)
    out = dict(steps_per_sec=run["epochs"][0]["steps_per_sec"], launches=run["launches"],
               launches_per_step=step_launches(NSAMPLES),
               max_memory_allocated=run["max_memory_allocated"], wall=run["wall"],
               results=run["results"], grad_cross_check=gx, grad_tolerance=GRAD_TOL)
    log(f"[lifecycle] 7b --nsamples {NSAMPLES}: {json.dumps(out)}")
    return out, run


def profile_epoch(tmp: Path, files, train_pool):
    """7c: ``--profile_dir`` on one plain epoch through ``cli.text``; the
    dossier's steps are the epoch's and its top ops name the port's
    training kernels."""
    prof = tmp / "profile_epoch"
    argv = ["--dataset", "yahoo", "--epochs", "1", "--aggressive", "0", "--warm_up", "1",
            "--kl_start", "0.1", "--iw_nsamples", str(TRAIN_IW), "--profile_dir", str(prof),
            "--save_path", str(tmp / "profiled.ckpt"), *files]
    run = run_train_cli(argv, tmp / "exp_profiled")
    summary = json.loads((prof / "DOSSIER.json").read_text())
    top = [r["op"] for r in summary["table"][:15]]
    need = ("lstm_bwd", "lstm_fwd_residuals", "ce_fwd_train")
    if not ((prof / "DOSSIER.md").exists() and summary["steps"] == train_pool.num_batches
            and all(k in top for k in need)):
        raise AssertionError(f"7c: dossier steps {summary['steps']}, top ops {top}")
    out = dict(steps=summary["steps"], device_busy_ms=summary["device_busy_ms"],
               ms_per_step_device=summary["ms_per_step_device"],
               categories=summary["categories"],
               top_ops=[{k: r[k] for k in ("op", "category", "ms_per_step", "pct_device",
                                           "calls")} for r in summary["table"][:10]],
               wall=run["wall"], epoch_seconds=run["epochs"][0]["epoch_seconds"])
    log(f"[lifecycle] 7c dossier: {json.dumps(out)}")
    return out, run


def reference_checkpoints(tmp: Path, paths, init_ck: Path, phase3_results, pool, cfg):
    """7d: phase 3's random model exported in the reference's layout
    (``torch.save`` of ``export_torch_state_dict``) and as a legacy round-1
    pickle, each evaluated by ``cli.text --eval --load_path``: the same
    numbers as phase 3's evaluation of the ``.npz``; then ref.pt -> .npz ->
    ref2.pt through ``torch_import.main``, bit for bit."""
    import pickle

    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    from vae_lagging_encoder_tpu_torch.utils import torch_import

    params, _ = load_checkpoint(str(init_ck))
    ref, legacy = tmp / "ref.pt", tmp / "legacy_round1.ckpt"
    sd = torch_import.export_torch_state_dict(params)
    torch.save(sd, str(ref))
    with open(legacy, "wb") as fh:
        pickle.dump({"params": params, "extra": {"note": "random init"}}, fh, protocol=4)
    files = ["--train_data", str(paths["train"]), "--val_data", str(paths["valid"]),
             "--test_data", str(paths["test"])]
    runs, diffs = {}, {}
    want = expected_launches(pool, cfg)
    for name, path in (("reference_pt", ref), ("legacy_pickle", legacy)):
        runs[name] = run_train_cli(["--dataset", "yahoo", "--eval", "--load_path", str(path),
                                    *files], tmp / f"exp_{name}")
        res = runs[name]["results"]
        diffs[name] = {k: res[k] - phase3_results[k] for k in ("elbo_loss", "rec", "kl", "mi",
                                                                "au", "iw_nll")}
        if any(diffs[name].values()) or runs[name]["launches"] != want:
            raise AssertionError(f"7d {name}: results {res} against phase 3's "
                                 f"{phase3_results}; launches {runs[name]['launches']}")
    npz, ref2 = tmp / "ref_converted.ckpt", tmp / "ref2.pt"
    if torch_import.main([str(ref), str(npz)]) or torch_import.main([str(npz), str(ref2)]):
        raise AssertionError("7d: torch_import.main failed")
    back = torch.load(str(ref2), weights_only=True)
    same_pt = back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    same_npz = max_param_diff(init_ck, npz)[0] == 0.0
    if not (same_pt and same_npz):
        raise AssertionError(f"7d: round trip ref.pt -> .npz -> ref2.pt not exact "
                             f"(state_dict {same_pt}, npz {same_npz})")
    out = dict(results=runs["reference_pt"]["results"], differences=diffs,
               round_trip_exact=True, tensors=len(sd),
               walls={k: r["wall"] for k, r in runs.items()})
    log(f"[lifecycle] 7d reference checkpoints: {json.dumps(out)}")
    return out, runs


def docs_english(tmp: Path):
    """7e: the ``docs_english`` corpus built from this machine's
    site-packages by ``python -m vae_lagging_encoder_tpu_torch.data.english``
    (cut to ENGLISH_DOCS documents), then one plain epoch at the config
    (Yahoo widths) through ``cli.text`` on the longest prefix of the
    training split that makes at most ENGLISH_MAX_BATCHES batches."""
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.data import MonoTextData

    root = tmp / "docs_english_data"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "vae_lagging_encoder_tpu_torch.data.english",
                    "--num_sentences", str(ENGLISH_DOCS), "--root", str(root)],
                   check=True, cwd=str(Path(__file__).resolve().parent), timeout=600)
    build_s = time.perf_counter() - t0
    cfg = get_config("docs_english")
    lines = (root / "docs_english.train.txt").read_text().splitlines(keepends=True)
    cut = tmp / "docs_english.train_cut.txt"

    def batches(n):  # writes the cut of the first n documents; its batch count
        cut.write_text("".join(lines[:n]))
        return len(MonoTextData(str(cut), label=True).create_data_batch(cfg.batch_size,
                                                                        cfg.length_buckets))

    lo, hi = 1, len(lines)  # bisect: the batch count only grows with n
    if batches(hi) > ENGLISH_MAX_BATCHES:
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if batches(mid) <= ENGLISH_MAX_BATCHES else (lo, mid)
        hi = lo
    n = hi
    nb = batches(n)
    vocab = len(MonoTextData(str(cut), label=True).vocab)
    argv = ["--dataset", "docs_english", "--epochs", "1", "--aggressive", "0",
            "--iw_nsamples", str(TRAIN_IW), "--train_data", str(cut),
            "--val_data", str(root / "docs_english.valid.txt"),
            "--test_data", str(root / "docs_english.test.txt"),
            "--save_path", str(tmp / "docs_english.ckpt")]
    run = run_train_cli(argv, tmp / "exp_docs_english")
    vals = [run["results"][k] for k in ("elbo_loss", "rec", "kl", "iw_nll")]
    if not all(map(math.isfinite, vals)):
        raise AssertionError(f"7e: non-finite results {run['results']}")
    out = dict(documents=ENGLISH_DOCS, build_seconds=build_s, train_documents=n,
               train_batches=nb, vocab_size=vocab,
               steps_per_sec=run["epochs"][0]["steps_per_sec"], results=run["results"],
               wall=run["wall"], launches=run["launches"])
    log(f"[lifecycle] 7e docs_english: {json.dumps(out)}")
    return out, run


# ---------------------------------------------------------------- phase 8
PAR_RANKS = 2            # ranks sharing the one card over gloo
PAR_SEED = 4242
# The aggressive stretch of 8a: outer steps sized so that its forward+
# backward steps, each paying one flat all-reduce of the whole gradient
# through the host, fill about PAR_STRETCH_S seconds; an aggressive outer
# step takes 30-100 forward+backward steps (PERF.md section 1).
PAR_STRETCH_S = 20.0
PAR_STEPS_PER_OUTER = 60
PAR_MAX_OUTER = 3
# One DP outer step against the single-process emulated-DP oracle on the
# card, the same weights and each shard on its rank's draws: every rank
# runs its shard through the same kernels and library calls on the same
# inputs as the oracle's shard, so each shard's gradient is the oracle's
# bit for bit; the two differ in the order of the two partial sums of a
# leaf (a + b against b + a, exact in IEEE arithmetic), and the clip and
# the SGD update follow on equal gradients. Measured bit for bit on an
# NVIDIA H100 80GB HBM3 at 700 W; the bound leaves room for a library call
# that sums in another order from run to run (the embedding gradient's
# scatter): one f32 rounding of a parameter of O(0.1).
DP_STEP_TOL = 1e-6
# The image step (Adam) is held on its all-reduced gradient, relative to
# each leaf's largest entry: Adam's first update is g / (|g| + eps), which
# turns a last-bit difference of a near-zero entry into a visible one.
# cuDNN's backward may pick another algorithm per process (2e-4 covers
# the card against the CPU in phase 5; one order of sums against another
# on the card is far below it).
IMG_DP_GRAD_TOL = 2e-4
TP_N = CE_SPLIT_N        # 3040 rows, the training shape
TP_EVAL_RTOL = 5e-3      # the bf16-operand drift: the dense CE takes bf16 operands, TP f32


def par_sizes():
    """The widths of phase 8's checks (passed to the ranks, which import
    this file afresh): the Yahoo config's, the vocabulary of phase 4's
    corpus, the training CE's rows, and the OmniGlot config as it is."""
    return dict(text=dict(ni=NI, enc_nh=NH, dec_nh=NH, nz=NZ), vocab=VOCAB, tp_n=TP_N)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _phase8_rank(dev, corpus: str, npz: str, sizes):
    """The checks of phase 8 in one start of PAR_RANKS ranks on the card:
    (1) one outer DP step of the Yahoo-width text model on the first batch
    of phase 4's corpus (16 rows a rank), and the time of one flat
    all-reduce of its whole gradient; (2) one outer DP step of the OmniGlot
    model (25 rows a rank); (3) ``tp_token_logp`` forward and backward at
    N 3040, V 20004 over the two ranks. Rank 0 returns the text parameters
    and the image gradients; every rank its logp results and times."""
    import torch.distributed as dist

    from vae_lagging_encoder_tpu_torch.parallel import make_mesh, make_tp_mesh, reduce_grads
    from vae_lagging_encoder_tpu_torch.parallel import tp_token_logp

    out = {"rank": dist.get_rank()}
    mesh = make_mesh(PAR_RANKS, dev)
    vae, pool, cfg, loss_fn = _dp_step_setup("text", corpus, dev, sizes)
    pool.shard(mesh)
    aux = _one_step(vae, pool, cfg, loss_fn, mesh)
    params = dict(vae.named_parameters())
    times = []
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        reduce_grads(params, aux, mesh)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    out["allreduce_ms"] = sorted(times)[2] * 1e3
    out["allreduce_bytes"] = 4 * sum(p.numel() for p in params.values())
    if mesh.rank == 0:
        out["text_params"] = {k: v.detach().cpu() for k, v in vae.state_dict().items()}
        out["text_aux"] = [float(a) for a in aux]
    del vae, params, pool

    vae, pool, cfg, loss_fn = _dp_step_setup("image", npz, dev, sizes)
    pool.shard(mesh)
    aux = _one_step(vae, pool, cfg, loss_fn, mesh)
    if mesh.rank == 0:
        out["image_grads"] = {k: p.grad.detach().cpu() for k, p in vae.named_parameters()}
        out["image_aux"] = [float(a) for a in aux]
    del vae, pool

    tmesh = make_tp_mesh(1, PAR_RANKS, dev)
    h, pred, tgt, w = _tp_inputs(dev, sizes)
    vocab = sizes["vocab"]
    per = vocab // PAR_RANKS
    pl = pred[:, tmesh.tp_index * per:(tmesh.tp_index + 1) * per].clone().requires_grad_(True)
    hh = h.clone().requires_grad_(True)

    def fwd_bwd():
        hh.grad = pl.grad = None
        logp = tp_token_logp(hh, pl, tgt, vocab, tmesh.tp_group)
        (logp * w).sum().backward()
        return logp

    logp = fwd_bwd()
    out["tp_dpred"] = pl.grad.detach().cpu()
    out["tp_tp_index"] = tmesh.tp_index
    if mesh.rank == 0:
        out["tp_logp"] = logp.detach().cpu()
        out["tp_dh"] = hh.grad.detach().cpu()
    fwd_bwd()
    times = []
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        fwd_bwd()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    out["tp_logp_ms"] = sorted(times)[2] * 1e3
    return out


def _tp_inputs(dev, sizes):
    g = torch.Generator(device=dev).manual_seed(PAR_SEED)
    n, nh, vocab = sizes["tp_n"], sizes["text"]["dec_nh"], sizes["vocab"]
    h = torch.randn((n, nh), generator=g, device=dev)
    pred = torch.randn((nh, vocab), generator=g, device=dev) * 0.05
    tgt = torch.randint(0, vocab, (n,), generator=g, device=dev)
    w = torch.randn((n,), generator=g, device=dev)
    return h, pred, tgt, w


def _dp_step_setup(kind: str, data: str, dev, sizes):
    """The seeded model, the training pool (unsharded) and the loss of one
    DP step check: the Yahoo config on phase 4's corpus, or the OmniGlot
    config on phase 5's images."""
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.data import (BucketedPool, ImagePool, MonoTextData,
                                                    load_omniglot)
    from vae_lagging_encoder_tpu_torch.models import build_image_vae, build_text_vae
    from vae_lagging_encoder_tpu_torch.train.epoch import make_image_loss_fn

    if kind == "text":
        cfg = get_config("yahoo", seed=PAR_SEED, **sizes["text"])
        pool = BucketedPool(MonoTextData(data, label=True).create_data_batch(
            cfg.batch_size, cfg.length_buckets), dev)
        return build_text_vae(cfg, sizes["vocab"], device=dev), pool, cfg, None
    cfg = get_config("omniglot", train_data=data, seed=PAR_SEED, **sizes.get("image", {}))
    vae = build_image_vae(cfg, device=dev)
    pool = ImagePool(load_omniglot(data)[0], cfg.batch_size, dev)
    return vae, pool, cfg, make_image_loss_fn(vae, nsamples=1, train=True)


def _one_step(vae, pool, cfg, loss_fn, mesh, oracle_of: int = 0):
    """One outer step (joint encoder and decoder update) on flat batch 0:
    under ``mesh`` each rank on its rows with ``GeneratorNoise(PAR_SEED,
    fold=dp index)``; with ``oracle_of`` ranks and no mesh, the emulated-DP
    oracle on the whole batch. Returns the step's aux sums."""
    from vae_lagging_encoder_tpu_torch.parallel import EmulatedNoise, emulated_dp_loss
    from vae_lagging_encoder_tpu_torch.train.epoch import (GeneratorNoise, make_loss_fn,
                                                           make_train_epoch)

    dev = next(vae.parameters()).device
    if oracle_of:
        loss_fn = emulated_dp_loss(loss_fn or make_loss_fn(vae, nsamples=1, train=True),
                                   oracle_of)
        noise = EmulatedNoise([GeneratorNoise(PAR_SEED, dev, d) for d in range(oracle_of)])
    else:
        noise = GeneratorNoise(PAR_SEED, dev, mesh.dp_index)
    # eager: the caller reads the step's .grad, which a graph's step keeps to itself
    epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=loss_fn, mesh=mesh,
                                          graphs=False)
    _, _, sums, _ = epoch_fn(opt_init(), noise, np.float32(cfg.kl_start), float(cfg.lr),
                             np.arange(1), False)
    return tuple(sums.to(device=dev, dtype=torch.float32))  # f64 of f32 sums: exact


def parallel_checks(tmp: Path, dev):
    """8a/8b/8c's checks in one start of the ranks, then the oracles and the
    plain CE in this process on the same card."""
    from vae_lagging_encoder_tpu_torch.ops.ce_cuda import ce_logp_plain
    from vae_lagging_encoder_tpu_torch.parallel import run_ranks

    corpus, npz = str(tmp / "smoke.train.txt"), str(tmp / "omniglot.npz")
    sizes = par_sizes()
    t0 = time.perf_counter()
    outs = run_ranks(_phase8_rank, PAR_RANKS, dev.type, args=(corpus, npz, sizes), timeout=600)
    wall = time.perf_counter() - t0
    r0 = outs[0].result
    checks = {"ranks_wall": wall, "backend": outs[0].backend,
              "allreduce_ms": [o.result["allreduce_ms"] for o in outs],
              "allreduce_bytes": r0["allreduce_bytes"],
              "tp_logp_ms": [o.result["tp_logp_ms"] for o in outs]}

    # 8a: the text step against the oracle
    vae, pool, cfg, loss_fn = _dp_step_setup("text", corpus, dev, sizes)
    aux = _one_step(vae, pool, cfg, loss_fn, None, oracle_of=PAR_RANKS)
    diff = {k: float((v.detach().cpu() - r0["text_params"][k]).abs().max())
            for k, v in vae.state_dict().items()}
    worst = max(diff, key=diff.get)
    checks["dp_text_step"] = dict(max_abs_diff=diff[worst], worst_leaf=worst, tolerance=DP_STEP_TOL,
                                  aux=r0["text_aux"], oracle_aux=[float(a) for a in aux])
    if not diff[worst] <= DP_STEP_TOL:
        raise AssertionError(f"8a: DP step against the oracle {checks['dp_text_step']}")
    del vae, pool

    # 8c: the image step's gradient against the oracle's
    vae, pool, cfg, loss_fn = _dp_step_setup("image", npz, dev, sizes)
    aux = _one_step(vae, pool, cfg, loss_fn, None, oracle_of=PAR_RANKS)
    rel = {k: float((p.grad.detach().cpu() - r0["image_grads"][k]).abs().max())
           / max(float(p.grad.abs().max()), 1e-30) for k, p in vae.named_parameters()}
    worst = max(rel, key=rel.get)
    checks["dp_image_step"] = dict(worst_rel=rel[worst], worst_leaf=worst, leaves=len(rel),
                                   tolerance=IMG_DP_GRAD_TOL, aux=r0["image_aux"],
                                   oracle_aux=[float(a) for a in aux])
    if not rel[worst] <= IMG_DP_GRAD_TOL:
        raise AssertionError(f"8c: DP image step against the oracle {checks['dp_image_step']}")
    del vae, pool

    # 8b: tp_token_logp against the plain CE in f32
    h, pred, tgt, w = _tp_inputs(dev, sizes)
    vocab = sizes["vocab"]
    h.requires_grad_(True)
    pred.requires_grad_(True)
    with torch.enable_grad():
        logp, _ = ce_logp_plain(h, pred, tgt, None)
        (logp * w).sum().backward()
    per = vocab // PAR_RANKS
    errs = {"logp": float((r0["tp_logp"] - logp.detach().cpu()).abs().max()),
            "dh": float((r0["tp_dh"] - h.grad.cpu()).abs().max()),
            "dpred": max(float((o.result["tp_dpred"] - pred.grad[
                :, o.result["tp_tp_index"] * per:(o.result["tp_tp_index"] + 1) * per].cpu())
                .abs().max()) for o in outs)}
    tol = TOL[("ce", "f32")]
    checks["tp_logp"] = dict(errors=errs, tolerance=tol, N=sizes["tp_n"], V=vocab,
                             shards=PAR_RANKS)
    if not all(e <= tol for e in errs.values()):
        raise AssertionError(f"8b: tp_token_logp against ce_logp_plain {checks['tp_logp']}")
    log(f"[parallel] checks {json.dumps(checks)}")
    return checks


def run_parallel_cli(main_fn, argv, exp_dir: Path, name: str, stop=None):
    """``run_cli`` of a run over ranks: the per-rank records (backend,
    launches, peak memory, seconds), the epochs, the stopped stretch, the
    results, the wall seconds."""
    launches, records, wall = run_cli(main_fn, argv, exp_dir, name, stop)
    if any(launches.values()):
        raise AssertionError(f"{name}: the parent launched kernels {launches}")
    ranks = next(r["ranks"] for r in records if r.get("split") == "ranks")
    return dict(ranks=ranks, epochs=[r for r in records if "val_loss" in r],
                stopped=next((r for r in records if r.get("split") == "stopped"), None),
                results=next((r for r in records if r.get("split") == "test"), None),
                seconds=next((r for r in records if r.get("split") == "test_seconds"), None),
                wall=wall)


def _summary(run):
    ranks = run["ranks"]
    steps = ([e["steps_per_sec"] for e in run["epochs"]] if run["epochs"] else
             [(run["stopped"]["steps"] + run["stopped"]["inner_iters"])
              / run["stopped"]["seconds"]] if run["stopped"] else [])
    return dict(backend=ranks[0]["backend"], world=len(ranks), steps_per_sec=steps,
                max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
                launches=[r["launches"] for r in ranks], wall=run["wall"],
                results=run["results"], eval_seconds=run["seconds"])


def check_parallel_launches(runs):
    """Every DP rank launches the training kernels of each of its forward+
    backward steps (``step_launches``) and, in the plain run with the
    evaluation, the evaluators' kernels; a TP rank launches the LSTM
    kernels and no CE kernel (its output stage is ``torch.matmul``); the
    image ranks launch none."""
    fb = runs["dp_aggressive"]["stopped"]
    fb = fb["steps"] + fb["inner_iters"]
    fb_plain = sum(e["inner_iters"] for e in runs["dp_plain"]["epochs"]) + N_TRAIN_SMOKE // B
    for name, n in (("dp_aggressive", fb), ("dp_plain", fb_plain)):
        for r in runs[name]["ranks"]:
            want = {k: v * n for k, v in step_launches().items()}
            got = {k: r["launches"][k] for k in want}
            if got != want:
                raise AssertionError(f"8a {name} rank {r['rank']}: training launches {got} != "
                                     f"{want}")
    for r in runs["dp_plain"]["ranks"]:
        if not (r["launches"]["lstm_fwd_infer"] and r["launches"]["ce_fwd"]):
            raise AssertionError(f"8a: rank {r['rank']} ran no evaluation kernel {r}")
    for name in ("tp_plain", "tp_eval"):
        for r in runs[name]["ranks"]:
            lc = r["launches"]
            if lc["ce_fwd"] or lc["ce_fwd_train"] or lc["ce_bwd"] or not lc["lstm_fwd_infer"]:
                raise AssertionError(f"8b {name}: the TP path launches the LSTM kernels and "
                                     f"no CE kernel: rank {r['rank']} {lc}")
    for r in runs["dp_image"]["ranks"]:
        if any(r["launches"].values()):
            raise AssertionError(f"8c: the image path launched a text kernel {r}")


def run_parallel_phase(tmp: Path, files, checks):
    """8a-8c through the CLIs, ranks sharing the card over gloo."""
    from vae_lagging_encoder_tpu_torch.cli import image as cli_image
    from vae_lagging_encoder_tpu_torch.cli import text as cli_text

    dims = [f"--{k}={v}" for k, v in dict(ni=NI, enc_nh=NH, dec_nh=NH, nz=NZ).items()]
    common = ["--dataset", "yahoo", "--warm_up", "1", "--kl_start", "0.1", *files, *dims]
    t_fb = min(checks["allreduce_ms"]) / 1e3 + 0.02  # a forward+backward, all-reduce included
    stop = max(1, min(PAR_MAX_OUTER, int(PAR_STRETCH_S / (PAR_STEPS_PER_OUTER * t_fb))))
    runs = {}
    runs["dp_aggressive"] = run_parallel_cli(
        cli_text.main, common + ["--epochs", "1", "--aggressive", "1", "--dp_devices", "2",
                                 "--save_path", str(tmp / "dp_aggr.ckpt")],
        tmp / "exp_dp_aggr", "cli.text", stop=stop)
    runs["dp_plain"] = run_parallel_cli(
        cli_text.main, common + ["--epochs", "1", "--aggressive", "0", "--dp_devices", "2",
                                 "--iw_nsamples", "500", "--iw_batch", "100",
                                 "--save_path", str(tmp / "dp_plain.ckpt")],
        tmp / "exp_dp_plain", "cli.text")
    runs["tp_plain"] = run_parallel_cli(
        cli_text.main, common + ["--epochs", "1", "--aggressive", "0", "--dp_devices", "1",
                                 "--tp_devices", "2", "--iw_nsamples", str(TRAIN_IW),
                                 "--save_path", str(tmp / "tp_plain.ckpt")],
        tmp / "exp_tp_plain", "cli.text")
    ck4 = str(tmp / "aggressive.ckpt")
    ev = common + ["--eval", "--load_path", ck4, "--iw_nsamples", "500", "--iw_batch", "100"]
    _, dense_rec, dense_wall = run_cli(cli_text.main, ev, tmp / "exp_dense_eval", "cli.text")
    dense = next(r for r in dense_rec if r.get("split") == "test")
    runs["tp_eval"] = run_parallel_cli(cli_text.main, ev + ["--tp_devices", "2"],
                                       tmp / "exp_tp_eval", "cli.text")
    runs["dp_image"] = run_parallel_cli(
        cli_image.main, ["--dataset", "omniglot", "--train_data", str(tmp / "omniglot.npz"),
                         "--epochs", "1", "--aggressive", "1", "--warm_up", "1",
                         "--kl_start", "0.1", "--iw_nsamples", str(IMG_TRAIN_IW),
                         "--dp_devices", "2", "--save_path", str(tmp / "dp_image.ckpt")],
        tmp / "exp_dp_image", "cli.image")

    # what each run must show
    for name, run in runs.items():
        res = run["results"]
        if name != "dp_aggressive" and not all(
                math.isfinite(res[k]) for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll")):
            raise AssertionError(f"8 {name}: non-finite results {res}")
        if [r["backend"] for r in run["ranks"]] != ["gloo"] * 2:
            raise AssertionError(f"8 {name}: ranks sharing one card must take gloo: "
                                 f"{run['ranks']}")
    check_parallel_launches(runs)
    tp_res = runs["tp_eval"]["results"]
    drift = {k: abs(tp_res[k] - dense[k]) / max(abs(dense[k]), 1e-12)
             for k in ("elbo_loss", "rec", "iw_nll")}
    drift["kl_abs"] = abs(tp_res["kl"] - dense["kl"])
    if not (all(drift[k] <= TP_EVAL_RTOL for k in ("elbo_loss", "rec", "iw_nll"))
            and tp_res["au"] == dense["au"]):
        raise AssertionError(f"8b: TP eval {tp_res} against the dense eval {dense}: drift "
                             f"{drift} (bound {TP_EVAL_RTOL})")
    summary = {name: _summary(run) for name, run in runs.items()}
    summary["dense_eval"] = dict(results=dense, wall=dense_wall)
    summary["tp_eval_drift"] = dict(drift, bound=TP_EVAL_RTOL)
    summary["aggressive_outer_steps"] = stop
    for name, s in summary.items():
        log(f"[parallel] {name}: {json.dumps(s)}")
    return summary, runs


# ---------------------------------------------------------------- phase 9
GRAPH_SEED = 909
# outer steps of each window after the first pass over the pool's batches
# (the warm-ups and captures): the timed window (plain: 4 passes of an
# 8-batch pool; an aggressive outer step already holds tens of
# sub-iterations), then the profiled window (its trace is exported and read
# back: kept short)
GRAPH_TIMED = {"plain": 32, "aggressive": 4}
GRAPH_PROFILED = {"plain": 8, "aggressive": 1}
# the bucketed corpus: sentences per Yahoo length bucket (a batch of 32 and
# a padded one of 8: 20 batches, 10 shapes); its aggressive runs'
# burn_max_iters, which sets the inner loop's length only (the shapes and
# the graphs are the config's; at 100, 20 outer steps up to T 512 would take
# minutes)
BUCKET_SENTS = 40
BUCKET_BURN = 4
# A graph replays the kernels that the eager step launches, on the same
# inputs and in the same order: expected 0.0. A nonzero difference is
# accepted only below this share of a leaf's scale (its cause then stated).
GRAPH_PARAM_TOL = 1e-6
# runs of each image conv product per flag setting in the determinism
# probe: reproducible when all agree bit for bit
CONV_REPEATS = 8


def write_bucket_corpus(path: Path):
    """BUCKET_SENTS sentences in each Yahoo length bucket (16 ... 512, the
    length counting <s> and </s>), whose tokens hold every one of the
    N_WORDS words, so the vocabulary is exactly 20004."""
    from vae_lagging_encoder_tpu_torch.config import get_config

    rng = np.random.RandomState(3)
    bounds = (0,) + tuple(get_config("yahoo").length_buckets)
    lens = np.concatenate([rng.randint(max(lo - 1, 1), hi - 1, BUCKET_SENTS)
                           for lo, hi in zip(bounds, bounds[1:])])
    ids = np.concatenate([rng.permutation(N_WORDS),
                          rng.zipf(1.3, size=int(lens.sum()) - N_WORDS) % N_WORDS])
    rng.shuffle(ids)
    pos, sents = 0, []
    for ln in lens:
        sents.append(" ".join(f"w{i}" for i in ids[pos:pos + ln]))
        pos += int(ln)
    path.write_text("".join(f"{i % 10}\t{s}\n" for i, s in enumerate(sents)))


def graph_model(kind: str, tmp: Path, dev, nh: int = NH):
    """(cfg, pool, make_vae, loss_fn_of) of phase 9, seeded weights: the
    Yahoo-config text model on phase 4's corpus (``text``: 8 batches, T 96)
    or on the bucketed corpus (``text_buckets``: 20 batches over the ten
    buckets), both V 20004 (its LSTMs ``nh`` wide: phase 10 narrows them),
    or the OmniGlot model on phase 5's cut (``image``: 8 batches of 50)."""
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.data import BucketedPool, ImagePool, MonoTextData
    from vae_lagging_encoder_tpu_torch.data.omniglot import load_omniglot
    from vae_lagging_encoder_tpu_torch.models import build_image_vae, build_text_vae
    from vae_lagging_encoder_tpu_torch.train.epoch import make_image_loss_fn

    gen = lambda: torch.Generator().manual_seed(GRAPH_SEED)
    if kind.startswith("text"):
        buckets = kind == "text_buckets"
        cfg = get_config("yahoo", ni=NI, enc_nh=nh, dec_nh=nh, nz=NZ, warm_up=1, kl_start=0.1,
                         **({"burn_max_iters": BUCKET_BURN} if buckets else {}))
        path = tmp / "buckets.train.txt" if buckets else tmp / "smoke.train.txt"
        if buckets:
            write_bucket_corpus(path)
        data = MonoTextData(str(path), label=True)
        if len(data.vocab) != VOCAB:
            raise AssertionError(f"phase 9 {kind}: vocabulary {len(data.vocab)} != {VOCAB}")
        pool = BucketedPool(data.create_data_batch(cfg.batch_size, cfg.length_buckets), dev)
        return (cfg, pool, lambda: build_text_vae(cfg, len(data.vocab), device=dev,
                                                   generator=gen()), lambda vae: None)
    cfg = get_config("omniglot", warm_up=1, kl_start=0.1)
    pool = ImagePool(load_omniglot(str(tmp / "omniglot.npz"))[0], cfg.batch_size, dev)
    return (cfg, pool, lambda: build_image_vae(cfg, device=dev, generator=gen()),
            lambda vae: make_image_loss_fn(vae, nsamples=1, train=True))


def graph_run(model, mode: str, graphs: bool, dev, cudnn_default: bool = False):
    """One run of phase 9 through ``make_train_epoch``: the first pass, the
    timed window and the profiled window (``GRAPH_*``), graphed or eager,
    from the seeded weights, with the same orders and noise either way;
    ``cudnn_default`` lets the image convs' backward take cuDNN's default
    algorithms for the run (``ops/conv.py`` takes the deterministic ones).
    In the profiled window the port's kernels counted among the device
    events must equal the ``LAUNCHES`` the window added. Returns the run's
    measures and the final parameters."""
    from vae_lagging_encoder_tpu_torch.ops import build, conv
    from vae_lagging_encoder_tpu_torch.train.epoch import GeneratorNoise, make_train_epoch

    cfg, pool, make_vae, loss_of = model
    gc.collect()  # the earlier runs' graphs and pools, so that the peak is this run's
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    vae = make_vae()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=loss_of(vae), graphs=graphs)
    noise, rng = GeneratorNoise(GRAPH_SEED, dev), np.random.RandomState(GRAPH_SEED)
    state = {"opt": opt_init(), "kl": np.float32(cfg.kl_start)}
    nb, aggressive = pool.num_batches, mode == "aggressive"

    def window(order):
        state["opt"], state["kl"], _, inner = epoch_fn(state["opt"], noise, state["kl"], cfg.lr,
                                                       order, aggressive)
        torch.cuda.synchronize()
        return len(order) + inner

    flags = conv._cudnn_flags
    if cudnn_default:
        conv._cudnn_flags = lambda deterministic=False: flags()
    try:
        t0 = time.perf_counter()
        first = window(rng.permutation(nb))
        first_s = time.perf_counter() - t0
        timed_order = np.concatenate([rng.permutation(nb)
                                      for _ in range(-(-GRAPH_TIMED[mode] // nb))])
        t0 = time.perf_counter()
        timed = window(timed_order[:GRAPH_TIMED[mode]])
        timed_s = time.perf_counter() - t0
        got, before = {}, dict(build.LAUNCHES)
        t0 = time.perf_counter()
        prof = profiled(
            lambda: got.update(steps=window(rng.permutation(nb)[:GRAPH_PROFILED[mode]])),
            cpu=False, outer_steps=GRAPH_PROFILED[mode])
        profile_s = time.perf_counter() - t0
    finally:
        conv._cudnn_flags = flags
    if "port_kernel_calls" not in prof:
        raise AssertionError(f"phase 9 {mode}: the profiled window has no device timeline")
    window_launches = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES}
    traced = {k: prof["port_kernel_calls"].get(k, 0) for k in window_launches}
    steps = first + timed + got["steps"]
    stats = dict(epoch_fn.steps.stats)
    launches, counts = dict(build.LAUNCHES), dict(build.GRAPHS)
    calls = sum(prof["launch_calls"].values())
    run = {"graphs": epoch_fn.steps.off or "on", "steps": steps,
           "first_pass_steps": first, "first_pass_s": first_s, "timed_steps": timed,
           "steps_per_sec": timed / timed_s, "idle_share": prof["idle_share"],
           "profiled_steps": got["steps"], "profiled_wall_ms": prof["wall_ms"],
           "device_busy_ms_per_step": prof["device_busy_ms"] / got["steps"],
           "profile_s": profile_s,
           "host_launch_calls_per_step": calls / got["steps"],
           "launch_calls": prof["launch_calls"],
           "profiled_launches": window_launches, "traced_kernel_calls": traced,
           "kernel_launches_per_step": sum(launches.values()) / steps,
           "graph_replays_per_step": counts["replays"] / steps,
           "graphs_captured": counts["captured"], "graph_replays": counts["replays"],
           "eager_steps": stats["eager_steps"], "graph_steps": stats["graph_steps"],
           "capture_seconds": stats["capture_seconds"],
           "conv_backward_algorithms": "cudnn default" if cudnn_default else "deterministic",
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches}
    if stats["eager_steps"] + stats["graph_steps"] != steps:
        raise AssertionError(f"phase 9 {mode}: steps {steps} != eager + replayed {stats}")
    if graphs and not 0 < counts["replays"] == stats["graph_steps"]:
        raise AssertionError(f"phase 9 {mode}: replays {counts} for {stats}")
    if not graphs and any(counts.values()):
        raise AssertionError(f"phase 9 {mode}: the eager run replayed graphs {counts}")
    params = {k: p.detach().clone() for k, p in vae.named_parameters()}
    if not all(torch.isfinite(v).all() for v in params.values()):
        raise AssertionError(f"phase 9 {mode}: non-finite parameters")
    return run, params


def param_diff(a, b):
    """The largest absolute difference of two parameter sets, and the
    largest relative to its leaf's scale (the leaf's largest entry)."""
    absd = {k: float((a[k] - b[k]).abs().max()) for k in a}
    rel = {k: absd[k] / max(float(b[k].abs().max()), 1e-30) for k in a}
    worst = max(rel, key=rel.get)
    return {"max_abs": max(absd.values()), "max_rel": rel[worst], "worst_leaf": worst}


def conv_determinism(model, dev):
    """Which image conv products differ from run to run under cuDNN's
    default algorithms: the convs of one training step of ``model`` (their
    operands' shapes and strides recorded at ``ops/conv.py::_Conv2dFn``),
    each product (forward, input gradient, weight gradient) run
    CONV_REPEATS times on seeded operands with the deterministic algorithms
    off and on, TF32 off: whether the runs agree bit for bit, and the
    median ms of one run summed over the step's convs."""
    import collections

    import torch.nn.functional as F

    from vae_lagging_encoder_tpu_torch.ops import conv
    from vae_lagging_encoder_tpu_torch.train.epoch import GeneratorNoise

    cfg, pool, make_vae, loss_of = model
    vae = make_vae()
    convs = collections.Counter()
    forward = conv._Conv2dFn.forward

    def recording(ctx, x, w, stride, padding):
        convs[(tuple(x.shape), x.stride(), tuple(w.shape), w.stride(), stride,
               tuple(padding), x.requires_grad)] += 1
        return forward(ctx, x, w, stride, padding)

    conv._Conv2dFn.forward = staticmethod(recording)
    try:
        noise = GeneratorNoise(GRAPH_SEED, dev)
        loss_of(vae)(pool.batch(0), lambda site, shape: noise(0, site, shape), 1.0)
    finally:
        conv._Conv2dFn.forward = staticmethod(forward)
    if not convs:
        raise AssertionError("phase 9: no image conv was recorded")
    g = torch.Generator(device=dev).manual_seed(GRAPH_SEED)

    def operand(shape, stride):
        return torch.empty_strided(shape, stride, device=dev).copy_(
            torch.randn(shape, device=dev, generator=g))

    bwd = torch.ops.aten.convolution_backward
    rows, per_step = [], {}
    for (xs, xst, ws, wst, stride, pad, x_grad), n in convs.items():
        x, w = operand(xs, xst), operand(ws, wst) * 0.1
        gy = torch.randn_like(F.conv2d(x, w, stride=stride, padding=pad))
        args = (x, w, None, [stride, stride], list(pad), [1, 1], False, [0, 0], 1)
        products = {"forward": lambda: F.conv2d(x, w, stride=stride, padding=pad),
                    "weight": lambda: bwd(gy, *args, [False, True, False])[1]}
        if x_grad:
            products["input"] = lambda: bwd(gy, *args, [True, False, False])[0]
        row = {"x": list(xs), "w": list(ws), "stride": stride, "calls_per_step": n}
        for det in (False, True):
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=det,
                                            allow_tf32=False):
                for name, fn in products.items():
                    outs, ms = [], []
                    for _ in range(CONV_REPEATS):
                        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        e0.record()
                        outs.append(fn())
                        e1.record()
                        e1.synchronize()
                        ms.append(e0.elapsed_time(e1))
                    key = f"{name}_{'deterministic' if det else 'default'}"
                    med = float(np.median(ms))
                    row[key] = {"reproducible": all(torch.equal(o, outs[0]) for o in outs[1:]),
                                "ms": med}
                    cell = per_step.setdefault(key, {"reproducible": True, "ms": 0.0})
                    cell["reproducible"] &= row[key]["reproducible"]
                    cell["ms"] += med * n
        rows.append(row)
    return {"per_step": per_step, "convs": rows, "repeats": CONV_REPEATS}


def run_graph_phase(tmp: Path, dev):
    """Phase 9: per model (text, text_buckets, image) and mode (plain,
    aggressive) the same windows graphed and eager (``graphs=False``);
    every parameter against the eager run's, the kernel launches against
    ``step_launches``, and every profiled window's traced kernels against
    its ``LAUNCHES`` (checked once all runs are done); the image convs'
    determinism probe, and the image plain windows graphed once more with
    cuDNN's default algorithms in the convs' backward (the restriction's
    cost; its parameters are reported, not held)."""
    out, text_launches, untraced = {}, {}, []
    for kind in ("text", "text_buckets", "image"):
        model = graph_model(kind, tmp, dev)
        if kind == "image":
            out["image"] = {"conv_determinism": conv_determinism(model, dev)}
            log(f"[graphs] image conv determinism: "
                f"{json.dumps(out['image']['conv_determinism'])}")
        for mode in ("plain", "aggressive"):
            variants = [("graphed", True, False), ("eager", False, False)]
            if kind == "image" and mode == "plain":
                variants.append(("graphed_cudnn_default", True, True))
            runs, params = {}, {}
            for name, on, default in variants:
                runs[name], params[name] = graph_run(model, mode, on, dev, cudnn_default=default)
                log(f"[graphs] {kind} {mode} {name}: {json.dumps(runs[name])}")
                if runs[name]["traced_kernel_calls"] != runs[name]["profiled_launches"]:
                    untraced.append(f"{kind} {mode} {name}")
            for name, on, default in variants:
                if name == "eager":
                    continue
                d = param_diff(params[name], params["eager"])
                runs[name]["param_diff_vs_eager"] = d
                if not default and not d["max_rel"] <= GRAPH_PARAM_TOL:
                    raise AssertionError(f"phase 9 {kind} {mode} {name}: parameters against "
                                         f"the eager run {d} (tolerance {GRAPH_PARAM_TOL})")
                want = ({k: v * runs[name]["steps"] for k, v in step_launches().items()}
                        if kind.startswith("text") else {k: 0 for k in step_launches()})
                got = {k: runs[name]["launches"][k] for k in want}
                if got != want or runs[name]["launches"] != runs["eager"]["launches"]:
                    raise AssertionError(f"phase 9 {kind} {mode} {name}: launches {got} != "
                                         f"{want}, or != the eager run's")
            if kind.startswith("text"):
                for run in runs.values():
                    for k, v in run["launches"].items():
                        text_launches[k] = text_launches.get(k, 0) + v
            out.setdefault(kind, {})[mode] = runs
            del params
    if untraced:
        raise AssertionError(f"phase 9: the port's kernels in the trace differ from the "
                             f"LAUNCHES of the profiled window in {untraced}")
    return out, text_launches


# ---------------------------------------------------------------- phase 10
# The Yahoo config narrowed to --enc_nh 512 --dec_nh 512 (ni 512, nz 32,
# B 32, V 20004, f32 compute, the kernel route): wh stays f32 (H <= 512,
# models/lstm_core.py), so every LSTM launch is csrc/lstm_f32.cu's.
H512 = 512
H512_EVAL_SENTS = 48      # --eval at IW 500/100 over phase 3's first 48 test sentences
H512_NSAMPLES_STEPS = 4   # --nsamples 40 steps: a decoder chunk is 640 LSTM rows


def run_h512_phase(tmp: Path, files, test_path: Path, dev):
    """Phase 10 through ``cli.text`` on phase 4's corpus at H 512: an
    aggressive and a plain epoch (graphed, the card's default; the final
    evaluation at ``TRAIN_IW``), ``H512_NSAMPLES_STEPS`` steps of
    ``--nsamples 40``, and ``--eval`` of the plain run's checkpoint at IW
    500/100 over ``H512_EVAL_SENTS`` sentences; then phase 9's steady
    windows at this width, plain and aggressive, graphed and eager from the
    same weights and noise: every parameter equal bit for bit, the launches
    ``step_launches(f32=True)`` a step (no bf16 LSTM kernel), and each
    profiled window's traced kernels equal to its launches. Returns the phase's figures and its launches
    by path."""
    from vae_lagging_encoder_tpu_torch.cli import text as cli_text

    flags = [f"--{k}={v}" for k, v in dict(ni=NI, enc_nh=H512, dec_nh=H512, nz=NZ).items()]
    out, launches = {}, {}

    def need_f32(name, got, kinds=tuple(F32_KERNELS)):
        """Each f32 kernel of ``kinds`` launched, and no bf16 LSTM kernel."""
        if not (all(got[F32_KERNELS[k]] > 0 for k in kinds)
                and not any(got[k[:-len("_f32")]] for k in F32_KERNELS.values())):
            raise AssertionError(f"phase 10 {name}: LSTM launches {got}: expected the f32 "
                                 f"kernels of {kinds} and no bf16 one")

    for name, extra in (("aggressive", ["--epochs", "1", "--aggressive", "1"]),
                        ("plain", ["--epochs", "1", "--aggressive", "0"])):
        run = run_train_cli(["--dataset", "yahoo", *extra, "--warm_up", "1", "--kl_start", "0.1",
                             "--iw_nsamples", str(TRAIN_IW), "--save_path",
                             str(tmp / f"h512_{name}.ckpt"), *files, *flags],
                            tmp / f"exp_h512_{name}")
        vals = [run["results"][k] for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll")] + \
            [e[k] for e in run["epochs"] for k in ("train_loss", "val_loss")]
        if not all(map(math.isfinite, vals)):
            raise AssertionError(f"phase 10 {name}: non-finite values {vals}")
        need_f32(name, run["launches"])
        launches[f"h512_train_{name}"] = run["launches"]
        out[f"train_{name}"] = dict(epochs=run["epochs"], results=run["results"],
                                    wall=run["wall"], launches=run["launches"],
                                    max_memory_allocated=run["max_memory_allocated"])
        log(f"[h512] {name}: {json.dumps(out[f'train_{name}'])}")
    run = run_train_cli(["--dataset", "yahoo", "--epochs", "1", "--aggressive", "0",
                         "--warm_up", "1", "--kl_start", "0.1", "--nsamples", str(NSAMPLES),
                         "--save_path", str(tmp / "h512_nsamples.ckpt"), *files, *flags],
                        tmp / "exp_h512_nsamples", stop=H512_NSAMPLES_STEPS)
    need_f32("nsamples40", run["launches"], ("resid", "bwd"))
    launches["h512_nsamples40"] = run["launches"]
    out["nsamples40"] = dict(steps=H512_NSAMPLES_STEPS, wall=run["wall"],
                             launches=run["launches"],
                             launches_per_step=step_launches(NSAMPLES, f32=True),
                             max_memory_allocated=run["max_memory_allocated"])
    log(f"[h512] --nsamples {NSAMPLES}: {json.dumps(out['nsamples40'])}")
    cut = tmp / "h512.test.txt"
    cut.write_text("".join(test_path.read_text().splitlines(keepends=True)[:H512_EVAL_SENTS]))
    ev_dir = tmp / "exp_h512_eval"
    ev_launches, records, wall = run_cli(
        cli_text.main, ["--dataset", "yahoo", "--eval", "--load_path", str(tmp / "h512_plain.ckpt"),
                        "--iw_nsamples", "500", "--iw_batch", "100", files[0], files[1],
                        files[2], files[3], "--test_data", str(cut), *flags],
        ev_dir, "cli.text")
    res = next(r for r in records if r.get("split") == "test")
    secs = next(r for r in records if r.get("split") == "test_seconds")
    vals = [res[k] for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "iw_ppl")]
    if not all(map(math.isfinite, vals)) or not 0 <= res["au"] <= NZ:
        raise AssertionError(f"phase 10 eval: results {res}")
    need_f32("eval", ev_launches, ("infer",))
    launches["h512_eval"] = ev_launches
    out["eval"] = dict(results=res, seconds=secs, wall=wall, launches=ev_launches,
                       iw_sentences_per_sec=H512_EVAL_SENTS / secs["iw"])
    log(f"[h512] --eval IW 500/100 over {H512_EVAL_SENTS} sentences: {json.dumps(out['eval'])}")

    model = graph_model("text", tmp, dev, nh=H512)
    graph_launches = {}
    for mode in ("plain", "aggressive"):
        runs, params = {}, {}
        for name, on in (("graphed", True), ("eager", False)):
            runs[name], params[name] = graph_run(model, mode, on, dev)
            log(f"[h512] graphs {mode} {name}: {json.dumps(runs[name])}")
            r = runs[name]
            if r["traced_kernel_calls"] != r["profiled_launches"]:
                raise AssertionError(f"phase 10 {mode} {name}: traced {r['traced_kernel_calls']} "
                                     f"against the window's launches {r['profiled_launches']}")
            for k, v in r["launches"].items():
                graph_launches[k] = graph_launches.get(k, 0) + v
        d = param_diff(params["graphed"], params["eager"])
        runs["graphed"]["param_diff_vs_eager"] = d
        want = {k: v * runs["graphed"]["steps"] for k, v in step_launches(f32=True).items()}
        got = {k: runs["graphed"]["launches"][k] for k in want}
        if d["max_abs"] != 0.0 or got != want or \
                runs["graphed"]["launches"] != runs["eager"]["launches"]:
            raise AssertionError(f"phase 10 {mode}: graphed against eager {d}, launches {got} "
                                 f"(expected {want}; eager {runs['eager']['launches']})")
        out[f"graphs_{mode}"] = runs
        del params
    need_f32("graphs", graph_launches, ("resid", "bwd"))
    launches["h512_graphs"] = graph_launches
    return out, launches


KERNELS = [
    ("lstm_fwd_residuals", "vae_lagging_encoder_tpu_torch/csrc/lstm_infer.cu",
     "vae_lagging_encoder_tpu/ops/lstm_pallas.py:67", ("lstm", True, B, NI)),
    ("lstm_fwd_infer", "vae_lagging_encoder_tpu_torch/csrc/lstm_infer.cu",
     "vae_lagging_encoder_tpu/ops/lstm_pallas.py:166", ("lstm", False, B * IW_CHUNK, NI + NZ)),
    ("lstm_bwd", "vae_lagging_encoder_tpu_torch/csrc/lstm_bwd.cu",
     "vae_lagging_encoder_tpu/ops/lstm_pallas.py:269", ("lstm_bwd",)),
    ("ce_fwd", "vae_lagging_encoder_tpu_torch/csrc/ce_fwd.cu",
     "vae_lagging_encoder_tpu/ops/ce_pallas.py:65", ("ce",)),
    ("ce_fwd_train", "vae_lagging_encoder_tpu_torch/csrc/ce_fwd.cu",
     "vae_lagging_encoder_tpu/ops/ce_pallas.py:65", ("ce_train",)),
    ("ce_bwd", "vae_lagging_encoder_tpu_torch/csrc/ce_bwd.cu",
     "vae_lagging_encoder_tpu/ops/ce_pallas.py:217", ("ce_bwd",)),
]


def f32_census() -> None:
    """The f32 kernels' build report (the f32-wh LSTM, the f32-operand CE):
    FFMA products on operands brought by TMA (UTMALDG), no tensor-core
    instruction (the f32 route is defined by f32 products); the CE's two
    modes also without local-memory spills. Raises otherwise."""
    from vae_lagging_encoder_tpu_torch.ops import build

    for source, kerns in (("lstm_f32", ("lstm_fwd_f32_kernel", "lstm_bwd_f32_kernel")),
                          ("ce_f32", ("ce_f32_kernel",))):
        rep = build.kernel_report(source)
        log(json.dumps({"build": source, "kernels": rep}))
        for kern in kerns:
            found = [k for k in rep if kern in k["function"] and "ffma" in k]
            if not found or not all(k["ffma"] and k["utmaldg"] and not (k["hmma"] or k["hgmma"])
                                    for k in found):
                raise AssertionError(f"{source}: {kern} without FFMA and UTMALDG, or with "
                                     f"tensor-core instructions: {rep}")
            if source == "ce_f32" and (len(found) != 2 or any(
                    k.get("spill_bytes", 1) for k in found)):
                raise AssertionError(f"ce_f32: {kern}'s two modes not both found, or with "
                                     f"local-memory spills: {rep}")


def graphs_line(graph_runs, smi):
    return json.dumps({"graphs": {**graph_runs, "device": torch.cuda.get_device_name(0),
                                  "nvidia_smi": smi}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "vae_lagging_encoder_tpu_torch").is_dir():
        print(f"chip_smoke: the port's package vae_lagging_encoder_tpu_torch is not "
              f"beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from vae_lagging_encoder_tpu_torch.ops import build

    marks = [time.perf_counter()]

    def phase_done(name: str) -> None:
        marks.append(time.perf_counter())
        log(f"[phase {name}] {marks[-1] - marks[-2]:.1f} s")

    # phase 1 — device and build (the precision flags stay at PyTorch's
    # defaults, as ``python -m ...cli.image`` runs: the image convs turn
    # TF32 off themselves, ops/conv.py)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    build_s = build.build()
    log(f"[build] {len(build.SOURCES)} CUDA sources built in {build_s:.1f} s")
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    floors_s = build_floors(dev)
    log(f"[build] empty-step floors {sorted(FLOORS)} built in {floors_s:.1f} s")
    # the tensor-core kernels: lstm_infer (both LSTM forwards) and lstm_bwd
    # on mma.sync (HMMA) with cp.async (LDGSTS) below WIDE_MIN_ROWS rows and
    # on wgmma (HGMMA) with TMA (UTMALDG) from there; ce_fwd's and ce_bwd's
    # products on wgmma with TMA
    for name in ("lstm_infer", "lstm_bwd", "ce_fwd", "ce_bwd"):
        rep = build.kernel_report(name)
        log(json.dumps({"build": name, "kernels": rep}))
        census = [k for k in rep if "hmma" in k]
        if not census:
            raise AssertionError(f"{name}: no SASS census in the build log (is cuobjdump "
                                 f"beside nvcc?): {rep}")
        tc = [x.lower() for x in build.TENSOR_CORE_SASS]
        cp = [x.lower() for x in build.ASYNC_COPY_SASS]
        if not any(any(k[x] for x in tc) and any(k[x] for x in cp) for k in census):
            raise AssertionError(f"{name}: no kernel with both tensor-core "
                                 f"({build.TENSOR_CORE_SASS}) and asynchronous-copy "
                                 f"({build.ASYNC_COPY_SASS}) instructions: {rep}")
        if not any(k["hgmma"] and k["utmaldg"] for k in census):
            raise AssertionError(f"{name}: no wide-row or product kernel with both HGMMA "
                                 f"(wgmma) and UTMALDG (TMA tile loads): {rep}")
        if name in ("lstm_infer", "lstm_bwd") and not any(
                "narrow" in k["function"] and k["hmma"] and k["ublkcp"] for k in census):
            raise AssertionError(f"{name}: no narrow-row kernel with both HMMA (mma.sync) and "
                                 f"UBLKCP (cp.async.bulk): {rep}")
    f32_census()
    phase_done("1")

    # phase 2 — kernels against their plain versions at the slice's shapes
    results = {}
    checks = {"lstm": lambda spec, name: check_lstm(spec[1], spec[2], spec[3], name, dev),
              "lstm_bwd": lambda spec, name: check_lstm_bwd(dev),
              "ce": lambda spec, name: check_ce(dev),
              "ce_train": lambda spec, name: check_ce_train(dev),
              "ce_bwd": lambda spec, name: check_ce_bwd(dev)}
    with torch.no_grad():
        for name, source, replaces, spec in KERNELS:
            r = checks[spec[0]](spec, name)
            r.update(name=name, source=source, replaces=replaces)
            results[name] = r
            log(json.dumps({"kernel_check": r}))
    phase_done("2")
    with torch.no_grad():
        f32_checks = check_f32(dev)
        ce_f32 = check_ce_f32(dev)
    phase_done("2, the f32 route")

    # phase 3 — the slice end to end through the CLI
    with tempfile.TemporaryDirectory() as td:
        res, seconds, launches, wall, pool, ck, cfg, vsize = run_slice(Path(td), dev)
        want = expected_launches(pool, cfg)
        log(f"[slice] results {json.dumps(res)}")
        log(f"[slice] seconds {json.dumps(seconds)}; whole CLI {wall:.2f} s; launches "
            f"{json.dumps(launches)} (expected {json.dumps(want)})")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != expected {want}")
        vals = [res[k] for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "iw_ppl")]
        if not all(math.isfinite(v) for v in vals) or not 0 <= res["au"] <= NZ:
            raise AssertionError(f"non-finite or out-of-range results: {res}")
        log(f"[slice] IW-NLL ({cfg.iw_nsamples} samples, chunks of {cfg.iw_batch}) over "
            f"{N_TEST} sentences in {pool.num_batches} batches: "
            f"{N_TEST / seconds['iw']:.3f} sentences/s on {torch.cuda.get_device_name(0)} "
            f"({smi})")
        err, nll_mean = cross_check(pool, ck, cfg, vsize, dev)
        log(f"[slice] cross-check vs plain versions on one batch (IW {IW_CROSS_SAMPLES}): "
            f"max abs err {err:.3e} nats (tolerance {CROSS_TOL}), mean IW-NLL {nll_mean:.3f}")
        try:
            trace_iw_res = trace_iw(pool, ck, cfg, vsize, dev)
        except Exception as e:  # the trace informs; it never fails the run
            trace_iw_res = {"error": f"{type(e).__name__}: {e}"}
        phase_done("3")

        # phase 4 — the training slice end to end through the CLI
        train_runs, steps, train_pool, tcfg = run_training_slice(
            Path(td), Path(td) / "yahoo.test.txt", dev)
        log(f"[train] steps/s on {torch.cuda.get_device_name(0)} ({smi}): aggressive "
            f"{json.dumps(steps['aggressive'])}, plain {json.dumps(steps['plain'])} "
            "(a step = one forward+backward: an outer step or an inner sub-iteration)")
        gx = grad_cross_check(train_pool, tcfg, dev)
        log(f"[train] gradient cross-check vs plain versions (one step, Yahoo width, weights "
            f"x10): {json.dumps(gx)} (tolerance {GRAD_TOL})")
        try:
            trace = trace_steps(train_pool, tcfg, dev)
        except Exception as e:  # the trace informs; it never fails the run
            trace = {"error": f"{type(e).__name__}: {e}"}
        phase_done("4")

        # phase 5 — the image slice end to end through cli.image
        img_runs, img_steps, img_data, img_ck, img_cfg = run_image_slice(Path(td), dev)
        phase_done("5, the CLI runs")
        ev = img_runs["eval"]
        img_line = {"steps_per_sec": img_steps,
                    "iw_images_per_sec": IMG_SPLITS["test"] / ev["seconds"]["iw"],
                    "eval_seconds": {k: ev["seconds"][k] for k in ("elbo", "mi", "au", "iw")},
                    "eval_max_memory_allocated": ev["max_memory_allocated"],
                    "train_max_memory_allocated": max(img_runs[k]["max_memory_allocated"]
                                                      for k in ("aggressive", "plain")),
                    "eval_results": ev["results"], "device": torch.cuda.get_device_name(0),
                    "nvidia_smi": smi}
        log(f"[image] steps/s aggressive {json.dumps(img_steps['aggressive'])}, plain "
            f"{json.dumps(img_steps['plain'])}; IW-NLL ({img_cfg.iw_nsamples} samples, chunks "
            f"of {img_cfg.iw_batch}) {img_line['iw_images_per_sec']:.3f} images/s on "
            f"{torch.cuda.get_device_name(0)} ({smi})")
        img_cross = image_cross_check(img_data, img_ck, img_cfg, dev)
        log(f"[image] card against the CPU f32 path: {json.dumps(img_cross)} (tolerances loss "
            f"{IMG_LOSS_RTOL}, gradients {IMG_GRAD_TOL}, IW {IMG_IW_RTOL})")
        phase_done("5, the cross-check")
        try:
            trace_img, trace_img_iw = trace_image(img_data, img_ck, img_cfg, dev)
        except Exception as e:  # the traces inform; they never fail the run
            trace_img = trace_img_iw = {"error": f"{type(e).__name__}: {e}"}
        phase_done("5, the traces")

        # phase 6 — generation and the toy probe through cli.text, cli.image, cli.toy
        text_gen = run_text_generation(Path(td), Path(td) / "smoke.train.txt",
                                       Path(td) / "yahoo.test.txt", Path(td) / "aggressive.ckpt",
                                       tcfg)
        # phase 4's trained weights (sentences end early) and phase 3's
        # random ones x 10 (no EOS: every beam runs the 100 steps)
        text_gen_x = {"trained": text_generation_cross_check(Path(td) / "aggressive.ckpt",
                                                             tcfg, dev),
                      "random_x10": text_generation_cross_check(Path(td) / "model.ckpt", tcfg,
                                                                dev, scale=10.0)}
        log(f"[generate] text card against the CPU path: {json.dumps(text_gen_x)} "
            f"(tolerance {GEN_TOL})")
        phase_done("6a, text generation")
        img_gen = run_image_generation(Path(td), Path(td) / "omniglot.npz", img_ck)
        img_gen_x = image_generation_cross_check(img_ck, img_cfg, dev)
        log(f"[generate] image logits and samplers: {json.dumps(img_gen_x)} (tolerance "
            f"{IMG_LOGIT_TOL}, ties {IMG_TIE})")
        phase_done("6b, image generation")
        toy = run_toy(Path(td))
        phase_done("6c, the toy")

        # phase 7 — the rest of the single-card training lifecycle, Yahoo width
        tmp = Path(td)
        files4 = ["--train_data", str(tmp / "smoke.train.txt"), "--val_data",
                  str(tmp / "smoke.valid.txt"), "--test_data", str(tmp / "yahoo.test.txt")]
        val_pool4, test_pool4 = text_pools(tmp / "smoke.train.txt", (tmp / "smoke.valid.txt",
                                                                     tmp / "yahoo.test.txt"),
                                           tcfg, dev)
        life = {}
        life["autosave_resume"], runs_a = autosave_resume(tmp, files4, ck)
        phase_done("7a, autosave and resume")
        life["train_nsamples40"], run_b = train_nsamples(tmp, files4, train_pool, val_pool4,
                                                         test_pool4, tcfg, dev)
        phase_done("7b, --nsamples 40")
        life["profile_dir"], run_c = profile_epoch(tmp, files4, train_pool)
        phase_done("7c, --profile_dir")
        paths3 = {k: tmp / f"yahoo.{k}.txt" for k in ("train", "valid", "test")}
        life["reference_checkpoints"], runs_d = reference_checkpoints(tmp, paths3, ck, res, pool,
                                                                      cfg)
        phase_done("7d, reference checkpoints")
        life["docs_english"], run_e = docs_english(tmp)
        phase_done("7e, docs_english")

        # phase 8 — data and tensor parallelism, two ranks sharing the card
        par_checks = parallel_checks(tmp, dev)
        phase_done("8, the checks")
        par_runs, runs_p = run_parallel_phase(tmp, files4, par_checks)
        phase_done("8, the CLI runs")

        # phase 9 — the training epoch as CUDA-graph replays against eager steps
        graph_runs, graph_launches = run_graph_phase(tmp, dev)
        phase_done("9")

        # phase 10 — the Yahoo model narrowed to H 512: the f32-wh kernels end to end
        h512, h512_launches = run_h512_phase(tmp, files4, tmp / "yahoo.test.txt", dev)
        phase_done("10")

    train_launches = {k: sum(r["launches"][k] for r in train_runs.values()) for k in launches}
    kernels = []
    for name, source, replaces, spec in KERNELS:
        r = results[name]
        tol = r.get("tolerance", TOL.get((spec[0], "bf16")))
        by_path = {"eval": launches[name], "train": train_launches[name],
                   "image_train": sum(img_runs[k]["launches"][name]
                                      for k in ("aggressive", "plain")),
                   "image_eval": img_runs["eval"]["launches"][name],
                   "text_prior": sum(r["launches"][name] for k, r in text_gen.items()
                                     if k.startswith("prior")),
                   "text_reconstruct": sum(r["launches"][name] for k, r in text_gen.items()
                                           if k.startswith("reconstruct")),
                   "image_generate": sum(r["launches"][name] for r in img_gen.values()),
                   "toy": sum(toy[k]["launches"][name] for k in ("aggressive0", "aggressive1")),
                   "autosave_resume": sum(r["launches"][name] for r in runs_a.values()),
                   "train_nsamples40": run_b["launches"][name],
                   "train_profiled": run_c["launches"][name],
                   "eval_reference_ckpt": sum(r["launches"][name] for r in runs_d.values()),
                   "docs_english": run_e["launches"][name],
                   "dp": sum(r["launches"][name] for k in ("dp_aggressive", "dp_plain")
                             for r in runs_p[k]["ranks"]),
                   "tp": sum(r["launches"][name] for k in ("tp_plain", "tp_eval")
                             for r in runs_p[k]["ranks"]),
                   "graphs": graph_launches.get(name, 0)}
        if not sum(by_path.values()):
            raise AssertionError(f"{name} was launched no time on the main paths: {by_path}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "on_main_path": True,
                        "max_abs_err": r["err_bf16"], "tolerance": tol,
                        "max_abs_err_f32": r.get("err_f32"),
                        "tolerance_f32": TOL.get((spec[0], "f32")),
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "library": r.get("library"),
                        "shape": r["shape"],
                        **{k: v for k, v in r.items() if k not in (
                            "name", "source", "replaces", "err_bf16", "err_f32", "ms", "plain_ms",
                            "bound_ms", "bound_by", "library_ms", "library", "shape",
                            "tolerance")}})
    # the f32-wh kernels: their main path is phase 10's, where every LSTM
    # launch is theirs; their figures at the H 512 model's shapes (the
    # training step's 32 rows, the IW decoder's 640) beside every shape of
    # phase 2's f32 checks
    for name, kind, replaces, shape in (
            ("lstm_fwd_residuals_f32", "resid", "vae_lagging_encoder_tpu/ops/lstm_pallas.py:67",
             "H512_rows32"),
            ("lstm_fwd_infer_f32", "infer", "vae_lagging_encoder_tpu/ops/lstm_pallas.py:166",
             "H512_rows640"),
            ("lstm_bwd_f32", "bwd", "vae_lagging_encoder_tpu/ops/lstm_pallas.py:269",
             "H512_rows32")):
        by_path = {path: got.get(name, 0) for path, got in h512_launches.items()}
        if not sum(by_path.values()):
            raise AssertionError(f"{name} was launched no time on the H 512 path: {by_path}")
        r, checks_k = f32_checks[kind][shape], f32_checks[kind]
        kernels.append({"name": name, "route": "cuda",
                        "source": "vae_lagging_encoder_tpu_torch/csrc/lstm_f32.cu",
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "on_main_path": True,
                        "max_abs_err": max(c["err"] for c in checks_k.values()),
                        "tolerance": r["tolerance"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "library": r["library"],
                        "kernel_ms": r["kernel_ms"], "floor_ms": r.get("floor_ms"),
                        "shape": f"T {T_CHECK}, {shape.replace('_', ', ')}, wh f32",
                        "f32_checks": checks_k})
    # the f32-operand CE kernel: on no model path (the decoder passes bf16),
    # so no launch on a main path; its figures at the training shape's N
    # 3040 (forward), every check of phase 2 beside them
    r = ce_f32[f"ce_fwd_n{CE_SPLIT_N}"]
    kernels.append({"name": "ce_f32", "route": "cuda",
                    "source": "vae_lagging_encoder_tpu_torch/csrc/ce_f32.cu",
                    "replaces": "vae_lagging_encoder_tpu/ops/ce_pallas.py:65", "launches": 0,
                    "launches_by_path": {}, "on_main_path": False,
                    "max_abs_err": max(c["err"] for c in ce_f32.values()),
                    "tolerance": r["tolerance"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "library": r["library"],
                    "kernel_ms": r["kernel_ms"],
                    "shape": f"N {CE_SPLIT_N}, nh {NH}, V {VOCAB}, f32 operands",
                    "ce_f32_checks": ce_f32})
    print(json.dumps({"trace_iw": trace_iw_res}), flush=True)
    print(json.dumps({"trace": trace}), flush=True)
    print(json.dumps({"image": img_line}), flush=True)
    print(json.dumps({"image_cross_check": img_cross}), flush=True)
    print(json.dumps({"trace_image": trace_img}), flush=True)
    print(json.dumps({"trace_image_iw": trace_img_iw}), flush=True)
    print(json.dumps({"generate": {
        "text": {k: {m: r[m] for m in ("sentences", "seconds", "sentences_per_sec")}
                 for k, r in text_gen.items()},
        "text_cross_check": text_gen_x,
        "image": {k: {m: r[m] for m in ("images", "seconds", "images_per_sec")}
                  for k, r in img_gen.items()},
        "image_cross_check": img_gen_x, "toy": toy, "max_decode_len": GEN_LEN,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}}), flush=True)
    print(json.dumps({"lifecycle": {**life, "device": torch.cuda.get_device_name(0),
                                    "nvidia_smi": smi}}), flush=True)
    print(json.dumps({"parallel": {
        **par_runs, "checks": par_checks, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "note": f"{PAR_RANKS} ranks sharing one card over gloo (collectives staged through "
                "the host): not multi-card scaling"}}), flush=True)
    print(graphs_line(graph_runs, smi), flush=True)
    print(json.dumps({"h512": {**h512, "device": torch.cuda.get_device_name(0),
                               "nvidia_smi": smi}}), flush=True)
    print(json.dumps({"ce_f32": {**ce_f32, "kernel": "ce_f32_kernel (csrc/ce_f32.cu, f32 "
                                 "operands; on no model path)",
                                 "device": torch.cuda.get_device_name(0),
                                 "nvidia_smi": smi}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
