#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. device and build: prints the card and its power limit, builds the CUDA
   kernels from ``vae_lagging_encoder_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel);
2. kernel checks at the Yahoo slice's shapes: each kernel against its
   plain PyTorch version on the card, in bf16 and f32 operand mode, with
   timings (CUDA events), the plain version's and a library call's time,
   and the least time the card could take (``bound_ms``);
3. the slice end to end through the normal entry point: a Yahoo-shaped
   corpus and a Yahoo-width random model (seeded) are written to a
   temporary directory, ``cli.text.main([... "--eval" ...])`` runs the final
   evaluation (ELBO, MI, AU, 500-sample IW-NLL), the launch counters show
   the kernels ran, and one test batch is cross-checked against the plain
   versions at reduced ``iw_nsamples`` on the same injected noise.

Prints one JSON line per kernel, a ``{"kernels": [...]}`` line, and as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is available or the port's package is missing.
"""
from __future__ import annotations

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
       ("ce", "f32"): 1e-4, ("ce", "bf16"): 1e-3}


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
def check_lstm(save_residuals: bool, rows: int, ni: int, launches_key: str, dev):
    from vae_lagging_encoder_tpu_torch.ops import lstm_cuda

    g = torch.Generator(device="cpu").manual_seed(1 if save_residuals else 2)
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
            raise AssertionError(f"{launches_key} {mode}: max abs err {err} > {TOL[('lstm', mode)]}")
    whb = wh32.bfloat16()
    ms = time_ms(lambda: lstm_cuda.lstm_seq(xw, mask, whb, h0, c0, save_residuals))
    plain_ms = time_ms(lambda: lstm_cuda.lstm_seq_plain(xw, mask, whb, h0, c0, save_residuals), reps=5)
    ref_lstm = torch.nn.LSTM(ni, H, device=dev, dtype=torch.bfloat16)
    xb = x.bfloat16()
    lib_ms = time_ms(lambda: ref_lstm(xb))
    ops = 2.0 * T * rows * H * 4 * H
    out_f = T * rows * H * (2 + 4 if save_residuals else 1) + 2 * rows * H
    nbytes = 4.0 * (T * rows * 4 * H + T * rows + 2 * rows * H + out_f) + 2.0 * H * 4 * H
    bms, by = bound(ops, nbytes, PEAK_BF16)
    return dict(err_f32=errs["f32"], err_bf16=errs["bf16"], ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by,
                shape=f"T {T}, rows {rows}, input {ni}, H {H}, wh bf16")


def check_ce(dev):
    from vae_lagging_encoder_tpu_torch.ops import ce_cuda

    g = torch.Generator(device="cpu").manual_seed(4)
    N = B * IW_CHUNK * (T_CHECK - 1)
    h = torch.tanh(torch.randn(N, NH, generator=g)).to(dev)
    w = torch.empty(NH, VOCAB).uniform_(-0.05, 0.05, generator=g).to(dev)
    tgt = torch.randint(0, VOCAB, (N,), generator=g).to(dev)
    errs = {}
    for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
        got = ce_cuda.ce_forward(h, w, tgt, dt)
        ref = ce_cuda.ce_logp_plain(h, w, tgt, dt)
        torch.cuda.synchronize()
        err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        errs[mode] = err
        if not err <= TOL[("ce", mode)]:
            raise AssertionError(f"ce_fwd {mode}: max abs err {err} > {TOL[('ce', mode)]}")
    hb, wb = h.bfloat16(), w.bfloat16()
    ms = time_ms(lambda: ce_cuda.ce_forward(hb, wb, tgt))
    plain_ms = time_ms(lambda: ce_cuda.ce_logp_plain(hb, wb, tgt), reps=5)

    def library():
        logits = torch.matmul(hb, wb).float()
        return logits.gather(1, tgt[:, None])[:, 0] - torch.logsumexp(logits, -1)

    lib_ms = time_ms(library, reps=5)
    ops = 2.0 * N * NH * VOCAB
    nbytes = 2.0 * (N * NH + NH * VOCAB) + 4.0 * N + 8.0 * N
    bms, by = bound(ops, nbytes, PEAK_BF16)
    return dict(err_f32=errs["f32"], err_bf16=errs["bf16"], ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by,
                shape=f"N {N}, nh {NH}, V {VOCAB}, bf16 operands")


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
    n = pool.num_batches
    iw_chunks = cfg.iw_nsamples // cfg.iw_batch
    dec_calls = 1 + cfg.iw_nsamples // IW_CHUNK
    return {"lstm_fwd_infer": n * (1 + 1 + 2 + iw_chunks + dec_calls),
            "ce_fwd": n * dec_calls, "lstm_fwd_residuals": 0}


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


KERNELS = [
    ("lstm_fwd_residuals", "vae_lagging_encoder_tpu_torch/csrc/lstm_fwd.cu",
     "vae_lagging_encoder_tpu/ops/lstm_pallas.py:67", ("lstm", True, B, NI)),
    ("lstm_fwd_infer", "vae_lagging_encoder_tpu_torch/csrc/lstm_fwd.cu",
     "vae_lagging_encoder_tpu/ops/lstm_pallas.py:166", ("lstm", False, B * IW_CHUNK, NI + NZ)),
    ("ce_fwd", "vae_lagging_encoder_tpu_torch/csrc/ce_fwd.cu",
     "vae_lagging_encoder_tpu/ops/ce_pallas.py:65", ("ce",)),
]


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

    # phase 1 — device and build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    build_s = build.build()
    log(f"[build] {len(build.SOURCES)} CUDA sources built in {build_s:.1f} s")

    # phase 2 — kernels against their plain versions at the slice's shapes
    results = {}
    with torch.no_grad():
        for name, source, replaces, spec in KERNELS:
            r = check_lstm(spec[1], spec[2], spec[3], name, dev) if spec[0] == "lstm" \
                else check_ce(dev)
            r.update(name=name, source=source, replaces=replaces)
            results[name] = r
            log(json.dumps({"kernel_check": r}))

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

    kernels = []
    for name, source, replaces, spec in KERNELS:
        r = results[name]
        tol = TOL[(spec[0], "bf16")]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "on_main_path": name != "lstm_fwd_residuals",
                        "max_abs_err": r["err_bf16"], "tolerance": tol,
                        "max_abs_err_f32": r["err_f32"],
                        "tolerance_f32": TOL[(spec[0], "f32")],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
