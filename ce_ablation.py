#!/usr/bin/env python3
"""The bf16 CE forward kernel (``csrc/ce_fwd.cu``, both modes) timed on the
card in turns with a second build of the kernel, and with its products
alone; or, with ``f32``, the f32-operand kernel (``csrc/ce_f32.cu``).

    python3 ce_ablation.py [--old SOURCE] [--pairs P] [--shapes N1,N2]
    python3 ce_ablation.py f32 [--old SOURCE] [--pairs P] [--shapes N1,N2]

At h [N, 1024], W [1024, 20004] (the Yahoo decoder's width; N 3040 is the
T 96 training step, N 60800 a 20-sample chunk of ``--nsamples 40``
training and the IW decoder's batch), in both modes (``ce_fwd``,
``ce_fwd_train``):

- ``products``: a copy of this tree's source with the epilogue replaced by
  a sum of the accumulators (a text substitution, which raises when it no
  longer applies; some use of them must stay, or the compiler drops the
  products): the packing of W^T, the copies, the products and the merge,
  the yardstick of the epilogue's cost; ``no_exp``: the epilogue without
  its exponentials; ``no_spill``: grad mode without the spill's stores.
  They compute wrong values; only their times are read.
- ``phases``: a copy with clock64() timers in each block's first consumer
  warpgroup (``PHASES``): SM clocks a unit spent waiting for slabs, for a
  slab's products, in the epilogue, and in all.
- ``old``: where ``--old`` names a copy of an earlier ``ce_fwd.cu`` (one
  with the 128 x 256-tile plan: ``block_m`` 128, ``block_n`` 256, 4 stages,
  the vocab split over ``splits`` blocks, ``ce_fwd_bf16``'s arguments
  ``..., stages, splits, blocks, smem_bytes, stream``), that kernel under
  its own plan, timed in turns with this tree's: old, new, new, old, ``P``
  times, and checked against this tree's outputs first.

With ``f32`` (f32 h and W, TF32 off), in both modes: this tree's kernel
under its plan (``ce_f32_plan``) and, where ``--old`` names an earlier
``ce_fwd.cu`` with the f32 entry ``ce_fwd_f32(h, w, tgt, logp, lse,
spill, N, nh, V, save_logits, stream)`` (the SIMT kernel of 64-row blocks,
e.g. ``git show 29ad154:vae_lagging_encoder_tpu_torch/csrc/ce_fwd.cu``),
that kernel, timed in turns (old, new, new, old) and checked against this
tree's outputs first; the ``F32_VARIANTS`` (the products' loop unrolled
by 2 or 8, a ring of 6 slabs, and two that compute wrong values: the
shared loads of h or of W taken once), each against this tree's outputs;
``phases``: a copy of ``ce_f32.cu`` with clock64()
timers in lane 0 of each consumer warp and in the producer thread
(``F32_PHASES``): SM clocks a unit spent waiting for slabs, in the slabs'
products, in the epilogue, in the segments' merges, and in all, for the
warps together and each; the producer's waits for a free slot and its
issue of a slab's two copies.

Each time is the median of 10 CUDA-event timings of one call from an idle
stream (``ms``: the wrapper's host time falls inside) and of 10 calls back
to back divided by 10 (``dev_ms``: the card's time a call). Prints the card
and its power limit, then one JSON line per shape and mode. Needs one CUDA
GPU and ``nvcc``; builds into ``build/ce_ablation``. Nothing in the
package or its tests imports this file.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

from vae_lagging_encoder_tpu_torch.ops import build, ce_cuda

NH, VOCAB = 1024, 20004
OUT_DIR = build.BUILD_DIR.parent / "ce_ablation"
# the variants: the epilogue's call in the consumers' unit loop replaced by
# a sum of the accumulators that the kernel keeps (without some use of them
# the compiler drops the products; ``products``), the epilogue's
# exponentials replaced by the logits (``no_exp``), the grad-mode spill's
# stores removed (``no_spill``)
VARIANTS = {
    "products": (("        epilogue(sch.vocab_tile(u, b) * kBN);\n",
                  "        {\n          float z = 0.f;\n#pragma unroll\n"
                  "          for (int i = 0; i < (int)(sizeof(acc) / sizeof(float)); ++i) z += acc[i];\n"
                  "          if (z == 1.5e-38f) part[0] = z;\n        }\n"),),
    "no_exp": (("              const float p = ex2(fmaf(x, kLog2e, -ml));  // 0 past V\n",
                "              const float p = x;\n"),),
    # the grad-mode spill's stores removed (its shuffles kept)
    "no_spill": (("              if (row[hh] < N)\n"
                  "                *reinterpret_cast<uint4*>(spill + (size_t)row[hh] * Vp + col0 + 32 * a"
                  " + 8 * tq) =\n                    v;\n",
                  "              if (row[hh] < N && v.x == 0x12345u && v.y == 0x6789u)\n"
                  "                *reinterpret_cast<uint4*>(spill) = v;\n"),),
}
# clock64() timers of each block's first consumer warpgroup (its leader
# thread, PHASE_NAMES): the waits for slabs, the epilogue, the waits for a
# slab's products, the whole loop; written to a device array, read by
# ce_phases()
PHASE_NAMES = ("slab_wait", "epilogue", "mma_wait", "loop")
PHASES = (
    ("namespace wg = lstm_wgmma;\n",
     "namespace wg = lstm_wgmma;\n__device__ long long g_ce_phases[4096 * 4];\n"),
    ("  const int tid = threadIdx.x;\n  if (tid == 0) {",
     "  const int tid = threadIdx.x;\n  long long ph[4] = {0, 0, 0, 0}, ph0 = 0;\n"
     "  const long long ph_start = clock64();\n  if (tid == 0) {"),
    ("          wg::mbar_wait(full_bar(s), (g / kStages) & 1);\n",
     "          ph0 = clock64();\n          wg::mbar_wait(full_bar(s), (g / kStages) & 1);\n"
     "          ph[0] += clock64() - ph0;\n"),
    ("        epilogue(sch.vocab_tile(u, b) * kBN);\n",
     "        ph0 = clock64();\n        epilogue(sch.vocab_tile(u, b) * kBN);\n"
     "        ph[1] += clock64() - ph0;\n"),
    ("          wg::wgmma_wait<1>();  // slab g - 1 has been read\n",
     "          ph0 = clock64();\n          wg::wgmma_wait<1>();  // slab g - 1 has been read\n"
     "          ph[2] += clock64() - ph0;\n"),
    ("  cluster.sync();  // neither block leaves",
     "  if (tid == 0) {\n    ph[3] = clock64() - ph_start;\n"
     "    for (int q = 0; q < 4; ++q) g_ce_phases[blockIdx.x * 4 + q] = ph[q];\n  }\n"
     "  cluster.sync();  // neither block leaves"),
    ("const char* kernel_error_string(int err) {",
     "int ce_phases(long long* out, int n) {\n"
     "  return cudaMemcpyFromSymbol(out, g_ce_phases, n * sizeof(long long));\n}\n\n"
     "const char* kernel_error_string(int err) {"),
)
OLD_BLOCK_M, OLD_BLOCK_N, OLD_STAGES = 128, 256, 4
# variants of the f32 kernel (text substitutions of ce_f32.cu; plan fields
# the variant's launch takes instead of the plan's): the 8 steps of 4 k of a
# slab unrolled by 2 or all 8 instead of 4 (a loop body of half or twice the
# instructions), a ring of 6 slabs, fewer shared-memory loads
F32_VARIANTS = {
    "unroll2": ((("#pragma unroll 4\n      for (int q = 0; q < kBK / 4; ++q) {",
                  "#pragma unroll 2\n      for (int q = 0; q < kBK / 4; ++q) {"),), {}),
    "unroll8": ((("#pragma unroll 4\n      for (int q = 0; q < kBK / 4; ++q) {",
                  "#pragma unroll\n      for (int q = 0; q < kBK / 4; ++q) {"),), {}),
    "stages6": ((("constexpr int kStages = 4; ", "constexpr int kStages = 6; "),),
                {"stages": 6}),
    # wrong values, timed only: each step's 16-byte loads of h (a_reuse) or
    # of W (b_reuse) from one address, so the compiler keeps one load for
    # the unrolled body: the products' time without those shared loads
    "a_reuse": ((("slab + (a_off ^ (uint32_t)(q << 4))", "slab + a_off"),), {}),
    "b_reuse": ((("reinterpret_cast<const float*>(slab + b_off) + (4 * q + kk) * kBN",
                  "reinterpret_cast<const float*>(slab + b_off)"),), {}),
}
# clock64() timers of the f32 kernel, in lane 0 of each consumer warp: the
# waits for slabs, the slabs' products (wait excluded), the epilogue, the
# segments' merges, the whole loop; and in the producer thread: its waits
# for a free slot, its issue of a slab's copies, the whole loop (slot 8 of
# a block's 9); read by f32_phases()
F32_PHASE_NAMES = ("slab_wait", "products", "epilogue", "flush", "loop")
F32_PRODUCER_PHASES = {"slot_wait": 0, "issue": 1, "loop": 4}
F32_PHASES = (
    ("namespace wg = lstm_wgmma;\n",
     "namespace wg = lstm_wgmma;\n__device__ long long g_ce_phases[4096 * 9 * 5];\n"),
    ("  const int tid = threadIdx.x;\n  if (tid == 0) {",
     "  const int tid = threadIdx.x;\n  long long ph[5] = {0, 0, 0, 0, 0}, ph0 = 0;\n"
     "  const long long ph_start = clock64();\n  if (tid == 0) {"),
    ("          if (g >= kStages) wg::mbar_wait(empty_bar(s), (g / kStages - 1) & 1);\n",
     "          ph0 = clock64();\n"
     "          if (g >= kStages) wg::mbar_wait(empty_bar(s), (g / kStages - 1) & 1);\n"
     "          ph[0] += clock64() - ph0;\n          ph0 = clock64();\n"),
    ("          wg::tma_load_2d(sa + kABytes, &tm_w, v * kBN, ks * kBK, full_bar(s));\n",
     "          wg::tma_load_2d(sa + kABytes, &tm_w, v * kBN, ks * kBK, full_bar(s));\n"
     "          ph[1] += clock64() - ph0;\n"),
    ("    return;  // the consumers take no block-wide barrier from here on\n",
     "    if (tid == kConsumers) {\n      ph[4] = clock64() - ph_start;\n"
     "      for (int q = 0; q < 5; ++q) g_ce_phases[(blockIdx.x * 9 + 8) * 5 + q] = ph[q];\n"
     "    }\n    return;  // the consumers take no block-wide barrier from here on\n"),
    ("      wg::mbar_wait(full_bar(s), (g / kStages) & 1);\n",
     "      ph0 = clock64();\n      wg::mbar_wait(full_bar(s), (g / kStages) & 1);\n"
     "      ph[0] += clock64() - ph0;\n      ph0 = clock64();\n"),
    ("      if (lane == 0) wg::mbar_arrive(empty_bar(s));  // this warp is done with the slab\n",
     "      if (lane == 0) wg::mbar_arrive(empty_bar(s));  // this warp is done with the slab\n"
     "      ph[1] += clock64() - ph0;\n"),
    ("    const int col0 = v * kBN, c_lo = col0 + 4 * tx, c_hi = c_lo + 64;\n",
     "    ph0 = clock64();\n    const int col0 = v * kBN, c_lo = col0 + 4 * tx, c_hi = c_lo + 64;\n"),
    ("      m_run[i * R8] = mn;\n    }\n  }\n",
     "      m_run[i * R8] = mn;\n    }\n    ph[2] += clock64() - ph0;\n  }\n"),
    ("      if (cur >= 0) flush(cur);\n      cur = rt;\n",
     "      ph0 = clock64();\n      if (cur >= 0) flush(cur);\n      ph[3] += clock64() - ph0;\n"
     "      cur = rt;\n"),
    ("  if (cur >= 0) flush(cur);\n}\n",
     "  ph0 = clock64();\n  if (cur >= 0) flush(cur);\n  ph[3] += clock64() - ph0;\n"
     "  if (lane == 0) {\n    ph[4] = clock64() - ph_start;\n"
     "    for (int q = 0; q < 5; ++q) g_ce_phases[(blockIdx.x * 9 + warp) * 5 + q] = ph[q];\n"
     "  }\n}\n"),
    ("const char* kernel_error_string(int err) {",
     "int ce_phases(long long* out, int n) {\n"
     "  return cudaMemcpyFromSymbol(out, g_ce_phases, n * sizeof(long long));\n}\n\n"
     "const char* kernel_error_string(int err) {"),
)


def substituted(src: str, subs, what: str, source: str = "ce_fwd.cu") -> str:
    for a, b in subs:
        if src.count(a) != 1:
            raise RuntimeError(f"{what}: a substitution no longer applies to {source}: {a!r}")
        src = src.replace(a, b)
    return src


def build_copies(old: Path = None, f32: bool = False) -> Dict[str, ctypes.CDLL]:
    """The ``VARIANTS`` and the ``PHASES`` copy of this tree's source (with
    ``f32``: the ``F32_PHASES`` copy of ``ce_f32.cu``) and, with ``old``,
    that source: one ``nvcc`` each, started together, with this tree's
    headers."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for hdr in build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(hdr, OUT_DIR / hdr.name)
    if f32:
        src = (build.CSRC_DIR / "ce_f32.cu").read_text()
        texts = {k: substituted(src, subs, k, "ce_f32.cu") for k, (subs, _) in F32_VARIANTS.items()}
        texts["phases"] = substituted(src, F32_PHASES, "phases", "ce_f32.cu")
    else:
        src = (build.CSRC_DIR / "ce_fwd.cu").read_text()
        texts = {k: substituted(src, subs, k) for k, subs in VARIANTS.items()}
        texts["phases"] = substituted(src, PHASES, "phases")
    if old is not None:
        texts["old"] = Path(old).read_text()
    procs = {}
    for k, text in texts.items():
        (OUT_DIR / f"{k}.cu").write_text(text)
        procs[k] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(OUT_DIR / f"{k}.so"),
             str(OUT_DIR / f"{k}.cu")],
            stdout=open(OUT_DIR / f"{k}.log", "w"), stderr=subprocess.STDOUT)
    libs = {}
    for k, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{k} does not build:\n" + (OUT_DIR / f"{k}.log").read_text()[-3000:])
        libs[k] = ctypes.CDLL(str(OUT_DIR / f"{k}.so"))
    return libs


def old_forward(lib: ctypes.CDLL, nsm: int) -> Callable:
    """The earlier kernel's wrapper: its plan (the vocab split over the
    blocks of a row tile while there are fewer row tiles than SMs), its
    outputs and scratch, one launch."""
    fn = lib.ce_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def forward(hb, w, tgt, save):
        N, nh = hb.shape
        V = w.shape[1]
        row_tiles, nv = -(-N // OLD_BLOCK_M), -(-V // OLD_BLOCK_N)
        splits = max(1, min(nv, nsm // row_tiles))
        Vp, Kp = nv * OLD_BLOCK_N, -(-nh // 64) * 64
        dev = hb.device
        wt = torch.empty((Vp, Kp), device=dev, dtype=torch.bfloat16)
        logp, lse = torch.empty(N, device=dev), torch.empty(N, device=dev)
        spill = torch.empty((N, Vp), device=dev, dtype=torch.bfloat16) if save else None
        part = torch.empty((4, splits, N), device=dev) if splits > 1 else None
        smem = OLD_STAGES * (OLD_BLOCK_M + OLD_BLOCK_N) * 64 * 2 + 1024
        err = fn(hb.data_ptr(), w.data_ptr(), wt.data_ptr(), tgt.data_ptr(), logp.data_ptr(),
                 lse.data_ptr(), spill.data_ptr() if save else None,
                 part.data_ptr() if part is not None else None, N, nh, V, nh, Vp, Kp,
                 int(w.dtype == torch.float32), int(save), OLD_BLOCK_M, OLD_BLOCK_N, 64,
                 OLD_STAGES, splits, row_tiles * splits, smem,
                 torch.cuda.current_stream(dev).cuda_stream)
        build.check(lib, err, "old ce_fwd")
        return (logp, lse) + ((spill[:, :V],) if save else ())

    return forward


def time_ms(fn: Callable[[], object], reps: int = 10, batch: int = 1) -> float:
    """Median CUDA-event ms of ``fn``: one call at a time from an idle stream,
    or ``batch`` calls back to back divided by ``batch``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def timed(fn: Callable[[], object]) -> Dict[str, float]:
    return {"ms": time_ms(fn), "dev_ms": time_ms(fn, batch=10)}


def with_lib(lib: ctypes.CDLL, fn: Callable[[], object],
             source: str = "ce_fwd") -> Callable[[], object]:
    """``fn`` run with ``lib`` as the library of ``csrc/<source>.cu``."""
    def run():
        saved = build._LIBS.get(source)
        build._LIBS[source] = lib
        try:
            return fn()
        finally:
            build._LIBS[source] = saved
    return run


def phases(lib: ctypes.CDLL, fn: Callable[[], object], N: int) -> Dict[str, float]:
    """One call of ``fn`` with the ``PHASES`` copy: SM clocks a unit of each
    block's consumer warpgroup, averaged over the blocks, by phase."""
    with_lib(lib, fn)()
    torch.cuda.synchronize()
    plan = ce_cuda.ce_plan(N, NH, VOCAB, ce_cuda.ce_clusters(
        torch.device("cuda", 0), ce_cuda.CEPlan(N, NH, VOCAB, 1).smem_bytes))
    n = plan.blocks * len(PHASE_NAMES)
    buf = (ctypes.c_longlong * n)()
    lib.ce_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    build.check(lib, lib.ce_phases(ctypes.addressof(buf), n), "ce_phases")
    ph = np.array(buf[:], dtype=np.float64).reshape(plan.blocks, len(PHASE_NAMES))
    units = np.array([np.subtract(*plan.unit_range(b // 2)[::-1]) for b in range(plan.blocks)])
    per = ph / units[:, None]
    return {k: float(per[:, q].mean()) for q, k in enumerate(PHASE_NAMES)} | {
        "units": float(units.mean())}


def old_f32_forward(lib: ctypes.CDLL) -> Callable:
    """The earlier f32 kernel's wrapper: one launch, no plan."""
    fn = lib.ce_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def forward(h, w, tgt, save):
        N, nh = h.shape
        V = w.shape[1]
        logp, lse = torch.empty(N, device=h.device), torch.empty(N, device=h.device)
        spill = torch.empty((N, V), device=h.device) if save else None
        err = fn(h.data_ptr(), w.data_ptr(), tgt.data_ptr(), logp.data_ptr(), lse.data_ptr(),
                 spill.data_ptr() if save else None, N, nh, V, int(save),
                 torch.cuda.current_stream(h.device).cuda_stream)
        build.check(lib, err, "old ce_fwd_f32")
        return (logp, lse) + ((spill,) if save else ())

    return forward


def f32_phases(lib: ctypes.CDLL, fn: Callable[[], object], plan) -> Dict[str, object]:
    """One call of ``fn`` with the ``F32_PHASES`` copy: SM clocks a unit by
    phase, averaged over the blocks, for the consumer warps together and
    each (``warps``), and the producer's (``producer``)."""
    with_lib(lib, fn, "ce_f32")()
    torch.cuda.synchronize()
    n = plan.blocks * 9 * len(F32_PHASE_NAMES)
    buf = (ctypes.c_longlong * n)()
    lib.ce_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    build.check(lib, lib.ce_phases(ctypes.addressof(buf), n), "ce_phases")
    ph = np.array(buf[:], dtype=np.float64).reshape(plan.blocks, 9, len(F32_PHASE_NAMES))
    units = np.array([len(plan.block_units(c)) for c in range(plan.blocks)], dtype=np.float64)
    per = (ph / units[:, None, None]).mean(axis=0)  # [9, phase]
    return {k: float(per[:8, q].mean()) for q, k in enumerate(F32_PHASE_NAMES)} | {
        "warps": [{k: float(per[w, q]) for q, k in enumerate(F32_PHASE_NAMES)}
                  for w in range(8)],
        "producer": {k: float(per[8, q]) for k, q in F32_PRODUCER_PHASES.items()},
        "units": float(units.mean()), "loop_max": float(ph[:, :8, -1].max())}


def with_plan(fields: Dict[str, int], fn: Callable[[], object]) -> Callable[[], object]:
    """``fn`` run with the f32 plans' ``fields`` replaced (a variant's)."""
    def run():
        saved = ce_cuda.ce_f32_plan
        ce_cuda.ce_f32_plan = lambda *a: dataclasses.replace(saved(*a), **fields)
        try:
            return fn()
        finally:
            ce_cuda.ce_f32_plan = saved
    return run


def main_f32(args, dev) -> int:
    build.build(["ce_f32"])
    new_lib = build.library("ce_f32")
    libs = build_copies(args.old, f32=True)
    old = old_f32_forward(libs["old"]) if "old" in libs else None
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for N in (int(n) for n in args.shapes.split(",")):
            g = torch.Generator().manual_seed(N)
            h = torch.tanh(torch.randn(N, NH, generator=g)).to(dev)
            w = torch.empty(NH, VOCAB).uniform_(-0.05, 0.05, generator=g).to(dev)
            tgt = torch.randint(0, VOCAB, (N,), generator=g).to(dev).int()
            plan = ce_cuda.ce_f32_plan(N, NH, VOCAB, ce_cuda.ce_f32_blocks(dev))
            for save in (False, True):
                name = "ce_fwd_train" if save else "ce_fwd"
                new = with_lib(new_lib, lambda: ce_cuda.ce_forward(h, w, tgt, None,
                                                                   save_logits=save), "ce_f32")
                out = {"kernel": name, "operands": "f32", "N": N, "nh": NH, "V": VOCAB,
                       "plan": repr(plan)}
                turns = {"new": []}
                if old is not None:
                    got, ref = new(), old(h, w, tgt, save)
                    torch.cuda.synchronize()
                    out["max_abs_diff_old"] = max(float((a - b).abs().max())
                                                  for a, b in zip(got[:2], ref[:2]))
                    if save:
                        out["spill_max_abs_diff_old"] = float((got[2] - ref[2]).abs().max())
                    del got, ref
                    turns["old"] = []
                    for _ in range(args.pairs):
                        for k in ("old", "new", "new", "old"):
                            fn = new if k == "new" else (lambda: old(h, w, tgt, save))
                            turns[k].append(timed(fn))
                else:
                    turns["new"] = [timed(new) for _ in range(2 * args.pairs)]
                got = new()
                for k, (_, fields) in F32_VARIANTS.items():
                    var = with_plan(fields, with_lib(libs[k], lambda: ce_cuda.ce_forward(
                        h, w, tgt, None, save_logits=save), "ce_f32"))
                    out[f"max_abs_diff_{k}"] = max(float((a - b).abs().max())
                                                   for a, b in zip(got, var()))
                    turns[k] = [timed(var) for _ in range(args.pairs)]
                del got
                for k, ts in turns.items():
                    out[k] = {m: float(np.median([t[m] for t in ts])) for m in ("ms", "dev_ms")}
                    out[f"{k}_turns"] = ts
                out["phases"] = f32_phases(libs["phases"], lambda: ce_cuda.ce_forward(
                    h, w, tgt, None, save_logits=save), plan)
                print(json.dumps(out), flush=True)
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", choices=("bf16", "f32"), default="bf16",
                    help="the kernel: bf16 operands (ce_fwd.cu) or f32 (ce_f32.cu)")
    ap.add_argument("--old", type=Path, default=None,
                    help="an earlier ce_fwd.cu to time in turns with this tree's")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--shapes", default="3040,60800")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ce_ablation: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    if args.mode == "f32":
        return main_f32(args, dev)
    build.build(["ce_fwd"])
    new_lib = build.library("ce_fwd")
    libs = build_copies(args.old)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    old = old_forward(libs["old"], nsm) if "old" in libs else None
    for N in (int(n) for n in args.shapes.split(",")):
        g = torch.Generator().manual_seed(N)
        hb = torch.tanh(torch.randn(N, NH, generator=g)).to(dev).bfloat16()
        wb = torch.empty(NH, VOCAB).uniform_(-0.05, 0.05, generator=g).to(dev).bfloat16()
        tgt = torch.randint(0, VOCAB, (N,), generator=g).to(dev).int()
        for save in (False, True):
            name = "ce_fwd_train" if save else "ce_fwd"
            new = with_lib(new_lib, lambda: ce_cuda.ce_forward(hb, wb, tgt, save_logits=save))
            out = {"kernel": name, "N": N, "nh": NH, "V": VOCAB,
                   "plan": repr(ce_cuda.ce_plan(N, NH, VOCAB, ce_cuda.ce_clusters(
                       dev, ce_cuda.CEPlan(N, NH, VOCAB, 1).smem_bytes)))}
            turns = {"new": []}
            if old is not None:
                got, ref = new(), old(hb, wb, tgt, save)
                torch.cuda.synchronize()
                out["max_abs_diff_old"] = max(float((a - b).abs().max())
                                              for a, b in zip(got[:2], ref[:2]))
                if save:
                    out["spill_max_abs_diff_old"] = float((got[2].float() - ref[2].float())
                                                          .abs().max())
                del got, ref
                turns["old"] = []
                for _ in range(args.pairs):
                    for k in ("old", "new", "new", "old"):
                        fn = new if k == "new" else (lambda: old(hb, wb, tgt, save))
                        turns[k].append(timed(fn))
            else:
                turns["new"] = [timed(new) for _ in range(2 * args.pairs)]
            for k in VARIANTS:
                turns[k] = [timed(with_lib(libs[k], lambda: ce_cuda.ce_forward(
                    hb, wb, tgt, save_logits=save))) for _ in range(args.pairs)]
            for k, ts in turns.items():
                out[k] = {m: float(np.median([t[m] for t in ts])) for m in ("ms", "dev_ms")}
                out[f"{k}_turns"] = ts
            out["phases"] = phases(libs["phases"], lambda: ce_cuda.ce_forward(
                hb, wb, tgt, save_logits=save), N)
            print(json.dumps(out), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
