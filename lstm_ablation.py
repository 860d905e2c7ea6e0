#!/usr/bin/env python3
"""Ablations of the PyTorch port's tensor-core LSTM kernels, and the row
sweep that sets ``ops/lstm_cuda.py::WIDE_MIN_ROWS``, timed on the card.

    python3 lstm_ablation.py

Builds copies of ``csrc/lstm_infer.cu`` and ``csrc/lstm_bwd.cu`` with one
part of the per-step work removed and times each beside the intact kernel
through the port's own launchers under a given plan
(``ops/lstm_cuda.py::lstm_infer`` and ``lstm_bwd_bf16``), with the variant's library in place of the built one. The
wide-row kernels (``namespace wide``, from ``WIDE_MIN_ROWS`` rows): the
wgmma products, the TMA loads of the operand ring, the cell epilogue, and
the backward's exchange of partial tiles between the two blocks of a
cluster; at T 96, H 1024 and 640 rows (the IW decoder's forward, and
``--nsamples 40`` training's forward and backward). The mma.sync kernels
(below it): the products, the cp.async copies, the shared-memory reads of
the A or B fragments, the whole k-loop, the cell epilogue, the backward's
L2 prefetch and its other k-chunks; at 32 rows (the encoder, the training
forward and backward). The time an ablation saves is what that part costs
when the rest runs. The ablated kernels compute wrong values; only their
times are read. Then the sweep: each of the three kernels under the
mma.sync plan and the wide plan at 32-640 rows, in turns (mma, wide, wide,
mma).

Last, the wide kernels' step at 640 rows split into phases: a copy of each
source with clock64() timers around the waits, the k-loop and the barrier
(``PHASES``), kept in registers and written out once, read back as SM
clocks a step for each consumer warpgroup (and the backward's epilogue
warpgroup) of the mean block; the timers add their own cost.

Prints the card and its power limit, then one JSON line per ablated shape
(median CUDA-event milliseconds of each variant, the intact kernel timed
first and last), per swept row count and per profiled kernel. Needs one CUDA GPU and ``nvcc``;
builds into ``build/lstm_ablation``. Each ablation is a list of text
substitutions in the source: when the source changes, a substitution that
no longer applies raises. A development tool: nothing in the package or its
tests imports it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
from typing import Callable, Dict

import numpy as np
import torch

from vae_lagging_encoder_tpu_torch.ops import build, lstm_cuda

T, H = 96, 1024
SWEEP_ROWS = (32, 64, 96, 128, 192, 256, 320, 640)
# the wide kernels' products, TMA tile loads and epilogues (the backward's
# is its epilogue warpgroup's cell), and the backward's cluster exchange;
# each ablation keeps every barrier's arrivals (a TMA-free ring slot
# completes on its producer's one arrival)
_NO_TMA = [("wg::mbar_arrive_tx(full_bar(w, s), wg::kTileBytes);",
            "wg::mbar_arrive(full_bar(w, s)); if (0)")]
ABLATIONS = {
    "lstm_infer_wide": {
        "no_mma": [("wg::wgmma_slab<kN>(", "if (0) wg::wgmma_slab<kN>(")],
        "no_tma": _NO_TMA,
        "no_epilogue": [("if (!ok[h][jh]) continue;", "if (!ok[h][jh] || t >= 0) continue;")],
    },
    "lstm_bwd_wide": {
        "no_mma": [("wg::wgmma_slab<kUnits>(", "if (0) wg::wgmma_slab<kUnits>(")],
        "no_tma": _NO_TMA,
        "no_exchange": [("wg::st_cluster(remote, ", "if (0) wg::st_cluster(remote, "),
                        ("wg::st_cluster(remote + 16, ", "if (0) wg::st_cluster(remote + 16, "),
                        ("wg::mbar_wait_cluster(recv_bar(j), use & 1);", "")],
        "no_epilogue": [("cell(t - 1, mt, in, dsum);", "if (t < 0) cell(t - 1, mt, in, dsum);")],
    },
    "lstm_infer": {
        "no_mma": [("if (live[m]) mma_bf16(acc[m][nt], af[m], bf);",
                    "if (live[m]) acc[m][nt][0] += __uint_as_float(af[m].x ^ bf.x);")],
        "no_copy": [("cp_async16(d + (kk * MG + m) * 32,",
                     "if (0) cp_async16(d + (kk * MG + m) * 32,")],
        "no_a_lds": [("af[m] = live[m] ? a[(kk * MG + m) * 32] : make_uint4(0, 0, 0, 0);",
                      "af[m] = make_uint4(lane, ks, m, kk);")],
        "no_b_lds": [("const uint2 bf = b[nt * 32];",
                      "const uint2 bf = make_uint2(lane + nt, ks);")],
        "no_k_loop": [("const int n_items = cdiv(ks1 - ks0, CK);",
                       "const int n_items = 0 * cdiv(ks1 - ks0, CK);")],
        "no_epilogue": [("if (wk != 0) continue;", "if (wk != 0 || t >= 0) continue;")],
    },
    "lstm_bwd": {
        "no_mma": [("mma_bf16(acc[m][nt], af, b[nt * 32]);",
                    "acc[m][nt][0] += __uint_as_float(af.x ^ b[nt * 32].x);")],
        "no_copy": [("cp_async16(d + (kk * MG + m) * 32, src",
                     "if (0) cp_async16(d + (kk * MG + m) * 32, src")],
        "no_k_loop": [("const int n_items = cdiv(ks1 - ks0, CK);",
                       "const int n_items = 0 * cdiv(ks1 - ks0, CK);")],
        "no_prefetch": [("if (t > 0) prefetch_cell(t - 1);", "")],
    },
}
OUT_DIR = build.BUILD_DIR.parent / "lstm_ablation"

# The phase timers: PROF(k, cycles) adds to the thread's register _p[k]; the
# consumer warpgroups' and the epilogue warpgroup's thread 0 write theirs
# to g_prof at the end. Each entry wraps one statement (or opens/closes a
# span) by text substitution, as the ablations do.
_PROF_HEAD = ("__device__ long long g_prof[132 * 4 * 8];\n"
              "__device__ long long _p[8];  // the 32-row kernels' timers, unread\n"
              "#define PROF(k, v) (_p[k] += (v))\n")
_PROF_READ = ('extern "C" int prof_read(long long* h) {\n'
              "  return cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n}\n")
_WRITE = ("  if (!producer && lt == 0)\n    for (int k = 0; k < 8; ++k)\n"
          "      g_prof[(blockIdx.x * 4 + (EPI ? 2 : w)) * 8 + k] = _p[k];\n")


def _timed(stmt: str, k: int) -> tuple:
    return stmt, "{ long long _a = clock64(); " + stmt + f" PROF({k}, clock64() - _a); }}"


PHASES = {
    "lstm_infer": (
        ["full_wait", "wgmma_wait", "release", "k_loop", "xw_wait", "grid_sync", "step"],
        [("  const bool producer = tid >= kConsumers;\n",
          "  const bool producer = tid >= kConsumers;\n  long long _p[8] = {};\n"),
         ("  cluster.sync();  // no block leaves", _WRITE.replace("EPI", "false")
          + "  cluster.sync();  // no block leaves"),
         ("  for (int t = 0; t < T_; ++t) {\n    if (producer) {",
          "  for (int t = 0; t < T_; ++t) {\n    long long _s0 = clock64();\n"
          "    if (producer) {"),
         ("    seq += n_loads;\n    if (t + 1 < T_) grid.sync();",
          "    PROF(6, clock64() - _s0);\n    seq += n_loads;\n"
          "    { long long _a = clock64(); if (t + 1 < T_) grid.sync(); PROF(5, clock64() - _a); }"),
         _timed("wg::mbar_wait(full_bar(w, s), (g / S) & 1);", 0),
         _timed("wg::wgmma_wait<1>();", 1),
         _timed("if (lt == 0 && ks > 0) release(i - 1);", 2),
         ("        for (int ks = 0; ks < KS; ++ks, ++i) {",
          "        long long _k0 = clock64();\n        for (int ks = 0; ks < KS; ++ks, ++i) {"),
         ("        wg::wgmma_wait<0>();\n",
          "        PROF(3, clock64() - _k0);\n        wg::wgmma_wait<0>();\n"),
         _timed("wg::mbar_wait(x_bar(w), xseq & 1);", 4)]),
    "lstm_bwd": (
        ["full_wait", "wgmma_wait", "release", "k_loop", "recv_wait", "grid_sync", "step",
         "sums_wait"],
        [("  const bool epilogue = tid >= kConsumers + kProducers;\n",
          "  const bool epilogue = tid >= kConsumers + kProducers;\n  long long _p[8] = {};\n"),
         ("  cluster.sync();  // no block leaves", _WRITE.replace("EPI", "epilogue")
          + "  cluster.sync();  // no block leaves"),
         ("    if (epilogue && t > 0) prefetch_cell(t - 1);\n",
          "    long long _s0 = clock64();\n    if (epilogue && t > 0) prefetch_cell(t - 1);\n"),
         ("    }\n    seq += n_loads;\n  }\n",
          "    }\n    PROF(6, clock64() - _s0);\n    seq += n_loads;\n  }\n"),
         ("grid.sync();  // da_t (ring slot t % 2) is complete in every block\n"
          "    if (producer) {",
          "{ long long _a = clock64(); grid.sync(); PROF(5, clock64() - _a); }\n"
          "    if (producer) {"),
         _timed("wg::mbar_wait(full_bar(w, s), (g / S) & 1);", 0),
         _timed("wg::wgmma_wait<1>();", 1),
         _timed("if (lt == 0 && ks > 0) wg::mbar_arrive(empty_bar(w, (seq + i - 1) % S));", 2),
         ("        for (int ks = 0; ks < KS; ++ks, ++i) {",
          "        long long _k0 = clock64();\n        for (int ks = 0; ks < KS; ++ks, ++i) {"),
         ("        wg::wgmma_wait<0>();\n",
          "        PROF(3, clock64() - _k0);\n        wg::wgmma_wait<0>();\n"),
         _timed("wg::mbar_wait_cluster(recv_bar(j), use & 1);", 4),
         _timed("wg::mbar_wait(epi_bar(j), slot_use(t, mt) & 1);", 7)]),
}


def source_of(group: str) -> str:
    return group.replace("_wide", "")


def build_profiled() -> Dict[str, ctypes.CDLL]:
    """Each source with the ``PHASES`` timers, one ``nvcc`` each, together."""
    procs = {}
    for name, (_, subs) in PHASES.items():
        src = (build.CSRC_DIR / f"{name}.cu").read_text()
        src = src.replace('#include "lstm_wgmma.cuh"\n', '#include "lstm_wgmma.cuh"\n' + _PROF_HEAD)
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: a phase timer no longer applies: {old!r}")
            src = src.replace(old, new)
        d = OUT_DIR / "phases"
        d.mkdir(parents=True, exist_ok=True)
        for hdr in build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(hdr, d / hdr.name)
        (d / f"{name}.cu").write_text(src + _PROF_READ)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / f"{name}.so"), str(d / f"{name}.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    out = {}
    for name, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{name}: the timed copy does not build")
        out[name] = ctypes.CDLL(str(OUT_DIR / "phases" / f"{name}.so"))
    return out


def build_variants() -> Dict[str, Dict[str, ctypes.CDLL]]:
    """Per group of ``ABLATIONS``: the intact source and each ablation, one
    ``nvcc`` each, all started together."""
    procs = {}
    for group, abl in ABLATIONS.items():
        name = source_of(group)
        src = (build.CSRC_DIR / f"{name}.cu").read_text()
        d = OUT_DIR / group
        d.mkdir(parents=True, exist_ok=True)
        for hdr in build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(hdr, d / hdr.name)
        texts = {"intact": src}
        for k, subs in abl.items():
            text = src
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"{group}: ablation {k} no longer applies to the source")
                text = text.replace(old, new)
            texts[k] = text
        for k, text in texts.items():
            (d / f"{k}.cu").write_text(text)
            procs[group, k] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / f"{k}.so"), str(d / f"{k}.cu")],
                stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    libs: Dict[str, Dict[str, ctypes.CDLL]] = {g: {} for g in ABLATIONS}
    for (group, k), p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{group}: variant {k} does not build")
        libs[group][k] = ctypes.CDLL(str(OUT_DIR / group / f"{k}.so"))
    return libs


def time_ms(fn: Callable[[], object], reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_with(name: str, lib: ctypes.CDLL, fn: Callable[[], object]) -> float:
    """``fn`` timed with ``lib`` as the library of ``csrc/<name>.cu``."""
    saved = build._LIBS.get(name)
    build._LIBS[name] = lib
    try:
        return time_ms(fn)
    finally:
        if saved is None:
            del build._LIBS[name]
        else:
            build._LIBS[name] = saved


def run(name: str, libs: Dict[str, ctypes.CDLL], fn: Callable[[], object],
        alternatives: Dict[str, Callable[[], object]]) -> Dict[str, float]:
    """The intact kernel first and last, every ablation and alternative
    (run with the intact library) between."""
    out = {"intact": time_with(name, libs["intact"], fn)}
    for k, lib in libs.items():
        if k != "intact":
            out[k] = time_with(name, lib, fn)
    for k, alt in alternatives.items():
        out[k] = time_with(name, libs["intact"], alt)
    out["intact_again"] = time_with(name, libs["intact"], fn)
    return out


def inputs(rows: int, seed: int, dev):
    g = torch.Generator().manual_seed(seed)
    xw = (0.5 * torch.randn(T, rows, 4 * H, generator=g)).to(dev)
    wh = torch.empty(H, 4 * H).uniform_(-H ** -0.5, H ** -0.5, generator=g).bfloat16().to(dev)
    h0, c0 = (0.1 * torch.randn(2, rows, H, generator=g)).to(dev)
    lens = np.minimum(np.clip(np.random.RandomState(seed).normal(80, 25, rows), 20, 160)
                      .astype(int) + 2, T)
    mask = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(np.float32)).to(dev)
    return xw, mask, wh, h0.contiguous(), c0.contiguous()


def bwd_args(rows: int, seed: int, dev):
    """``lstm_bwd``'s inputs: the residuals of one masked forward, seeded grads."""
    xw, mask, wh, h0, c0 = inputs(rows, seed, dev)
    _, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
    g = torch.Generator().manual_seed(seed + 1)
    dhs = (0.1 * torch.randn(T, rows, H, generator=g)).to(dev)
    dhT, dcT = (0.1 * torch.randn(2, rows, H, generator=g)).to(dev)
    return (gates, mask, wh, torch.cat([c0[None], cs[:-1]]), dhs, dhT.contiguous(),
            dcT.contiguous())


def sweep(nsm: int, dev):
    """Each kernel under the mma.sync plan and the wide plan at
    ``SWEEP_ROWS``, in turns (mma, wide, wide, mma): the medians."""
    for rows in SWEEP_ROWS:
        xw, mask, wh, h0, c0 = inputs(rows, rows, dev)
        args = bwd_args(rows, rows + 1, dev)
        line = {"sweep_rows": rows}
        for kind in ("infer", "resid", "bwd"):
            fns = {}
            for wide in (False, True):
                if kind == "bwd":
                    plan = (lstm_cuda.wide_plan("bwd", rows, H, nsm) if wide
                            else lstm_cuda.mma_bwd_plan(rows, H, nsm))
                    fns[wide] = lambda plan=plan: lstm_cuda.lstm_bwd_bf16(*args, plan)
                else:
                    res = kind == "resid"
                    plan = (lstm_cuda.wide_plan("infer", rows, H, nsm) if wide
                            else lstm_cuda.mma_infer_plan(rows, H, nsm, res))
                    fns[wide] = (lambda plan=plan, res=res:
                                 lstm_cuda.lstm_infer(xw, mask, wh, h0, c0, plan, res))
            turns = {False: [], True: []}
            for wide in (False, True, True, False):
                turns[wide].append(time_ms(fns[wide]))
            line[kind] = {"mma_ms": float(np.median(turns[False])),
                          "wide_ms": float(np.median(turns[True]))}
        print(json.dumps(line), flush=True)


def phases(nsm: int, dev, rows: int = 640):
    """One launch of each wide kernel at ``rows`` with the timed copy: SM
    clocks a step by phase for consumer warpgroups 0 and 1 (and the
    backward's epilogue warpgroup), the mean over blocks."""
    libs = build_profiled()
    for name, (names, _) in PHASES.items():
        if name == "lstm_infer":
            xw, mask, wh, h0, c0 = inputs(rows, 7, dev)
            plan = lstm_cuda.wide_plan("infer", rows, H, nsm)
            fn = lambda: lstm_cuda.lstm_infer(xw, mask, wh, h0, c0, plan, False)
        else:
            args = bwd_args(rows, 8, dev)
            plan = lstm_cuda.wide_plan("bwd", rows, H, nsm)
            fn = lambda: lstm_cuda.lstm_bwd_bf16(*args, plan)
        ms = time_with(name, libs[name], fn)  # the last launch's timers stay
        h = (ctypes.c_longlong * (132 * 4 * 8))()
        libs[name].prof_read(h)
        a = np.array(h[:], dtype=np.float64).reshape(132, 4, 8)[:plan.blocks] / T
        roles = {"consumer0": 0, "consumer1": 1} | ({"epilogue": 2} if name == "lstm_bwd" else {})
        print(json.dumps({"phases": "lstm_fwd_infer" if name == "lstm_infer" else name,
                          "rows": rows, "plan": repr(plan), "timed_ms": ms,
                          "sm_clocks_per_step": {
                              r: dict(zip(names, a[:, i, :len(names)].mean(0).round(1).tolist()))
                              for r, i in roles.items()}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_ablation: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build_variants()
    for rows, res, group in ((640, False, "lstm_infer_wide"), (640, True, "lstm_infer_wide"),
                             (32, False, "lstm_infer"), (32, True, "lstm_infer")):
        plan = (lstm_cuda.wide_plan("infer", rows, H, nsm) if group.endswith("wide")
                else lstm_cuda.mma_infer_plan(rows, H, nsm, res))
        xw, mask, wh, h0, c0 = inputs(rows, rows, dev)
        ms = run("lstm_infer", libs[group],
                 lambda: lstm_cuda.lstm_infer(xw, mask, wh, h0, c0, plan, res), {})
        print(json.dumps({"kernel": "lstm_fwd_residuals" if res else "lstm_fwd_infer",
                          "rows": rows, "plan": repr(plan), "ms": ms}), flush=True)
    for rows, group in ((640, "lstm_bwd_wide"), (32, "lstm_bwd")):
        args = bwd_args(rows, 5, dev)
        plan = (lstm_cuda.wide_plan("bwd", rows, H, nsm) if group.endswith("wide")
                else lstm_cuda.mma_bwd_plan(rows, H, nsm))
        alts = {}
        if isinstance(plan, lstm_cuda.MMAPlan):
            for ck in (1, 2, 4):
                alt = dataclasses.replace(plan, k_chunk=ck)
                if ck != plan.k_chunk and alt.smem_bytes <= lstm_cuda.SMEM_MAX:
                    alts[f"k_chunk_{ck}"] = lambda alt=alt: lstm_cuda.lstm_bwd_bf16(*args, alt)
        ms = run("lstm_bwd", libs[group], lambda: lstm_cuda.lstm_bwd_bf16(*args, plan), alts)
        print(json.dumps({"kernel": "lstm_bwd", "rows": rows, "plan": repr(plan), "ms": ms}),
              flush=True)
    sweep(nsm, dev)
    phases(nsm, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
