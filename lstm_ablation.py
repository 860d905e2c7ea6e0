#!/usr/bin/env python3
"""Ablations of the PyTorch port's tensor-core LSTM kernels, their phase
profiles, and the row sweep that sets ``ops/lstm_cuda.py::WIDE_MIN_ROWS``,
timed on the card.

    python3 lstm_ablation.py [ablations] [sweep] [pairs] [host] [phases] [f32]
                             [--groups G1,G2] [--old DIR]

Kernel groups (``ABLATIONS``): the wide-row kernels (``*_wide``: ``namespace
wide`` of ``csrc/lstm_infer.cu`` and ``csrc/lstm_bwd.cu``, from
``WIDE_MIN_ROWS`` rows; profiled at T 96, H 1024, 640 rows: the IW
decoder's forward, ``--nsamples 40`` training's forward and backward), the
narrow-row kernels (``*_narrow``: ``namespace narrow``, below it where a
narrow plan fits) and the mma.sync kernels (``lstm_infer``, ``lstm_bwd``:
the rows between), the last two at 32 rows (the encoder, the training
forward and backward); and the f32-wh kernels (``lstm_f32``: both
directions of ``csrc/lstm_f32.cu``, the route of every model whose LSTMs
are at most 512 wide in f32), at H 512 and 32 and 640 rows.

``ablations`` builds copies of each group's source with one part of the
per-step work removed (text substitutions: one that no longer applies
raises) and times each beside the intact kernel through the port's own
launchers under the group's plan (``lstm_cuda.lstm_infer`` and
``lstm_bwd_bf16``), with the variant's library in place of the built one:
the products, the copies, the cell, the backward's exchange of partial
tiles, the forward's multicast, and ``empty_step``: a step of only the
barrier and the operand exchange, whose time over T steps is the floor of
that design. The time an ablation saves is what that part costs when the
rest runs; the ablated kernels compute wrong values and only their times
are read.

``sweep`` times each of the three kernels under every plan that fits
(mma.sync, narrow, wide) at 1-640 rows, in turns (each plan, then in
reverse): the mma.sync plans run this tree's copy of the kernels the
narrow ones replaced.

``pairs`` times the narrow and the mma.sync plan of each kernel at 1, 20
and 32 rows in ``PAIRS`` pairs, in turns (narrow first in odd pairs,
mma.sync first in even ones): each pair's times and ratio, the medians and
how many pairs the narrow plan won, so that a gain can be set against the
spread between calls.

``host`` gives the host's milliseconds a call of the eager wrappers at 32
rows and T 2 (``lstm_seq`` with residuals, ``lstm_bwd``: the plan, the
outputs' allocation, the launch with its co-residency check), and of the
check's own CUDA runtime calls alone (``narrow_blocks``' query: the
kernel's shared-memory attribute and ``cudaOccupancyMaxActiveClusters``,
which ``launch_cluster_cooperative`` makes before every launch).

``f32`` times the f32 kernels (the residual forward, the forward without
residuals, the backward) against an earlier tree's in turns at H 512 (32,
20 and 640 rows), H 128 and H 50 (32 rows): ``--old DIR`` names a
directory holding that tree's ``lstm_fwd.cu`` and ``lstm_bwd.cu`` with
their headers (e.g. ``git archive <rev>
vae_lagging_encoder_tpu_torch/csrc | tar -x -C build/old``, never
committed), whose C entry points ``lstm_fwd`` and ``lstm_bwd_f32`` take no
plan; each pair's times (one call from an idle stream, and five back to
back: the device's time), the medians, and the new kernels' empty-step
floor (``ABLATIONS["lstm_f32"]["empty_step"]``).

``phases`` builds a copy of each source with clock64() timers around the
waits, the products, the exchange and the barrier (``PHASES``), kept in
registers and written out once, read back as SM clocks a step for the
roles of the mean block (``PHASE_ROLES``); the timers add their own cost.

Prints the card and its power limit, then one JSON line per ablated shape
(median CUDA-event milliseconds of each variant, the intact kernel timed
first and last), per swept row count and per profiled kernel. Needs one
CUDA GPU and ``nvcc``; builds into ``build/lstm_ablation``.
``chip_smoke.py`` builds and times the ``empty_step`` copies of the 32-row
plans' kernels through ``build_variants`` and ``time_with``. Nothing in
the package or its tests imports this file.
"""
from __future__ import annotations

import argparse
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
SWEEP_ROWS = (1, 20, 32, 48, 64, 96, 128, 192, 320, 640)
# the wide kernels' products, TMA tile loads and epilogues (the backward's
# is its epilogue warpgroup's cell), and the backward's cluster exchange;
# each ablation keeps every barrier's arrivals (a TMA-free ring slot
# completes on its producer's one arrival)
_NO_TMA = [("wg::mbar_arrive_tx(full_bar(w, s), wg::kTileBytes);",
            "wg::mbar_arrive(full_bar(w, s)); if (0)")]
_NARROW_FWD_MMA = ("for (int nt = 0; nt < NTILES; ++nt) mma_bf16(acc[nt], af, b[nt * 32]);",
                   "for (int nt = 0; nt < NTILES; ++nt) "
                   "acc[nt][0] += __uint_as_float(af.x ^ b[nt * 32].x);")
_NARROW_FWD_CELL = ("      if (!pok[i]) continue;\n      const int r16 = prow[i] & 15, j = punit[i] - u0;\n",
                    "      if (!pok[i] || t >= 0) continue;\n      const int r16 = prow[i] & 15, j = punit[i] - u0;\n")
_NARROW_BWD_MMA = ("if (m < MT) mma_bf16(acc[m][n], af[m], bfr[kk][n]);",
                   "if (m < MT) acc[m][n][0] += __uint_as_float(af[m].x ^ bfr[kk][n].x);")
# the empty step: no k-loop at all (no shared-memory reads of the operands)
_NARROW_FWD_LOOP = ("    for (int ks = ks0; ks < ks1; ++ks) {", "    for (int ks = ks0; ks < 0; ++ks) {")
_NARROW_BWD_LOOP = ("        if (kw0 + kk >= kw1) break;", "        if (kw0 + kk >= 0) break;")
# the stores of the outputs (hs, cs, gates; da) skipped
_NARROW_FWD_OUT = ("      const size_t so = (size_t)prow[i] * H + punit[i];\n      hs[(size_t)t * rows * H + so] = h[i];",
                   "      const size_t so = (size_t)prow[i] * H + punit[i];\n      if (t < 0) hs[(size_t)t * rows * H + so] = h[i];\n      if (t >= 0) continue;")
_NARROW_BWD_OUT = ("      store_da(t - 1);  // after the barrier", "      if (t < 0) store_da(t - 1);  // after the barrier")
_NARROW_BWD_CELL = ("      if (t > 0)\n        cell(t - 1, i, dh_in);", "      if (t < 0)\n        cell(t - 1, i, dh_in);")
# the f32-wh kernels (both directions in csrc/lstm_f32.cu): the FMA loop
# over a chunk's k (its waits and releases stay), the cell; the empty step
# keeps the barriers, the copies, the K-slice sums and the backward's
# exchange
_F32_LOOP = ("#pragma unroll\n      for (int j = 0; j < 4; ++j) {\n        float4 hv[4];",
             "#pragma unroll\n      for (int j = 0; j < 0; ++j) {\n        float4 hv[4];")
_F32_CELLS = [("          if (row >= rows || unit >= H) continue;",
               "          if (row >= rows || unit >= H || t >= 0) continue;"),
              ("          if (row >= B || unit >= H) continue;",
               "          if (row >= B || unit >= H || t >= 0) continue;")]
ABLATIONS = {
    "lstm_f32": {
        "no_products": [_F32_LOOP],
        "no_cell": _F32_CELLS,
        "empty_step": [_F32_LOOP, *_F32_CELLS],
    },
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
        # the empty step: the grid barrier and the operand copy into shared
        # memory, nothing else (no product, K-slice sum or cell)
        "empty_step": [("if (live[m]) mma_bf16(acc[m][nt], af[m], bf);", ";"),
                       ("if (WK > 1) {  // sum the K slices", "if (0) {  // sum the K slices"),
                       ("if (wk != 0) continue;", "if (wk != 0 || t >= 0) continue;")],
    },
    "lstm_bwd": {
        "no_mma": [("mma_bf16(acc[m][nt], af, b[nt * 32]);",
                    "acc[m][nt][0] += __uint_as_float(af.x ^ b[nt * 32].x);")],
        "no_copy": [("cp_async16(d + (kk * MG + m) * 32, src",
                     "if (0) cp_async16(d + (kk * MG + m) * 32, src")],
        "no_k_loop": [("const int n_items = cdiv(ks1 - ks0, CK);",
                       "const int n_items = 0 * cdiv(ks1 - ks0, CK);")],
        "no_prefetch": [("if (t > 0) prefetch_cell(t - 1);", "")],
        "empty_step": [("for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[m][nt], af, b[nt * 32]);",
                        ";"),
                       ("if (t > 0) prefetch_cell(t - 1);", ""),
                       ("      // sum the warps' partial tiles, then the cell backward of step t-1\n",
                        "      continue;\n")],
    },
    # the narrow-row kernels at 32 rows: the products, the cell, the
    # outputs' stores, the backward's exchange of partial tiles, the
    # forward's multicast; the empty step keeps the barriers and the copies
    # (and the backward's exchange and cluster barrier)
    "lstm_infer_narrow": {
        "no_mma": [_NARROW_FWD_MMA],
        "no_cell": [_NARROW_FWD_CELL],
        "no_outputs": [_NARROW_FWD_OUT],
        # every block copies the whole tile for itself (no multicast)
        "own_copy": [("  const int KSP = cdiv(KS, C), p0 = min(KS, crank * KSP), p1 = min(KS, p0 + KSP);",
                      "  const int KSP = KS, p0 = 0, p1 = KS;"),
                     ("(uint16_t)((1u << C) - 1));", "(uint16_t)(1u << crank));")],
        "empty_step": [_NARROW_FWD_LOOP, _NARROW_FWD_CELL],
    },
    "lstm_bwd_narrow": {
        "no_mma": [_NARROW_BWD_MMA],
        "no_exchange": [("      wg::st_cluster(wg::map_rank(slot, owner), v);",
                         "      if (v.x == 12345.f) wg::st_cluster(wg::map_rank(slot, owner), v);")],
        "no_cell": [_NARROW_BWD_CELL],
        "no_outputs": [_NARROW_BWD_OUT],
        "empty_step": [_NARROW_BWD_LOOP, _NARROW_BWD_CELL],
    },
}
OUT_DIR = build.BUILD_DIR.parent / "lstm_ablation"

# The phase timers: PROF(k, cycles) adds to the thread's register _p[k]; the
# consumer warpgroups' and the epilogue warpgroup's thread 0 write theirs
# to g_prof at the end. Each entry wraps one statement (or opens/closes a
# span) by text substitution, as the ablations do.
_PROF_HEAD = ("__device__ long long g_prof[{blocks} * 4 * 8];\n"
              "__device__ long long _p[8];  // the timers of a kernel with none of its own, unread\n"
              "#define PROF(k, v) (_p[k] += (v))\n")
_PROF_READ = ('extern "C" int prof_read(long long* h) {\n'
              "  return cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n}\n")
_WRITE = ("  if (!producer && lt == 0)\n    for (int k = 0; k < 8; ++k)\n"
          "      g_prof[(blockIdx.x * 4 + (EPI ? 2 : w)) * 8 + k] = _p[k];\n")


# the mma.sync kernels: warp 0 and the last warp of each block, roles 0 and 1
_WRITE_MMA = ("  if ((threadIdx.x & 31) == 0 && (threadIdx.x == 0 || threadIdx.x == blockDim.x - 32))\n"
              "    for (int k = 0; k < 8; ++k)\n"
              "      g_prof[(blockIdx.x * 4 + (threadIdx.x ? 1 : 0)) * 8 + k] = _p[k];\n")


# the f32 kernels: warp 0's lane 0 and the producer's lane 0
_WRITE_F32 = ("  if (lane == 0 && (warp == 0 || producer))\n    for (int k = 0; k < 8; ++k)\n"
              "      g_prof[(blockIdx.x * 4 + (producer ? 1 : 0)) * 8 + k] = _p[k];\n")


def _f32_spans(direction: str) -> list:
    """The f32 kernels' timers: a consumer's products (its chunks' waits
    and FMAs), the wait for every warp's partial tile (and the backward's
    slice sums and stores to the other block), the backward's cluster
    barrier, the cell, the grid barrier, the step; the producer's chunk
    loop as its products."""
    fwd = direction == "fwd"
    prods, n0 = ("products<4 * UPL>(acc,", "4 * UPL * cg4") if fwd else ("products<NU>(acc,",
                                                                        "NU * cg4")
    store = (f"        store_partial<{'4 * UPL' if fwd else 'NU'}>(red, acc, ks, RT, LD, "
             f"mw * kTileRows, rgl, {n0});\n        wg::bar_sync(1, nthr);\n")
    end = ("        wg::bar_sync(1, nthr);  // the partial tiles are rewritten by the next pass\n"
           if fwd else "        wg::bar_sync(1, nthr);  // red is rewritten by the next pass\n")
    produce = "produce<false>(" if fwd else "produce<true>("
    produced = ("                     (t + 1) & 1, crank, lane);\n" if fwd else
                "                    (t & 1) * 2 + (int)crank, crank, lane);\n")
    top = ("    const uint32_t g0 = (uint32_t)t * P * NCH;\n" if fwd else
           "    const uint32_t g0 = pbase * NCH;                    // their chunks\n")
    tail = ("    if (t + 1 < T_) grid.sync();\n  }\n  cluster.sync();  // no block leaves while "
            "the other may still write to it or arrive on it\n" if fwd else
            "    if (t > 0) grid.sync();\n  }\n  cluster.sync();  // no block leaves while the "
            "other may still write to it\n")
    sync = "if (t + 1 < T_) grid.sync();" if fwd else "if (t > 0) grid.sync();"
    decl = ("  const size_t H4 = 4 * (size_t)H, slot_elems = (size_t)rows * Hp;\n" if fwd else
            "  const size_t H4 = 4 * (size_t)H;\n\n  // wh's rows of the cluster's units")
    subs = [(decl, decl.replace("\n", "\n  long long _p[8] = {};\n", 1)),
            (top, top + "    long long _s0 = clock64();\n"),
            ("      " + produce, "      long long _m0 = clock64();\n      " + produce),
            (produced, produced + "      PROF(0, clock64() - _m0);\n"),
            ("        " + prods, "        long long _m0 = clock64();\n        " + prods),
            (store, store.replace("        wg::bar_sync(1, nthr);\n",
                                  "        PROF(0, clock64() - _m0);\n        long long _r0 = "
                                  "clock64();\n        wg::bar_sync(1, nthr);\n")
             + ("        PROF(1, clock64() - _r0);\n        long long _e0 = clock64();\n"
                if fwd else "")),
            (end, "        PROF(3, clock64() - _e0);\n" + end),
            (tail, f"    {{ long long _a = clock64(); {sync} PROF(4, clock64() - _a); }}\n"
                   "    PROF(5, clock64() - _s0);\n  }\n" + _WRITE_F32
                   + tail.split("  }\n", 1)[1])]
    if not fwd:
        subs.append(("        cluster_sync_all();  // every sum is in its owner's receive buffer\n",
                     "        PROF(1, clock64() - _r0);\n        { long long _a = clock64(); "
                     "cluster_sync_all(); PROF(2, clock64() - _a); }\n"
                     "        long long _e0 = clock64();\n"))
    return subs


# the narrow-row kernels: warp 0's lane 0 and the last warp's lane 0
_WRITE_NARROW = ("  if ((tid & 31) == 0 && (tid == 0 || tid == nthr - 32))\n"
                 "    for (int k = 0; k < 8; ++k)\n"
                 "      g_prof[(blockIdx.x * 4 + (tid ? 1 : 0)) * 8 + k] = _p[k];\n")


def _timed(stmt: str, k: int) -> tuple:
    return stmt, "{ long long _a = clock64(); " + stmt + f" PROF({k}, clock64() - _a); }}"


PHASES = {
    "lstm_f32": (["products", "k_sum", "exchange", "cell", "grid_sync", "step"],
                 _f32_spans("fwd") + _f32_spans("bwd")),
    "lstm_infer_wide": (
        ["full_wait", "wgmma_wait", "release", "k_loop", "xw_wait", "grid_sync", "step"],
        [("  const bool producer = tid >= kConsumers;\n",
          "  const bool producer = tid >= kConsumers;\n  long long _p[8] = {};\n"),
         ("  cluster.sync();  // no block leaves while the other", _WRITE.replace("EPI", "false")
          + "  cluster.sync();  // no block leaves while the other"),
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
    "lstm_bwd_wide": (
        ["full_wait", "wgmma_wait", "release", "k_loop", "recv_wait", "grid_sync", "step",
         "sums_wait"],
        [("  const bool epilogue = tid >= kConsumers + kProducers;\n",
          "  const bool epilogue = tid >= kConsumers + kProducers;\n  long long _p[8] = {};\n"),
         ("  cluster.sync();  // no block leaves while the other", _WRITE.replace("EPI", "epilogue")
          + "  cluster.sync();  // no block leaves while the other"),
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
    # the mma.sync kernels at 32 rows: warp 0 (K slice 0 of the forward's
    # first m-tile column, which runs the cell) and the last warp
    "lstm_infer": (
        ["copy_wait", "k_loop", "k_sum", "epilogue", "grid_sync", "step"],
        [("  const int g = lane >> 2, tig = lane & 3;\n",
          "  const int g = lane >> 2, tig = lane & 3;\n  long long _p[8] = {}, _e0 = 0;\n"),
         ("  for (int t = 0; t < T_; ++t) {\n    const __nv_bfloat16* src",
          "  for (int t = 0; t < T_; ++t) {\n    long long _s0 = clock64();\n"
          "    const __nv_bfloat16* src"),
         ("      const int n_items = cdiv(ks1 - ks0, CK);",
          "      long long _k0 = clock64();\n      const int n_items = cdiv(ks1 - ks0, CK);"),
         ("      if (WK > 1) {  // sum the K slices",
          "      PROF(1, clock64() - _k0);\n      long long _r0 = clock64();\n"
          "      if (WK > 1) {  // sum the K slices"),
         ("      if (wk != 0) continue;\n",
          "      PROF(2, clock64() - _r0);\n      if (wk != 0) continue;\n      _e0 = clock64();\n"),
         ("    if (t + 1 < T_) grid.sync();\n  }\n}\n\nsize_t smem_bytes_for",
          "    if (wk == 0) PROF(3, clock64() - _e0);\n"
          "    { long long _a = clock64(); if (t + 1 < T_) grid.sync(); PROF(4, clock64() - _a); }\n"
          "    PROF(5, clock64() - _s0);\n  }\n" + _WRITE_MMA + "}\n\nsize_t smem_bytes_for"),
         _timed("cp_async_wait<kStages - 1>();", 0)]),
    "lstm_bwd": (
        ["copy_wait", "k_loop", "k_sum", "epilogue", "grid_sync", "step"],
        [("  const int ks0 = min(KS, warp * KSW), ks1 = min(KS, ks0 + KSW);\n",
          "  const int ks0 = min(KS, warp * KSW), ks1 = min(KS, ks0 + KSW);\n"
          "  long long _p[8] = {};\n"),
         ("    if (t > 0) prefetch_cell(t - 1);\n    grid.sync();  // da_t (ring slot t % 2) is "
          "complete in every block\n",
          "    long long _s0 = clock64();\n    if (t > 0) prefetch_cell(t - 1);\n"
          "    { long long _a = clock64(); grid.sync(); PROF(4, clock64() - _a); }\n"),
         ("      const int n_items = cdiv(ks1 - ks0, CK);",
          "      long long _k0 = clock64();\n      const int n_items = cdiv(ks1 - ks0, CK);"),
         ("      // sum the warps' partial tiles, then the cell backward of step t-1\n",
          "      PROF(1, clock64() - _k0);\n      long long _r0 = clock64();\n"),
         ("      __syncthreads();\n      for (int s = threadIdx.x; s < SLOTS; s += blockDim.x) {",
          "      __syncthreads();\n      PROF(2, clock64() - _r0);\n      long long _e0 = clock64();\n"
          "      for (int s = threadIdx.x; s < SLOTS; s += blockDim.x) {"),
         ("      __syncthreads();  // red is rewritten by the next pass\n    }\n  }\n}\n",
          "      PROF(3, clock64() - _e0);\n      __syncthreads();  // red is rewritten by the next pass\n"
          "    }\n    PROF(5, clock64() - _s0);\n  }\n" + _WRITE_MMA + "}\n"),
         _timed("cp_async_wait<kStages - 1>();", 0)]),
    # the narrow-row kernels at 32 rows: warp 0's lane 0 and the last warp's
    # lane 0 (the copier)
    "lstm_infer_narrow": (
        ["inputs", "full_wait", "product", "k_sum", "cell", "grid_sync", "step"],
        [("  const int KSP = cdiv(KS, C), p0 = min(KS, crank * KSP), p1 = min(KS, p0 + KSP);\n",
          "  const int KSP = cdiv(KS, C), p0 = min(KS, crank * KSP), p1 = min(KS, p0 + KSP);\n"
          "  long long _p[8] = {};\n"),
         ("    // the cell's inputs of step t, requested before the copy and the product\n",
          "    long long _s0 = clock64();\n"),
         ("    // this block's piece of h_{t-1} (ring slot (t + 1) % 2), into every\n",
          "    PROF(0, clock64() - _s0);\n"),
         ("    wg::mbar_wait(full_bar, t & 1);\n\n    float acc[NTILES][4];",
          "    { long long _a = clock64(); wg::mbar_wait(full_bar, t & 1); PROF(1, clock64() - _a); }\n"
          "    long long _m0 = clock64();\n    float acc[NTILES][4];"),
         ("    {\n      float4* mine = red",
          "    PROF(2, clock64() - _m0);\n    long long _r0 = clock64();\n    {\n      float4* mine = red"),
         ("    // the cell; h_t goes to the ring before the barrier, the outputs after it\n",
          "    PROF(3, clock64() - _r0);\n    long long _e0 = clock64();\n"),
         ("    if (t + 1 < T_) {  // h_t is out in every block; the partial tiles are read\n",
          "    PROF(4, clock64() - _e0);\n    long long _g0 = clock64();\n"
          "    if (t + 1 < T_) {  // h_t is out in every block; the partial tiles are read\n"),
         ("    // the outputs, after the barrier: the next step's copy does not wait for them\n",
          "    PROF(5, clock64() - _g0);\n"),
         ("        for (int q = 0; q < 4; ++q) gt[(size_t)q * H] = act[i][q];\n      }\n    }\n  }\n",
          "        for (int q = 0; q < 4; ++q) gt[(size_t)q * H] = act[i][q];\n      }\n    }\n"
          "    PROF(6, clock64() - _s0);\n  }\n"),
         ("  cluster.sync();  // no block leaves while a piece it copied may still land in another",
          _WRITE_NARROW + "  cluster.sync();  // no block leaves while a piece it copied may still land")]),
    "lstm_bwd_narrow": (
        ["inputs", "full_wait", "product", "exchange", "cell", "grid_sync", "step"],
        [("  const uint32_t full_bar = wg::smem_u32(smem + L.bar);\n",
          "  const uint32_t full_bar = wg::smem_u32(smem + L.bar);\n  long long _p[8] = {};\n"),
         ("    const int s = T_ - 1 - t;  // steps done\n    if (t > 0) load_in(t - 1);\n",
          "    const int s = T_ - 1 - t;  // steps done\n    long long _s0 = clock64();\n"
          "    if (t > 0) load_in(t - 1);\n    PROF(0, clock64() - _s0);\n"),
         ("    if (k0 < k1) wg::mbar_wait(full_bar, s & 1);\n",
          "    { long long _a = clock64(); if (k0 < k1) wg::mbar_wait(full_bar, s & 1); "
          "PROF(1, clock64() - _a); }\n    long long _m0 = clock64();\n"),
         ("    cluster.sync();  // every partial tile is in its owner's receive slot\n",
          "    PROF(2, clock64() - _m0);\n    { long long _a = clock64(); cluster.sync(); "
          "PROF(3, clock64() - _a); }\n    long long _e0 = clock64();\n"),
         ("    if (t > 0) {  // da_{t-1} is out in every block; the receive slots are read\n",
          "    PROF(4, clock64() - _e0);\n    long long _g0 = clock64();\n"
          "    if (t > 0) {  // da_{t-1} is out in every block; the receive slots are read\n"),
         ("      store_da(t - 1);  // after the barrier: the next step's copy does not wait for it\n"
          "    }\n  }\n",
          "      PROF(5, clock64() - _g0);\n"
          "      store_da(t - 1);  // after the barrier: the next step's copy does not wait for it\n"
          "    }\n    PROF(6, clock64() - _s0);\n  }\n"),
         ("  cluster.sync();  // no block leaves while another may still write to it",
          _WRITE_NARROW + "  cluster.sync();  // no block leaves while another may still write to it")]),
}


def source_of(group: str) -> str:
    return group.replace("_wide", "").replace("_narrow", "")


def build_profiled(groups, nsm: int) -> Dict[str, ctypes.CDLL]:
    """A copy of each group's source with its ``PHASES`` timers (room for
    ``nsm`` blocks' timers; ``prof_clocks`` refuses a larger grid), one
    ``nvcc`` each, all started together."""
    procs = {}
    for group in groups:
        _, subs = PHASES[group]
        name = source_of(group)
        src = (build.CSRC_DIR / f"{name}.cu").read_text()
        src = src.replace('#include "lstm_wgmma.cuh"\n', '#include "lstm_wgmma.cuh"\n' + _PROF_HEAD.format(blocks=nsm))
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{group}: a phase timer no longer applies: {old!r}")
            src = src.replace(old, new)
        d = OUT_DIR / "phases" / group
        d.mkdir(parents=True, exist_ok=True)
        for hdr in build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(hdr, d / hdr.name)
        (d / f"{name}.cu").write_text(src + _PROF_READ)
        procs[group] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / f"{name}.so"), str(d / f"{name}.cu")],
            stdout=open(d / f"{name}.log", "w"), stderr=subprocess.STDOUT)
    out = {}
    for group, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{group}: the timed copy does not build:\n"
                               + (OUT_DIR / "phases" / group / f"{source_of(group)}.log")
                               .read_text()[-3000:])
        out[group] = ctypes.CDLL(str(OUT_DIR / "phases" / group / f"{source_of(group)}.so"))
    return out


def build_variants(groups, kinds=None) -> Dict[str, Dict[str, ctypes.CDLL]]:
    """Per group of ``ABLATIONS`` in ``groups``: the intact source and each
    ablation (or only the ``kinds`` named), one ``nvcc`` each, all started
    together."""
    procs = {}
    for group in groups:
        abl = {k: v for k, v in ABLATIONS[group].items() if kinds is None or k in kinds}
        name = source_of(group)
        src = (build.CSRC_DIR / f"{name}.cu").read_text()
        d = OUT_DIR / group
        d.mkdir(parents=True, exist_ok=True)
        for hdr in build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(hdr, d / hdr.name)
        texts = {"intact": src} if kinds is None else {}
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
                stdout=open(d / f"{k}.log", "w"), stderr=subprocess.STDOUT)
    libs: Dict[str, Dict[str, ctypes.CDLL]] = {g: {} for g in groups}
    for (group, k), p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{group}: variant {k} does not build:\n"
                               + (OUT_DIR / group / f"{k}.log").read_text()[-3000:])
        libs[group][k] = ctypes.CDLL(str(OUT_DIR / group / f"{k}.so"))
    return libs


def time_ms(fn: Callable[[], object], reps: int = 10, batch: int = 1) -> float:
    """Median CUDA-event ms of ``fn``: one call at a time, each from an idle
    stream (its host time before the launch falls inside the events), or
    ``batch`` calls back to back, divided by ``batch`` (the host enqueues
    the next call while the card runs the last: device time, where the
    host's time a call is shorter)."""
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


def inputs(rows: int, seed: int, dev, H: int = H, wh_dtype=torch.bfloat16):
    """``lstm_seq``'s inputs at ``H``: (xw, mask, wh, h0, c0)."""
    g = torch.Generator().manual_seed(seed)
    xw = (0.5 * torch.randn(T, rows, 4 * H, generator=g)).to(dev)
    wh = torch.empty(H, 4 * H).uniform_(-H ** -0.5, H ** -0.5, generator=g).to(wh_dtype).to(dev)
    h0, c0 = (0.1 * torch.randn(2, rows, H, generator=g)).to(dev)
    lens = np.minimum(np.clip(np.random.RandomState(seed).normal(80, 25, rows), 20, 160)
                      .astype(int) + 2, T)
    mask = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(np.float32)).to(dev)
    return xw, mask, wh, h0.contiguous(), c0.contiguous()


def bwd_args(rows: int, seed: int, dev, H: int = H, wh_dtype=torch.bfloat16):
    """``lstm_bwd``'s inputs: the residuals of one masked forward, seeded grads."""
    xw, mask, wh, h0, c0 = inputs(rows, seed, dev, H, wh_dtype)
    _, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
    g = torch.Generator().manual_seed(seed + 1)
    dhs = (0.1 * torch.randn(T, rows, H, generator=g)).to(dev)
    dhT, dcT = (0.1 * torch.randn(2, rows, H, generator=g)).to(dev)
    return (gates, mask, wh, torch.cat([c0[None], cs[:-1]]), dhs, dhT.contiguous(),
            dcT.contiguous())


def plan_fns(kind: str, rows: int, nsm: int, fwd_in, bwd_in) -> Dict[str, Callable[[], object]]:
    """A launch of ``kind`` ("infer", "resid" or "bwd") under each plan that
    fits at ``rows`` (the mma.sync, the narrow, the wide plan)."""
    res, key = kind == "resid", "bwd" if kind == "bwd" else "infer"
    plans = {"mma": (lstm_cuda.mma_bwd_plan(rows, H, nsm) if key == "bwd"
                     else lstm_cuda.mma_infer_plan(rows, H, nsm, res)),
             "narrow": lstm_cuda.narrow_plan(key, rows, H, nsm),
             "wide": lstm_cuda.wide_plan(key, rows, H, nsm)}
    return {name: ((lambda plan=plan: lstm_cuda.lstm_bwd_bf16(*bwd_in, plan)) if key == "bwd"
                   else (lambda plan=plan: lstm_cuda.lstm_infer(*fwd_in, plan, res)))
            for name, plan in plans.items() if plan is not None}


def sweep(nsm: int, dev):
    """Each kernel under every plan that fits at ``SWEEP_ROWS`` (the
    mma.sync plan, the narrow plan, the wide plan), timed in turns (each
    plan in order, then in reverse): the medians."""
    for rows in SWEEP_ROWS:
        fwd_in, bwd_in = inputs(rows, rows, dev), bwd_args(rows, rows + 1, dev)
        line = {"sweep_rows": rows}
        for kind in ("infer", "resid", "bwd"):
            fns = plan_fns(kind, rows, nsm, fwd_in, bwd_in)
            turns = {k: [] for k in fns}
            for k in list(fns) + list(fns)[::-1]:
                turns[k].append(time_ms(fns[k]))
            line[kind] = {f"{k}_ms": float(np.median(v)) for k, v in turns.items()}
        print(json.dumps(line), flush=True)


PAIR_ROWS = (1, 20, 32)
PAIRS = 12


def pairs(nsm: int, dev) -> None:
    """The narrow and the mma.sync plan of each kernel at ``PAIR_ROWS`` in
    ``PAIRS`` pairs, in turns: each pair's ms (narrow, mma.sync), the
    medians, the ratios' range and the pairs the narrow plan won; one call
    at a time from an idle stream (``single``) and ten back to back
    (``back_to_back``: the device's time)."""
    for rows in PAIR_ROWS:
        fwd_in, bwd_in = inputs(rows, rows, dev), bwd_args(rows, rows + 1, dev)
        for kind in ("infer", "resid", "bwd"):
            fns = plan_fns(kind, rows, nsm, fwd_in, bwd_in)
            if "narrow" not in fns:
                continue
            got = {"single": [], "back_to_back": []}
            for i in range(PAIRS):
                order = ("narrow", "mma") if i % 2 == 0 else ("mma", "narrow")
                for mode, batch in (("single", 1), ("back_to_back", 10)):
                    t = {k: time_ms(fns[k], batch=batch) for k in order}
                    got[mode].append((t["narrow"], t["mma"]))
            line = {"pairs_rows": rows, "kernel": kind, "pairs": PAIRS}
            for mode, g in got.items():
                n, m = np.array(g).T
                line[mode] = {"pairs_ms": g, "narrow_median_ms": float(np.median(n)),
                              "mma_median_ms": float(np.median(m)),
                              "ratio_min": float((n / m).min()),
                              "ratio_median": float(np.median(n / m)),
                              "ratio_max": float((n / m).max()), "narrow_won": int((n < m).sum())}
            print(json.dumps(line), flush=True)


def host(dev, calls: int = 200) -> None:
    """Host ms a call: the eager wrappers at 32 rows, T 2, and the cluster
    capacity query of each narrow kernel alone."""
    import time
    T2, rows = 2, 32
    xw, mask, wh, h0, c0 = inputs(rows, 3, dev)
    xw, mask = xw[:T2].contiguous(), mask[:T2].contiguous()
    hs, cs, gates, _, _ = lstm_cuda.lstm_seq(xw, mask, wh, h0, c0, True)
    c_prev = torch.cat([c0[None], cs[:-1]])
    lib_f, lib_b = build.library("lstm_infer"), build.library("lstm_bwd")
    n = ctypes.c_int(0)
    fns = {"lstm_seq_residuals": lambda: lstm_cuda.lstm_seq(xw, mask, wh, h0, c0, True),
           "lstm_bwd": lambda: lstm_cuda.lstm_bwd(gates, mask, wh, c_prev, hs, h0, c0),
           "capacity_query_infer": lambda: lib_f.lstm_infer_narrow_blocks(1, ctypes.byref(n)),
           "capacity_query_bwd": lambda: lib_b.lstm_bwd_narrow_blocks(ctypes.byref(n))}
    out = {}
    for k, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[k] = {"host_ms_per_call": (t1 - t0) * 1e3 / calls,
                  "wall_ms_per_call": (time.perf_counter() - t0) * 1e3 / calls}
    print(json.dumps({"host": out, "rows": rows, "T": T2, "calls": calls}), flush=True)


def phases(nsm: int, dev, groups):
    """One launch of each kernel of ``PHASES`` in ``groups`` with its timed
    copy: SM clocks a step by phase, the mean over blocks; the wide kernels
    at 640 rows (consumer warpgroups 0 and 1, the backward's epilogue
    warpgroup), the others at 32 (the roles ``PHASE_ROLES`` names, else
    warp 0 and the last warp)."""
    groups = [g for g in groups if g in PHASES]
    libs = build_profiled(groups, nsm)
    for group in groups:
        names, _ = PHASES[group]
        if group == "lstm_f32":
            f32_phases(nsm, dev, libs[group], names)
            continue
        name, wide = source_of(group), group.endswith("_wide")
        rows = 640 if wide else 32
        plan = plan_of(group, rows, nsm)
        if name == "lstm_infer":
            xw, mask, wh, h0, c0 = inputs(rows, 7, dev)
            fn = lambda plan=plan: lstm_cuda.lstm_infer(xw, mask, wh, h0, c0, plan, False)
        else:
            args = bwd_args(rows, 8, dev)
            fn = lambda plan=plan: lstm_cuda.lstm_bwd_bf16(*args, plan)
        ms = time_with(name, libs[group], fn)  # the last launch's timers stay
        a = prof_clocks(libs[group], nsm, plan.blocks)
        roles = ({"consumer0": 0, "consumer1": 1} | ({"epilogue": 2} if name == "lstm_bwd" else {})
                 if wide else PHASE_ROLES.get(group, {"warp0": 0, "last_warp": 1}))
        print(json.dumps({"phases": "lstm_fwd_infer" if name == "lstm_infer" else name,
                          "kernel": group, "rows": rows, "plan": repr(plan), "timed_ms": ms,
                          "sm_clocks_per_step": {
                              r: dict(zip(names, a[:, i, :len(names)].mean(0).round(1).tolist()))
                              for r, i in roles.items()}}), flush=True)


def f32_phases(nsm: int, dev, lib, names) -> None:
    """The f32 kernels' timed copy: SM clocks a step by phase, the mean over
    blocks, for warp 0 (a consumer: its K slice 0's products) and the
    producer warp, the residual forward and the backward at H 512, 32 and
    640 rows."""
    for rows in (32, 640):
        fwd_in, bwd_in = f32_inputs(rows, 7, dev), f32_bwd_args(rows, 8, dev)
        for kind, fn in (("lstm_fwd_residuals", lambda: lstm_cuda.lstm_seq(*fwd_in, True)),
                         ("lstm_bwd", lambda: lstm_cuda.lstm_bwd(*bwd_in))):
            plan = lstm_cuda.f32_device_plan("bwd" if kind == "lstm_bwd" else "infer", rows,
                                             F32_H, dev)
            ms = time_with("lstm_f32", lib, fn)  # the last launch's timers stay
            a = prof_clocks(lib, nsm, plan.blocks)
            print(json.dumps({"phases": kind, "kernel": "lstm_f32", "rows": rows, "H": F32_H,
                              "plan": repr(plan), "timed_ms": ms, "sm_clocks_per_step": {
                                  r: dict(zip(names, a[:, i, :len(names)].mean(0).round(1)
                                              .tolist()))
                                  for r, i in (("warp0", 0), ("producer", 1))}}), flush=True)


def prof_clocks(lib, nsm: int, blocks: int) -> np.ndarray:
    """The timed copy's clocks of its last launch, [blocks, 4 roles, 8
    phases], a step each."""
    if blocks > nsm:
        raise ValueError(f"a grid of {blocks} blocks: the timers hold {nsm}")
    h = (ctypes.c_longlong * (nsm * 4 * 8))()
    lib.prof_read(h)
    return np.array(h[:], dtype=np.float64).reshape(nsm, 4, 8)[:blocks] / T


def plan_of(group: str, rows: int, nsm: int, save_residuals: bool = False):
    """The plan the kernels of ``group`` run under: the wide, the narrow or
    the mma.sync plan."""
    kind = "bwd" if source_of(group) == "lstm_bwd" else "infer"
    if group.endswith("_wide"):
        return lstm_cuda.wide_plan(kind, rows, H, nsm)
    if group.endswith("_narrow"):
        return lstm_cuda.narrow_plan(kind, rows, H, nsm)
    if kind == "infer":
        return lstm_cuda.mma_infer_plan(rows, H, nsm, save_residuals)
    return lstm_cuda.mma_bwd_plan(rows, H, nsm)


PHASE_ROLES = {"lstm_infer_narrow": {"warp0": 0, "copier": 1},
               "lstm_bwd_narrow": {"warp0": 0, "copier": 1}}

PARTS = ("ablations", "sweep", "pairs", "host", "phases", "f32")

# the f32 kernels' width (the narrowed Yahoo model) and the shapes the f32
# part times against the earlier tree's kernels: (H, rows)
F32_H = 512
F32_TURN_SHAPES = ((512, 32), (512, 20), (512, 640), (128, 32), (50, 32))
F32_TURNS = 6
_OLD_FWD_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 7
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_OLD_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def f32_inputs(rows: int, seed: int, dev, H: int = F32_H):
    return inputs(rows, seed, dev, H, torch.float32)


def f32_bwd_args(rows: int, seed: int, dev, H: int = F32_H):
    return bwd_args(rows, seed, dev, H, torch.float32)


def build_old(old_dir: str) -> Dict[str, ctypes.CDLL]:
    """The earlier tree's ``lstm_fwd.cu`` and ``lstm_bwd.cu`` (with the
    headers beside them), one ``nvcc`` each, both started together."""
    from pathlib import Path

    src, d = Path(old_dir), OUT_DIR / "old"
    d.mkdir(parents=True, exist_ok=True)
    for f in list(src.glob("*.cuh")) + [src / "lstm_fwd.cu", src / "lstm_bwd.cu"]:
        shutil.copy(f, d / f.name)
    procs = {n: subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / f"{n}.so"),
                                  str(d / f"{n}.cu")], stdout=open(d / f"{n}.log", "w"),
                                 stderr=subprocess.STDOUT) for n in ("lstm_fwd", "lstm_bwd")}
    libs = {}
    for n, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"old {n} does not build:\n" + (d / f"{n}.log").read_text()[-3000:])
        libs[n] = ctypes.CDLL(str(d / f"{n}.so"))
    libs["lstm_fwd"].lstm_fwd.argtypes = _OLD_FWD_ARGTYPES
    libs["lstm_bwd"].lstm_bwd_f32.argtypes = _OLD_BWD_ARGTYPES
    return libs


def old_call(libs, kind: str, fwd_in, bwd_in):
    """A call of the earlier tree's f32 kernel of ``kind`` ("infer",
    "resid" or "bwd") on the same inputs, into fresh outputs."""
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "bwd":
        gates, mask, wh, c_prev, dhs, dhT, dcT = bwd_in
        Tn, B, H4 = gates.shape
        da, da_r = torch.empty_like(gates), torch.empty((2, B, H4), device=gates.device)
        dh0, dc0 = torch.empty_like(dhT), torch.empty_like(dcT)
        err = libs["lstm_bwd"].lstm_bwd_f32(
            *(a.data_ptr() for a in (gates, mask, wh, c_prev, dhs, dhT, dcT, da, da_r, dh0, dc0)),
            Tn, B, H4 // 4, stream)
        out = (da, dh0, dc0)
    else:
        xw, mask, wh, h0, c0 = fwd_in
        Tn, B, H4 = xw.shape
        res = kind == "resid"
        hs, hT, cT = (torch.empty((Tn, B, H4 // 4), device=xw.device), torch.empty_like(h0),
                      torch.empty_like(c0))
        cs = torch.empty_like(hs) if res else None
        gates = torch.empty_like(xw) if res else None
        err = libs["lstm_fwd"].lstm_fwd(
            xw.data_ptr(), mask.data_ptr(), wh.data_ptr(), 0, h0.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), cs.data_ptr() if res else None, gates.data_ptr() if res else None,
            hT.data_ptr(), cT.data_ptr(), Tn, B, H4 // 4, int(res), stream)
        out = (hs, cs, gates, hT, cT) if res else (hs, hT, cT)
    if err != 0:
        raise RuntimeError(f"old {kind}: CUDA error {err}")
    return out


def f32(nsm: int, dev, old_dir: str) -> None:
    """The f32 kernels against the earlier tree's (``--old``) in
    ``F32_TURNS`` pairs, in turns (new first in odd pairs), at
    ``F32_TURN_SHAPES``: the two agree (f32 sums in another order), each
    pair's times one call from an idle stream and five back to back, the
    medians, and the new kernels' empty-step floor."""
    old = build_old(old_dir)
    floor = build_variants(["lstm_f32"], kinds=("empty_step",))["lstm_f32"]["empty_step"]
    for H, rows in F32_TURN_SHAPES:
        fwd_in, bwd_in = f32_inputs(rows, rows + H, dev, H), f32_bwd_args(rows, rows + H, dev, H)
        for kind in ("infer", "resid", "bwd"):
            new = ((lambda: lstm_cuda.lstm_bwd(*bwd_in)) if kind == "bwd" else
                   (lambda: lstm_cuda.lstm_seq(*fwd_in, kind == "resid")))
            prev = lambda: old_call(old, kind, fwd_in, bwd_in)
            err = max(float((a - b).abs().max()) for a, b in zip(new(), prev()))
            got = {"single": [], "back_to_back": []}
            for i in range(F32_TURNS):
                order = ("new", "old") if i % 2 == 0 else ("old", "new")
                fns = {"new": new, "old": prev}
                for mode, batch in (("single", 1), ("back_to_back", 5)):
                    t = {k: time_ms(fns[k], reps=5, batch=batch) for k in order}
                    got[mode].append((t["new"], t["old"]))
            line = {"f32": {"infer": "lstm_fwd_infer", "resid": "lstm_fwd_residuals",
                            "bwd": "lstm_bwd"}[kind], "H": H, "rows": rows, "T": T,
                    "plan": repr(lstm_cuda.f32_device_plan("bwd" if kind == "bwd" else "infer",
                                                           rows, H, dev)),
                    "max_abs_diff_vs_old": err, "floor_ms": time_with("lstm_f32", floor, new)}
            for mode, g in got.items():
                n, o = np.array(g).T
                line[mode] = {"pairs_ms": g, "new_median_ms": float(np.median(n)),
                              "old_median_ms": float(np.median(o)),
                              "ratio_median": float(np.median(n / o))}
            print(json.dumps(line), flush=True)


def ablations(nsm: int, dev, groups) -> None:
    libs = build_variants(groups)
    for group in groups:
        if group == "lstm_f32":
            for rows in (32, 640):
                fwd_in, bwd_in = f32_inputs(rows, rows, dev), f32_bwd_args(rows, rows + 1, dev)
                for kind, fn in (
                        ("lstm_fwd_infer", lambda: lstm_cuda.lstm_seq(*fwd_in, False)),
                        ("lstm_fwd_residuals", lambda: lstm_cuda.lstm_seq(*fwd_in, True)),
                        ("lstm_bwd", lambda: lstm_cuda.lstm_bwd(*bwd_in))):
                    plan = lstm_cuda.f32_device_plan("bwd" if kind == "lstm_bwd" else "infer",
                                                     rows, F32_H, dev)
                    print(json.dumps({"kernel": kind, "group": group, "rows": rows, "H": F32_H,
                                      "plan": repr(plan), "ms": run("lstm_f32", libs[group], fn,
                                                                    {})}), flush=True)
            continue
        rows = 640 if group.endswith("_wide") else 32
        if source_of(group) == "lstm_infer":
            xw, mask, wh, h0, c0 = inputs(rows, rows, dev)
            for res in (False, True):
                plan = plan_of(group, rows, nsm, res)
                ms = run("lstm_infer", libs[group],
                         lambda: lstm_cuda.lstm_infer(xw, mask, wh, h0, c0, plan, res), {})
                print(json.dumps({"kernel": "lstm_fwd_residuals" if res else "lstm_fwd_infer",
                                  "group": group, "rows": rows, "plan": repr(plan), "ms": ms}),
                      flush=True)
            continue
        args = bwd_args(rows, 5, dev)
        plan = plan_of(group, rows, nsm)
        alts = {}
        if isinstance(plan, lstm_cuda.MMAPlan):
            for ck in (1, 2, 4):
                alt = dataclasses.replace(plan, k_chunk=ck)
                if ck != plan.k_chunk and alt.smem_bytes <= lstm_cuda.SMEM_MAX:
                    alts[f"k_chunk_{ck}"] = lambda alt=alt: lstm_cuda.lstm_bwd_bf16(*args, alt)
        ms = run("lstm_bwd", libs[group], lambda: lstm_cuda.lstm_bwd_bf16(*args, plan), alts)
        print(json.dumps({"kernel": "lstm_bwd", "group": group, "rows": rows,
                          "plan": repr(plan), "ms": ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parts", nargs="*", help=f"any of {PARTS} (default: all but f32)")
    ap.add_argument("--groups", default=",".join(ABLATIONS),
                    help="kernel groups of the ablations and phases (comma-separated)")
    ap.add_argument("--old", default=None,
                    help="f32: a directory with an earlier tree's lstm_fwd.cu, lstm_bwd.cu and "
                         "headers")
    args = ap.parse_args()
    parts, groups = args.parts or [p for p in PARTS if p != "f32"], args.groups.split(",")
    if any(p not in PARTS for p in parts) or any(g not in ABLATIONS for g in groups):
        ap.error(f"parts are {PARTS}, groups {tuple(ABLATIONS)}")
    if "f32" in parts and not args.old:
        ap.error("f32 needs --old DIR")
    if not torch.cuda.is_available():
        print("lstm_ablation: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    if "ablations" in parts:
        ablations(nsm, dev, groups)
    if "sweep" in parts:
        sweep(nsm, dev)
    if "pairs" in parts:
        pairs(nsm, dev)
    if "host" in parts:
        host(dev)
    if "phases" in parts:
        phases(nsm, dev, groups)
    if "f32" in parts:
        f32(nsm, dev, args.old)
    return 0


if __name__ == "__main__":
    sys.exit(main())
