#!/usr/bin/env python3
"""Ablations of the PyTorch port's tensor-core LSTM kernels, timed on the card.

    python3 lstm_ablation.py

Builds copies of ``csrc/lstm_infer.cu`` and ``csrc/lstm_bwd.cu`` with one
part of the per-step work removed (the tensor-core products, the cp.async
copies of the operand ring, the shared-memory reads of the A or B
fragments, the whole k-loop, the cell epilogue, the backward's L2
prefetch), and times each beside the intact kernel through the port's own
wrappers (``ops/lstm_cuda.py::lstm_infer`` and ``lstm_bwd``), with the
variant's library in place of the built one. Shapes: the forward at T 96,
H 1024 with 640 rows (the IW decoder) and 32 rows (the encoder), and with
its residuals at 32 rows (the training forward, ``lstm_fwd_residuals``);
the backward at B 32. The time an ablation saves is what that part costs when
the rest runs. The backward's other k-chunks are timed the same way. The
ablated kernels compute wrong values; only their times are read.

Prints the card and its power limit, then one JSON line per shape: median
CUDA-event milliseconds of each variant, the intact kernel timed first and
last. Needs one CUDA GPU and ``nvcc``; builds into ``build/lstm_ablation``.
Each ablation is a text substitution in the source: when the source
changes, a substitution that no longer applies raises. A development tool:
nothing in the package or its tests imports it.
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
ABLATIONS = {
    "lstm_infer": {
        "no_mma": ("if (live[m]) mma_bf16(acc[m][nt], af[m], bf);",
                   "if (live[m]) acc[m][nt][0] += __uint_as_float(af[m].x ^ bf.x);"),
        "no_copy": ("cp_async16(d + (kk * MG + m) * 32,",
                    "if (0) cp_async16(d + (kk * MG + m) * 32,"),
        "no_a_lds": ("af[m] = live[m] ? a[(kk * MG + m) * 32] : make_uint4(0, 0, 0, 0);",
                     "af[m] = make_uint4(lane, ks, m, kk);"),
        "no_b_lds": ("const uint2 bf = b[nt * 32];", "const uint2 bf = make_uint2(lane + nt, ks);"),
        "no_k_loop": ("const int n_items = cdiv(ks1 - ks0, CK);",
                      "const int n_items = 0 * cdiv(ks1 - ks0, CK);"),
        "no_epilogue": ("if (wk != 0) continue;", "if (wk != 0 || t >= 0) continue;"),
    },
    "lstm_bwd": {
        "no_mma": ("mma_bf16(acc[m][nt], af, b[nt * 32]);",
                   "acc[m][nt][0] += __uint_as_float(af.x ^ b[nt * 32].x);"),
        "no_copy": ("cp_async16(d + (kk * MG + m) * 32, src",
                    "if (0) cp_async16(d + (kk * MG + m) * 32, src"),
        "no_k_loop": ("const int n_items = cdiv(ks1 - ks0, CK);",
                      "const int n_items = 0 * cdiv(ks1 - ks0, CK);"),
        "no_prefetch": ("if (t > 0) prefetch_cell(t - 1);", ""),
    },
}
OUT_DIR = build.BUILD_DIR.parent / "lstm_ablation"


def build_variants(name: str) -> Dict[str, ctypes.CDLL]:
    """The intact source and each ablation, one ``nvcc`` each, in parallel."""
    src = (build.CSRC_DIR / f"{name}.cu").read_text()
    d = OUT_DIR / name
    d.mkdir(parents=True, exist_ok=True)
    for hdr in build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(hdr, d / hdr.name)
    texts = {"intact": src}
    for k, (old, new) in ABLATIONS[name].items():
        if old not in src:
            raise RuntimeError(f"{name}: ablation {k} no longer applies to the source")
        texts[k] = src.replace(old, new)
    procs = {}
    for k, text in texts.items():
        (d / f"{k}.cu").write_text(text)
        procs[k] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / f"{k}.so"),
                                     str(d / f"{k}.cu")], stdout=subprocess.DEVNULL,
                                    stderr=subprocess.STDOUT)
    libs = {}
    for k, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{name}: variant {k} does not build")
        libs[k] = ctypes.CDLL(str(d / f"{k}.so"))
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


def bwd_with_plan(plan: lstm_cuda.MMAPlan, args) -> Callable[[], object]:
    """``lstm_bwd(*args)`` launched with ``plan`` instead of ``bwd_plan``'s."""
    def call():
        saved = lstm_cuda.bwd_plan
        lstm_cuda.bwd_plan = lambda B, H, nsm: plan
        try:
            return lstm_cuda.lstm_bwd(*args)
        finally:
            lstm_cuda.bwd_plan = saved
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_ablation: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    ilibs, blibs = build_variants("lstm_infer"), build_variants("lstm_bwd")
    for rows, res in ((640, False), (32, False), (32, True)):
        plan = lstm_cuda.infer_plan(rows, H, nsm, res)
        xw, mask, wh, h0, c0 = inputs(rows, rows, dev)
        ms = run("lstm_infer", ilibs,
                 lambda: lstm_cuda.lstm_infer(xw, mask, wh, h0, c0, plan, res), {})
        print(json.dumps({"kernel": "lstm_fwd_residuals" if res else "lstm_fwd_infer",
                          "rows": rows, "plan": repr(plan), "ms": ms}), flush=True)
    xw, mask, wh, h0, c0 = inputs(32, 5, dev)
    _, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
    g = torch.Generator().manual_seed(6)
    dhs = (0.1 * torch.randn(T, 32, H, generator=g)).to(dev)
    dhT, dcT = (0.1 * torch.randn(2, 32, H, generator=g)).to(dev)
    args = (gates, mask, wh, torch.cat([c0[None], cs[:-1]]), dhs, dhT.contiguous(),
            dcT.contiguous())
    plan = lstm_cuda.bwd_plan(32, H, nsm)
    alts = {}
    for ck in (1, 2, 4):
        alt = dataclasses.replace(plan, k_chunk=ck)
        if ck != plan.k_chunk and alt.smem_bytes <= lstm_cuda.SMEM_MAX:
            alts[f"k_chunk_{ck}"] = bwd_with_plan(alt, args)
    ms = run("lstm_bwd", blibs, lambda: lstm_cuda.lstm_bwd(*args), alts)
    print(json.dumps({"kernel": "lstm_bwd", "rows": 32, "plan": repr(plan), "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
