"""The device trace of a window, and what the metrics read from it.

A frozen copy of the port's ``utils/profiling.py`` arithmetic (the kernel
name map ``PORT_KERNELS`` and ``LAUNCH_PARTS``, the kinds, the launch API
list, the busy union, the primer and the postamble that take a session's
lost events and are cut from the trace), so that a later change to the
program cannot move the yardstick. ``profiled(fn)`` runs ``fn`` under
``torch.profiler`` (device activity and the CUDA runtime calls) between
the primer and the postamble, cuts the trace to the window and returns a
``Trace``: the device events, the runtime calls, the window's wall time.
"""
from __future__ import annotations

import gzip
import json
import math
import re
import tempfile
import time
from collections import Counter, defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset",
               "memcpy": "memcpy", "memset": "memset"}
PORT_KERNELS = (
    (re.compile(r"lstm_infer_wide_kernel<true>"), "lstm_fwd_residuals"),
    (re.compile(r"lstm_infer_wide_kernel<false>"), "lstm_fwd_infer"),
    (re.compile(r"lstm_bwd_wide_kernel"), "lstm_bwd"),
    (re.compile(r"lstm_infer_narrow_kernel<.*true>"), "lstm_fwd_residuals"),
    (re.compile(r"lstm_infer_narrow_kernel<.*false>"), "lstm_fwd_infer"),
    (re.compile(r"lstm_bwd_narrow_kernel"), "lstm_bwd"),
    (re.compile(r"lstm_infer_kernel<.*true>"), "lstm_fwd_residuals"),
    (re.compile(r"lstm_infer_kernel<.*false>"), "lstm_fwd_infer"),
    (re.compile(r"lstm_bwd_mma_kernel"), "lstm_bwd"),
    (re.compile(r"lstm_fwd_f32_kernel<.*true>"), "lstm_fwd_residuals_f32"),
    (re.compile(r"lstm_fwd_f32_kernel<.*false>"), "lstm_fwd_infer_f32"),
    (re.compile(r"lstm_bwd_f32_kernel"), "lstm_bwd_f32"),
    (re.compile(r"ce_(bf16|f32)_kernel<true>"), "ce_fwd_train"),
    (re.compile(r"ce_(bf16|f32)_kernel<false>"), "ce_fwd"),
    (re.compile(r"ce_pack_wt_kernel"), "ce_pack_wt"),
    (re.compile(r"ce_(f32_)?merge_kernel"), "ce_merge"),
    (re.compile(r"ce_bwd_d_kernel"), "ce_bwd_d"),
    (re.compile(r"ce_bwd_gemm_kernel<false>"), "ce_bwd_dh"),
    (re.compile(r"ce_bwd_gemm_kernel<true>"), "ce_bwd_dw"),
    (re.compile(r"ce_bwd_merge_kernel"), "ce_bwd_merge"),
)
# a launch of several kernels: the first of them once a launch
LAUNCH_PARTS = {"ce_bwd": ("ce_bwd_d", "ce_bwd_dh", "ce_bwd_dw", "ce_bwd_merge")}
# the kernel families the rooflines read: their launches (``ops/build.py::
# LAUNCHES`` names, whose bounds count) and the kernels those run (whose
# device time counts)
FAMILY_LAUNCHES = {
    "lstm": ("lstm_fwd_residuals", "lstm_fwd_infer", "lstm_bwd", "lstm_fwd_residuals_f32",
             "lstm_fwd_infer_f32", "lstm_bwd_f32"),
    "ce": ("ce_fwd", "ce_fwd_train", "ce_bwd"),
}
FAMILY_KERNELS = {
    "lstm": FAMILY_LAUNCHES["lstm"],
    "ce": ("ce_fwd", "ce_fwd_train", "ce_pack_wt", "ce_merge") + LAUNCH_PARTS["ce_bwd"],
}
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
               "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync")
# library products and convolutions (cuBLAS, CUTLASS, cuDNN), after the port's kernels
GEMM = re.compile(r"gemm|cutlass|xmma|sm90_|wgmma|conv|cudnn|dgrad|wgrad|fprop", re.I)
PRIMER_LAUNCHES = 64
PRIMER_PAUSE_S = 0.2


def op_name(name: str) -> Tuple[str, str]:
    """(op, kind) of a kernel: the port's under its launch name, the
    library's products and convolutions as ``gemm``, the rest ``other``."""
    for pat, op in PORT_KERNELS:
        if pat.search(name):
            return op, "port"
    base = name[5:] if name.startswith("void ") else name
    base = base.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return base, "gemm" if GEMM.search(name) else "other"


def busy_us(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of [a, b) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def primer(device) -> None:
    import torch

    x = torch.zeros(1, device=device)
    for _ in range(PRIMER_LAUNCHES):
        x.add_(1.0)
    torch.cuda.synchronize(device)


@dataclass
class Trace:
    wall_s: float
    device: List[dict]      # the window's device events (kernels, copies, sets)
    runtime: List[dict]     # the window's CUDA runtime calls

    def busy_s(self) -> float:
        return busy_us([(e["ts"], e["ts"] + e.get("dur", 0)) for e in self.device]) * 1e-6

    def op_seconds(self) -> Dict[Tuple[str, str], float]:
        """Device seconds per (op, kind); copies and sets as ``<kind>
        <name>``, a kernel the trace leaves unnamed as ``kernel (no name)``."""
        out = Counter()
        for e in self.device:
            cat = DEVICE_CATS[str(e.get("cat", "")).lower()]
            if cat != "kernel":
                key = (f"{cat} {e['name']}".strip(), cat)
            elif e["name"]:
                key = op_name(e["name"])
            else:
                key = ("kernel (no name)", "other")
            out[key] += e.get("dur", 0) * 1e-6
        return dict(out)

    def port_calls(self) -> Dict[str, int]:
        """Launches of the port's kernels by launch name (a multi-kernel
        launch counted by its first kernel)."""
        n = Counter(op_name(e["name"])[0] for e in self.device
                    if DEVICE_CATS[str(e.get("cat", "")).lower()] == "kernel"
                    and op_name(e["name"])[1] == "port")
        for launch, parts in LAUNCH_PARTS.items():
            if parts[0] in n:
                n[launch] = n[parts[0]]
        return dict(n)

    def launch_calls(self) -> int:
        return sum(1 for e in self.runtime if e["name"] in LAUNCH_APIS)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """The device's idle time between its events, by the runtime call
        the host was in when each gap began ("host" outside any)."""
        ivs = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in self.device)
        calls = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in self.runtime)
        gaps, end = Counter(), None
        j = 0
        for a, b in ivs:
            if end is not None and a > end:
                while j < len(calls) and calls[j][1] < end:
                    j += 1
                name = calls[j][2] if j < len(calls) and calls[j][0] <= end else "host"
                gaps[name] += (a - end) * 1e-6
            end = b if end is None else max(end, b)
        return gaps.most_common(10)


def profiled(fn: Callable[[], None], device) -> Trace:
    """``fn()`` under the profiler between the primer and the postamble,
    the trace cut to the window (between the middles of the two pauses)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        primer(device)
        time.sleep(PRIMER_PAUSE_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        time.sleep(PRIMER_PAUSE_S)
        primer(device)
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "window.trace.json.gz"
        prof.export_chrome_trace(str(path))
        with gzip.open(path, "rt") as fh:
            events = json.load(fh)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in xs
                  if e.get("cat") == "cuda_runtime")
    pauses = [(b[0] + a[1]) / 2 for a, b in zip(host, host[1:])
              if b[0] - a[1] >= PRIMER_PAUSE_S / 2 * 1e6]
    if len(pauses) < 2:
        raise RuntimeError(f"the trace shows {len(pauses)} of the primer's and the "
                           "postamble's pauses, not 2")
    inside = [e for e in xs if pauses[0] <= e["ts"] <= pauses[-1]]
    device = [e for e in inside if str(e.get("cat", "")).lower() in DEVICE_CATS]
    runtime = [e for e in inside if e.get("cat") == "cuda_runtime"]
    traced = {e.get("args", {}).get("correlation") for e in device}
    lost = [e["name"] for e in runtime if e["name"] in LAUNCH_APIS
            and e.get("args", {}).get("correlation") not in traced]
    if lost:
        raise RuntimeError(f"{len(lost)} launch calls of the window have no device events in "
                           f"its trace: {lost[:8]}")
    return Trace(wall_s=wall, device=device, runtime=runtime)


def seconds_by_op(trace: Trace) -> Dict[str, float]:
    """Device seconds per op name (kinds merged), for the breakdown."""
    out = defaultdict(float)
    for (op, _), s in trace.op_seconds().items():
        out[op] += s
    return dict(out)
