"""Distill a ``torch.profiler`` trace into an op-level dossier.

Counterpart of ``vae_lagging_encoder_tpu/utils/profiling.py``. The input is
the Chrome trace that ``torch.profiler.profile.export_chrome_trace`` writes
(``*.trace.json``, or gzipped ``*.trace.json.gz``) instead of the JAX
profiler's ``plugins/profile/*/*.trace.json.gz``. Device work is its
complete (``"X"``) events of the categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset``, ``dur`` in microseconds; each (pid, tid) pair is one
device stream. Host-only traces (a CPU run) have none, and then
``distill_trace`` returns None.

``distill_trace`` computes each op's SELF time: events on one stream are
walked in time order and an event's duration is credited to its immediate
parent, as the JAX package's walk does for nested XLA ops, so that both
packages read the same nested trace alike (kernels on one CUDA stream do
not nest, so on a torch trace self time equals duration). Ops are the
port's kernels under their wrappers' names (``lstm_fwd_residuals``,
``lstm_fwd_infer``, ``lstm_bwd``, ``ce_fwd``, ``ce_fwd_train``, and the
CE's ``ce_pack_wt`` / ``ce_merge``), other kernels under their symbol
without the parameter list; the rollup is by kind (``KINDS``). Device-busy
time is the union of the device intervals; ``chip_smoke.py``'s ``profiled``
exports its window's trace and derives the idle share from it and the
window's wall time. ``render_dossier`` writes the same text as the JAX
package's for the same summary.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import math
import os
import re
from typing import Optional

# device event categories of torch's Chrome trace (Kineto), lower-cased
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset",
               "memcpy": "memcpy", "memset": "memset"}
# the port's kernels: symbol pattern -> the wrapper's name (ops/build.py::LAUNCHES)
PORT_KERNELS = (
    (re.compile(r"lstm_infer_kernel<.*true>"), "lstm_fwd_residuals"),
    (re.compile(r"lstm_infer_kernel<.*false>"), "lstm_fwd_infer"),
    (re.compile(r"lstm_fwd_kernel"), "lstm_fwd_f32"),
    (re.compile(r"lstm_bwd_(mma|fma)_kernel"), "lstm_bwd"),
    (re.compile(r"ce_(bf16|f32)_kernel<true>"), "ce_fwd_train"),
    (re.compile(r"ce_(bf16|f32)_kernel<false>"), "ce_fwd"),
    (re.compile(r"ce_pack_wt_kernel"), "ce_pack_wt"),
    (re.compile(r"ce_merge_kernel"), "ce_merge"),
)
# kinds of the rollup, first match wins (after the port's kernels)
KINDS = (("gemm", re.compile(r"gemm|cutlass|xmma|sm90_|wgmma", re.I)),
         ("elementwise", re.compile(r"elementwise", re.I)),
         ("reduce", re.compile(r"reduce|softmax|norm", re.I)),
         ("index", re.compile(r"index|gather|scatter|embedding", re.I)))


def find_trace(trace_root: str) -> Optional[str]:
    """Newest Chrome trace under ``trace_root`` (recursively), or None."""
    paths = [p for pat in ("*.trace.json", "*.trace.json.gz")
             for p in glob.glob(os.path.join(trace_root, "**", pat), recursive=True)]
    return max(paths, key=lambda p: (os.path.getmtime(p), p)) if paths else None


def _load(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        trace = json.load(fh)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def op_name(name: str) -> tuple:
    """(op, kind) of a device event's name."""
    for pat, wrapper in PORT_KERNELS:
        if pat.search(name):
            return wrapper, "port kernel"
    base = name[5:] if name.startswith("void ") else name
    base = base.split("(", 1)[0] if "(" in base else base
    for kind, pat in KINDS:
        if pat.search(name):
            return base, kind
    return base, "other"


def device_events(events: list) -> list:
    """The device events: complete events of the device categories."""
    return [e for e in events if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in DEVICE_CATS]


def busy_us(events: list) -> float:
    """The union of the events' [ts, ts + dur) intervals, in microseconds."""
    busy, end = 0.0, -math.inf
    for a, b in sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def distill_trace(trace_root: str, steps: int) -> Optional[dict]:
    """Device self time per op and per kind over the newest trace under
    ``trace_root``; ``steps`` (the steps the traced window ran) scales the
    per-step columns. None when the trace has no device timeline."""
    path = find_trace(trace_root)
    if path is None:
        return None
    events = _load(path)
    dev = device_events(events)
    if not dev:
        return None
    # host calls that replayed a CUDA graph (train/graphs.py): the kernels
    # inside a replay are device events of their own in the trace
    graph_launches = sum(1 for e in events if e.get("name") == "cudaGraphLaunch")
    by_tid = collections.defaultdict(list)
    for e in dev:
        by_tid[(e.get("pid"), e.get("tid"))].append(e)
    by_pid = collections.defaultdict(list)
    for e in dev:
        by_pid[e.get("pid")].append(e)
    n_dev = len(by_pid)

    ops = collections.Counter()      # (op, kind) -> self us
    counts = collections.Counter()
    bytes_acc = collections.Counter()
    cats = collections.Counter()
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))  # parents first
        stack, cells, recorded = [], [], []
        for e in evs:
            ts, dur = e["ts"], e.get("dur", 0)
            while stack and ts >= stack[-1] - 1e-9:
                stack.pop()
                cells.pop()
            if cells:
                cells[-1][0] += dur  # credit to the immediate parent
            cell = [0.0]
            stack.append(ts + dur)
            cells.append(cell)
            kind = DEVICE_CATS[str(e.get("cat", "")).lower()]
            op, k = op_name(e["name"]) if kind == "kernel" else (e["name"], kind)
            recorded.append((op, k, dur, cell, e.get("args", {}).get("bytes", 0)))
        for op, kind, dur, cell, nbytes in recorded:
            self_us = max(dur - cell[0], 0.0)
            key = (op, kind)
            ops[key] += self_us
            counts[key] += 1
            cats[kind] += self_us
            try:
                bytes_acc[key] += int(nbytes)
            except (TypeError, ValueError):
                pass

    total_us = sum(ops.values())
    per_dev = 1e3 * n_dev  # us -> per-device ms
    table = [{
        "op": name, "category": cat,
        "ms_total": round(us / per_dev, 3),
        "ms_per_step": round(us / per_dev / steps, 4),
        "pct_device": round(100.0 * us / max(total_us, 1e-9), 2),
        "calls": int(round(counts[(name, cat)] / n_dev)),
        "gb_accessed": round(bytes_acc[(name, cat)] / 1e9 / n_dev, 3),
    } for (name, cat), us in ops.most_common()]
    categories = [{
        "category": c, "ms_per_step": round(us / per_dev / steps, 4),
        "pct_device": round(100.0 * us / max(total_us, 1e-9), 2),
    } for c, us in cats.most_common()]
    busy = sum(busy_us(evs) for evs in by_pid.values())
    return {"trace": path, "steps": steps, "devices": n_dev, "graph_launches": graph_launches,
            "device_busy_ms": round(busy / per_dev, 3),
            "ops_total_ms": round(total_us / per_dev, 3),
            "ms_per_step_device": round(total_us / per_dev / steps, 4),
            "categories": categories, "table": table}


def render_dossier(summary: dict, title: str = "Profiler dossier",
                   header_lines: tuple = (), top: int = 15) -> str:
    """Markdown dossier from a ``distill_trace`` summary (the JAX
    package's text, line for line)."""
    steps = max(summary.get("steps", 1), 1)
    lines = [f"# {title}", ""]
    lines += list(header_lines)
    if summary.get("devices", 1) > 1:
        lines.append(f"- per-device mean over {summary['devices']} device "
                     f"timelines (SPMD)")
    lines += [
        f"- device-busy (XLA Modules): {summary['device_busy_ms']:.1f} ms "
        f"→ {summary['device_busy_ms'] / steps:.2f} ms/step "
        f"over {steps} steps",
        f"- sum of XLA Ops self time: {summary['ops_total_ms']:.1f} ms "
        f"({summary['ms_per_step_device']:.2f} ms/step)",
        "", "## By HLO category (self time)", "",
        "| category | ms/step | % of device |", "|---|---|---|"]
    for row in summary["categories"]:
        lines.append(f"| {row['category']} | {row['ms_per_step']:.3f} "
                     f"| {row['pct_device']:.1f}% |")
    lines += ["", "## Top ops (self time)", "",
              "| op | category | ms/step | % of device | calls | GB moved |",
              "|---|---|---|---|---|---|"]
    for row in summary["table"][:top]:
        lines.append(f"| `{row['op'][:48]}` | {row['category']} "
                     f"| {row['ms_per_step']:.3f} | {row['pct_device']:.1f}% "
                     f"| {row['calls']} | {row['gb_accessed']:.2f} |")
    return "\n".join(lines) + "\n"


def write_dossier(trace_root: str, steps: int, out_path: str,
                  title: str = "Profiler dossier") -> Optional[dict]:
    """Distill, then write the markdown and a sibling ``.json`` of the
    summary; None (and nothing written) without a device timeline."""
    summary = distill_trace(trace_root, steps)
    if summary is None:
        return None
    header = ()
    if summary["graph_launches"]:
        header = (f"- {summary['graph_launches']} CUDA-graph replays (cudaGraphLaunch) in the "
                  "window: the kernels inside them are counted below as their own device "
                  "events", "")
    with open(out_path, "w") as fh:
        fh.write(render_dossier(summary, title=title, header_lines=header))
    with open(os.path.splitext(out_path)[0] + ".json", "w") as fh:
        json.dump(summary, fh, indent=1)
    return summary
