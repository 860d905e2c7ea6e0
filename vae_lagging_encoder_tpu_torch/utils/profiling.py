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
port's kernels under their names in ``ops/build.py::LAUNCHES``
(``lstm_fwd_residuals``, ``lstm_fwd_infer``, ``lstm_bwd``, their f32-wh
kernels' ``*_f32``, ``ce_fwd``, ``ce_fwd_train``, one kernel per launch of
each), the other kernels of a launch under names of their
own (the CE forward's ``ce_pack_wt`` / ``ce_merge``), other kernels under
their symbol without the parameter list; the rollup is by kind (``KINDS``).
A launch whose work is several kernels (``LAUNCH_PARTS``: the CE
backward's ``ce_bwd_d`` pass, ``ce_bwd_dh`` / ``ce_bwd_dw`` products and
``ce_bwd_merge``) has each kernel as an op, and the summary's ``launches``
sums them under the wrapper's name (``ce_bwd``), which the dossier's
header states. Device-busy time is the union of the device intervals;
``chip_smoke.py``'s ``profiled`` exports its window's trace and derives the
idle share from it and the window's wall time. ``render_dossier`` writes
the same text as the JAX package's for the same summary.

A profiler session loses the device events of its first ~25 launches (the
first ~1-4 ms after its first device activity), even after a pause, and
once a window's last one (seen on an NVIDIA H100). So a profiled window
on the card runs between a ``primer`` and a postamble (the same), each
beside a pause of ``PRIMER_PAUSE_S``, which take those losses, and
``window_trace`` cuts them from the exported trace: ``chip_smoke.py``'s
``profiled`` and ``--profile_dir`` (``train/loop.py``) both do.

The recorder: ``span(name, device=False, **attrs)`` and ``count(name,
n=1)`` mark the port's layer boundaries (the step and its fill and
replay, the device reads, the IW chunk, the LSTM's input product and
recurrence, the CE). They record only while a ``torch.profiler`` session
is active in the process (``tracing()``: torch's own flag,
``torch.autograd.profiler._is_profiler_enabled``): off, a span is one
flag check and the shared no-op context ``NO_SPAN``. On, a span enters
torch's C++ profiler annotation of its name (the trace holds it as an
event on the device events' clock) and keeps its name, start and end on
the trace's clock (``time.time_ns``: a trace event's ``ts`` is ``(ns -
baseTimeNanoseconds) / 1e3``), its parent and its attrs; ``device=True``
adds a pair of timing CUDA events on the current stream, except while
that stream captures a graph. ``recorded()`` returns what was recorded
since the last ``take()`` (device times resolved after one synchronize),
``take()`` returns it and clears; at most ``SPAN_CAP`` spans are kept, the
rest counted in ``spans_dropped``. ``write_dossier`` appends two sections
read from them (``span_sections``).
"""
from __future__ import annotations

import collections
import glob
import gzip
import heapq
import json
import math
import os
import re
import time
from contextlib import nullcontext
from typing import Optional

import torch
from torch.autograd import profiler as _torch_profiler

# device event categories of torch's Chrome trace (Kineto), lower-cased
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset",
               "memcpy": "memcpy", "memset": "memset"}
# the port's kernels: symbol pattern -> their name in ops/build.py::LAUNCHES
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
    # the f32-wh kernels, counted apart from the bf16 ones of the same wrappers
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
# the wrappers whose launch runs several kernels -> their ops, the first of
# them once a launch
LAUNCH_PARTS = {"ce_bwd": ("ce_bwd_d", "ce_bwd_dh", "ce_bwd_dw", "ce_bwd_merge")}
# the CUDA API calls (runtime ``cuda*``, low-level ``cu*``) that put work on a
# stream, as the profiler names them (a graph replay is one cudaGraphLaunch)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
               "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync")
PRIMER_LAUNCHES = 64   # small kernels of the primer and of the postamble
PRIMER_PAUSE_S = 0.2   # the pause beside each
# kinds of the rollup, first match wins (after the port's kernels)
KINDS = (("gemm", re.compile(r"gemm|cutlass|xmma|sm90_|wgmma", re.I)),
         ("elementwise", re.compile(r"elementwise", re.I)),
         ("reduce", re.compile(r"reduce|softmax|norm", re.I)),
         ("index", re.compile(r"index|gather|scatter|embedding", re.I)))


def primer(device="cuda") -> None:
    """``PRIMER_LAUNCHES`` small kernels on ``device``, then a synchronize:
    what a profiled window's primer and postamble run (see the module
    docstring); the caller pauses ``PRIMER_PAUSE_S`` beside each."""
    import torch

    x = torch.zeros(1, device=device)
    for _ in range(PRIMER_LAUNCHES):
        x.add_(1.0)
    torch.cuda.synchronize(device)


def window_trace(path: str) -> tuple:
    """Rewrite the Chrome trace at ``path`` (gzipped or not) to the
    profiled window alone: its complete events stamped between the middles
    of the two pauses, the first and the last gap of at least half a pause
    between two host runtime calls. Raises when the trace shows fewer than
    two such gaps. Returns the window's launch calls by name
    (``LAUNCH_APIS``) and those of them that have no device event of their
    correlation id."""
    path = str(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        trace = json.load(fh)
    events = trace["traceEvents"]
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "cuda_runtime")
    pauses = [(b[0] + a[1]) / 2 for a, b in zip(host, host[1:])
              if b[0] - a[1] >= PRIMER_PAUSE_S / 2 * 1e6]
    if len(pauses) < 2:
        raise AssertionError(f"the profiled trace shows {len(pauses)} of the primer's and the "
                             "postamble's pauses, not 2")
    events = [e for e in events
              if e.get("ph") != "X" or pauses[0] <= e["ts"] <= pauses[-1]]
    trace["traceEvents"] = events
    with opener(path, "wt") as fh:
        json.dump(trace, fh)
    xs = [e for e in events if e.get("ph") == "X"]
    traced = {e.get("args", {}).get("correlation") for e in xs
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    launches = [e for e in xs if e.get("cat") == "cuda_runtime" and e["name"] in LAUNCH_APIS]
    calls = {}
    for e in launches:
        calls[e["name"]] = calls.get(e["name"], 0) + 1
    return calls, [e["name"] for e in launches if e["args"].get("correlation") not in traced]


def find_trace(trace_root: str) -> Optional[str]:
    """Newest Chrome trace under ``trace_root`` (recursively), or None."""
    paths = [p for pat in ("*.trace.json", "*.trace.json.gz")
             for p in glob.glob(os.path.join(trace_root, "**", pat), recursive=True)]
    return max(paths, key=lambda p: (os.path.getmtime(p), p)) if paths else None


def _load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        trace = json.load(fh)
    return trace if isinstance(trace, dict) else {"traceEvents": trace}


def _load(path: str) -> list:
    return _load_trace(path)["traceEvents"]


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
    launches = {}
    for wrapper, parts in LAUNCH_PARTS.items():
        us = sum(ops[(op, "port kernel")] for op in parts)
        if counts[(parts[0], "port kernel")]:
            launches[wrapper] = {
                "calls": int(round(counts[(parts[0], "port kernel")] / n_dev)),
                "ms_total": round(us / per_dev, 3),
                "ms_per_step": round(us / per_dev / steps, 4), "ops": list(parts)}
    busy = sum(busy_us(evs) for evs in by_pid.values())
    return {"trace": path, "steps": steps, "devices": n_dev, "graph_launches": graph_launches,
            "device_busy_ms": round(busy / per_dev, 3),
            "ops_total_ms": round(total_us / per_dev, 3),
            "ms_per_step_device": round(total_us / per_dev / steps, 4),
            "categories": categories, "table": table, "launches": launches}


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
                  title: str = "Profiler dossier", spans: Optional[dict] = None
                  ) -> Optional[dict]:
    """Distill, then write the markdown and a sibling ``.json`` of the
    summary; None (and nothing written) without a device timeline. With
    ``spans`` (the recorder's ``take()`` of the traced window) the two
    sections of ``span_sections`` follow the rendered text."""
    summary = distill_trace(trace_root, steps)
    if summary is None:
        return None
    header = []
    if summary["graph_launches"]:
        header.append(f"- {summary['graph_launches']} CUDA-graph replays (cudaGraphLaunch) in "
                      "the window: the kernels inside them are counted below as their own "
                      "device events")
    for wrapper, row in summary["launches"].items():
        header.append(f"- `{wrapper}`: {row['calls']} launches, {row['ms_per_step']:.3f} ms/step "
                      f"over its kernels {', '.join(row['ops'])} (each listed below)")
    header += [""] * bool(header)
    text = render_dossier(summary, title=title, header_lines=tuple(header))
    if spans is not None and spans["spans"]:
        trace = _load_trace(summary["trace"])
        lines, extra = span_sections(spans, trace["traceEvents"],
                                     int(trace.get("baseTimeNanoseconds", 0)))
        text += "\n".join(lines) + "\n"
        summary.update(extra)
    with open(out_path, "w") as fh:
        fh.write(text)
    with open(os.path.splitext(out_path)[0] + ".json", "w") as fh:
        json.dump(summary, fh, indent=1)
    return summary


# ------------------------------------------------------------------ the recorder
SPAN_CAP = 1 << 18       # spans kept until a take(); the rest are counted in spans_dropped
_clock = time.time_ns    # the trace's clock (module docstring)
NO_SPAN = nullcontext()  # the shared context of a span while tracing is off
_spans: list = []        # recorded since the last take()
_open: list = []         # the spans open now, innermost last
_counters = collections.Counter()


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is active in the process."""
    return _torch_profiler._is_profiler_enabled


class _Span:
    """A span being recorded: the context ``span`` returns while on."""

    __slots__ = ("name", "device", "attrs", "start", "end", "parent", "events", "device_ms",
                 "_rf")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.name, self.device, self.attrs = name, device, attrs
        self.end = self.events = self.device_ms = None

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        # torch's C++ annotation: its trace event lies within a few us of
        # the stamps taken right after its enter and its exit
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        self.start = _clock()
        if (self.device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        _open.append(self)
        _spans.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self._rf.__exit__(*exc)
        self.end = _clock()  # after the annotation's own end, as the start is
        self._rf = None
        if _open and _open[-1] is self:
            _open.pop()
        return False


def span(name: str, device: bool = False, **attrs):
    """A context that records the span ``name`` while tracing is on."""
    if not _torch_profiler._is_profiler_enabled:
        return NO_SPAN
    if len(_spans) >= SPAN_CAP:
        _counters["spans_dropped"] += 1
        return NO_SPAN
    return _Span(name, device, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _torch_profiler._is_profiler_enabled:
        _counters[name] += n


def recorded() -> dict:
    """``{"spans": [...], "counters": {...}}`` since the last ``take()``.
    A span: ``name``, ``start_ns``, ``end_ns`` (None while open), ``parent``
    (its index, or None), ``attrs``, ``device_ms`` (the device time between
    its events; None without them)."""
    spans = list(_spans)
    pending = [s for s in spans if s.events is not None and s.end is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    index = {s: i for i, s in enumerate(spans)}
    return {"spans": [{"name": s.name, "start_ns": s.start, "end_ns": s.end,
                       "parent": index.get(s.parent), "attrs": dict(s.attrs),
                       "device_ms": s.device_ms} for s in spans],
            "counters": {"spans_dropped": 0, **_counters}}


def take() -> dict:
    """``recorded()``, then clear."""
    out = recorded()
    _spans.clear()
    _counters.clear()
    return out


def _quantile(xs: list, q: float) -> float:
    """The ``q`` quantile of sorted ``xs``, linear between ranks."""
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def span_sections(state: dict, events: list, base_ns: int) -> tuple:
    """The dossier's span sections from a recorder state and the window's
    trace events (``base_ns``: the trace's ``baseTimeNanoseconds``):

    - idle gaps by span: each gap between device events, put down to the
      innermost span open when it began (the open span that started last)
      and split into starved (the launch call of the kernel that ends the
      gap came after the gap began: the device waited for the host) and
      bubble (that kernel was already queued);
    - the ``replay`` spans' device time by the (mode, shape) of their step.

    Returns (markdown lines, the same as a dict for the summary's json)."""
    spans = [s for s in state["spans"] if s["end_ns"] is not None]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    gaps, end = [], None
    for e in sorted(device_events(events), key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e.get("dur", 0)
        if end is not None and a > end:
            at = launched.get(e.get("args", {}).get("correlation"))
            gaps.append((end, a - end, at is not None and at > end))
        end = b if end is None else max(end, b)
    opened = sorted(((s["start_ns"] - base_ns) / 1e3, (s["end_ns"] - base_ns) / 1e3, s["name"])
                    for s in spans)
    heap, j = [], 0
    idle = collections.defaultdict(lambda: [0.0, 0.0, 0])   # name -> starved, bubble us, gaps
    for t, length, starved in gaps:
        while j < len(opened) and opened[j][0] <= t:
            heapq.heappush(heap, (-opened[j][0], opened[j][1], opened[j][2]))
            j += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        row = idle[heap[0][2] if heap else "(no span)"]
        row[0 if starved else 1] += length
        row[2] += 1
    lines = ["", "## Idle gaps by span", "",
             "Each device gap under the innermost program span open when it began: starved "
             "where the kernel that ends it was launched after it began, bubble where it was "
             "already queued.", "",
             "| span | starved ms | bubble ms | gaps |", "|---|---|---|---|"]
    rows = sorted(idle.items(), key=lambda kv: -(kv[1][0] + kv[1][1]))
    for name, (st, bu, n) in rows:
        lines.append(f"| `{name}` | {st / 1e3:.3f} | {bu / 1e3:.3f} | {n} |")
    lines.append(f"| all | {sum(r[0] for _, r in rows) / 1e3:.3f} "
                 f"| {sum(r[1] for _, r in rows) / 1e3:.3f} | {len(gaps)} |")
    by_key = collections.defaultdict(list)
    for s in spans:
        if s["name"] == "replay" and s["device_ms"] is not None and s["parent"] is not None:
            attrs = state["spans"][s["parent"]]["attrs"]
            by_key[(str(attrs.get("mode")), "x".join(map(str, attrs.get("shape", ()))))].append(
                s["device_ms"])
    lines += ["", "## Step device time by (mode, shape)", "",
              "| mode | shape | median ms | p97.5 ms | replays |", "|---|---|---|---|---|"]
    steps = []
    for (mode, shape), ms in sorted(by_key.items()):
        ms.sort()
        steps.append({"mode": mode, "shape": shape, "median_ms": _quantile(ms, 0.5),
                      "p97_5_ms": _quantile(ms, 0.975), "replays": len(ms)})
        lines.append(f"| {mode} | {shape} | {steps[-1]['median_ms']:.3f} "
                     f"| {steps[-1]['p97_5_ms']:.3f} | {len(ms)} |")
    extra = {"idle_by_span": {name: {"starved_ms": st / 1e3, "bubble_ms": bu / 1e3, "gaps": n}
                              for name, (st, bu, n) in rows},
             "step_device_ms": steps}
    return lines, extra
