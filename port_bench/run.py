"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (kernels from ``build/torch_kernels``,
data and weights from the seed, the port's model, warm-up of every shape
the window takes) is ``setup_s``, from the start of this script to the
start of the window. ``--trace 0`` measures the cell's end-to-end metrics
over a window of ``--seconds``; ``--trace 1`` runs a shorter window under
the profiler (the traffic's ``trace_seconds``) and reports the per-layer
metrics that ``port_bench/metrics/`` read from it. Both then compare
what the first steps (training) or a sample of the window's answers (IW)
produced with the plain reference in ``port_bench/reference/`` and print
one JSON line last: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown``), then ``check``, each compared number with
its limit. Exits non-zero, printing no result, without enough CUDA
devices, without the port's package, or when JAX or the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vae_lagging_encoder_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line(dev) -> str:
    import torch

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "nvidia-smi not available"
    return f"card: {torch.cuda.get_device_name(dev)}; nvidia-smi: {out}"


def entry_class(entry: str):
    """The class that drives a traffic's ``entry``; an unknown entry is refused."""
    from .iwnll import IWCell
    from .train import TrainCell

    table = {"train": TrainCell, "iwnll": IWCell}
    if entry not in table:
        raise KeyError(f"traffic entry {entry!r}: not one of {sorted(table)}")
    return table[entry]


def layer_context(cell, c, w, trace, launched):
    """What the per-layer readers read (``port_bench/metrics/``)."""
    from . import tracing

    iw_chunk = c.iw_chunk()
    total, launches = c.counts_of(w, iw_chunk)
    expected = {}
    for name, _ in launches:
        expected[name] = expected.get(name, 0) + 1
    traced = trace.port_calls()
    counted = {k for f in tracing.FAMILY_LAUNCHES.values() for k in f}
    names = set(expected) | set(launched) | {k for k in traced if k in counted}
    got = {k: (expected.get(k, 0), launched.get(k, 0), traced.get(k, 0)) for k in sorted(names)}
    if any(len(set(v)) > 1 for v in got.values()):
        raise RuntimeError(f"launches (expected from the steps, counted by the port, "
                           f"traced): {got}")
    ops = trace.op_seconds()
    family_s = {fam: sum(s for (op, kind), s in ops.items() if kind == "port" and op in members)
                for fam, members in tracing.FAMILY_KERNELS.items()}
    bounds = {fam: sum(b for name, b in launches if name in members)
              for fam, members in tracing.FAMILY_LAUNCHES.items()}
    return SimpleNamespace(
        cell=cell.name, kind=cell.traffic["entry"], wall_s=trace.wall_s,
        busy_s=trace.busy_s(), steps=w.steps, examples=getattr(w, "examples", 0.0),
        model_flops=total, family_s=family_s, bounds=bounds,
        gemm_s=sum(s for (op, kind), s in ops.items() if kind == "gemm"),
        launch_calls=trace.launch_calls())


def run_cell(cell, seed: int, seconds: float, trace: bool, dev, t_start: float = T_START):
    """One run of ``cell``; returns the result's dict."""
    import torch

    from . import compare, tracing

    cuda = dev.type == "cuda"
    if cuda:
        from vae_lagging_encoder_tpu_torch.ops import build

        build.build()
    c = entry_class(cell.traffic["entry"])(cell, seed, dev)
    c.setup()
    setup_s = time.perf_counter() - t_start
    if trace:
        from vae_lagging_encoder_tpu_torch.ops import build

        before = dict(build.LAUNCHES)
        box = []
        tr = tracing.profiled(
            lambda: box.append(c.window(min(seconds, cell.traffic["trace_seconds"]))), dev)
        w = box[0]
        launched = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES
                    if build.LAUNCHES[k] != before[k]}
        ctx = layer_context(cell, c, w, tr, launched)
    else:
        w = c.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        raise SystemExit(3)
    c.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = c.check()
    correct = compare.judge(numbers, cell.limits) and w.failed == 0
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # the cell's end-to-end metrics: setup_s, and its rate, the window's
        # ``rate_of`` quantity (steps or examples) over its wall time
        rate = getattr(w, cell.traffic["rate_of"]) / w.seconds
        metrics = {m["name"]: {"value": setup_s if m["name"] == "setup_s" else rate,
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(w.steps), "failed": int(w.failed),
           "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=ctx.busy_s, window_s=ctx.wall_s)
        ops = tracing.seconds_by_op(tr)
        out["breakdown"] = {
            "device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda x: -x[1])[:10]],
            "idle_gaps": [[k, v] for k, v in tr.idle_gaps()]}
    out["check"] = compare.report(numbers, cell.limits)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from port_bench import manifest
    from port_bench.run import run_cell as run  # the package's copy, not __main__'s

    cell = manifest.load_cell(args.workload, manifest.load_json(manifest.find_manifest(ROOT)),
                              ROOT / "port_bench")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(card_line(dev), file=sys.stderr, flush=True)
    result = run(cell, args.seed, args.seconds, bool(args.trace), dev, T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
