"""Readings that the limits of ``workloads/<cell>.json`` are set from.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,.. [--control 1,2,3]
        [--seconds S] [--init leaf=scale,..]

In one process, for each seed: the cell's set-up as far as the check
needs it (training: its first call; IW: a window of ``--seconds``), then
the compared numbers of the program against the reference; for the
``--control`` seeds also the control's (the reference one precision step
below the configuration in the program's place) and those of the cell's
faults planted in the reference put in the program's place (training:
half of a batch left out, the mean taken over the rest). One JSON line per
reading, then the largest program reading and the smallest control and
fault readings of each number. ``--init`` overrides the weights' init
scales (by leaf name) for a trial.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--init", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import manifest
    from port_bench.run import entry_class
    from vae_lagging_encoder_tpu_torch.ops import build

    cell = manifest.load_cell(args.workload, manifest.load_json(manifest.find_manifest(ROOT)),
                              ROOT / "port_bench")
    if args.init:
        cell.traffic = dict(cell.traffic, init={k: float(v) for k, v in
                                                (kv.split("=") for kv in args.init.split(","))})
    dev = torch.device("cuda:0")
    build.build()
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control.split(",") if s}
    worst, least = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        c = entry_class(cell.traffic["entry"])(cell, seed, dev)
        c.calibration_run(args.seconds)
        c.free()
        gc.collect()
        torch.cuda.empty_cache()
        readings = {"program": c.check()}
        if seed in control:
            readings["control"] = c.control()
            readings.update(c.faults())
        for kind, nums in readings.items():
            print(json.dumps({"seed": seed, "kind": kind, **nums}), flush=True)
            for k, v in nums.items():
                if kind == "program":
                    worst[k] = max(worst.get(k, 0.0), v)
                else:
                    least.setdefault(kind, {})[k] = min(least.get(kind, {}).get(k, float("inf")), v)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s, "
              f"{len(getattr(c, 'steps_ref', ()))} training steps compared", file=sys.stderr,
              flush=True)
        del c
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": worst, "least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
