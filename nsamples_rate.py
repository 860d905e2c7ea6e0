#!/usr/bin/env python3
"""Steady rate of graphed ``--nsamples 40`` training steps on the card.

    python3 nsamples_rate.py [--runs N] [--nsamples S] [--eager]

The Yahoo-config text model (ni 512, nh 1024, nz 32, V 20004; weights from
a seed) on ``chip_smoke.py``'s training corpus (8 batches of 32 sentences,
T 96), trained with the loss of ``--nsamples 40``: two decoder chunks of 20
samples, so the LSTM forward (and its recompute under checkpointing) and
backward run at 640 rows. Each run is ``chip_smoke.py``'s phase-9 run
(``graph_run``, plain mode): a first pass over the 8 batches (the eager
warm-ups and the graph captures), then a timed window of 32 graphed steps
and a profiled window of 8. The timed window is the steady rate that a CLI
epoch's steps/s mixes with its warm-up and capture.

Prints the card's name and power limit, then one JSON line a run: the timed
window's steps/s, the first pass's seconds, the profiled window's device
busy ms a step and idle share, and whether the steps ran as graphs. It
imports ``chip_smoke.py`` and the package from the working directory, so
run from a checkout's root it times that checkout. ``--nsamples 1`` times
the plain training step at B 32, T 96 instead (the LSTM kernels at 32
rows, one decoder pass); ``--eager`` times the same steps launched one by
one (phase 9's eager comparison) instead of graphed. Needs one CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

NSAMPLES = 40


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--nsamples", type=int, default=NSAMPLES)
    ap.add_argument("--eager", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nsamples_rate: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from vae_lagging_encoder_tpu_torch.train.epoch import make_loss_fn

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)
    with tempfile.TemporaryDirectory(dir=Path.cwd()) as td:
        tmp = Path(td)
        cs.write_train_corpus(tmp)
        cfg, pool, make_vae, _ = cs.graph_model("text", tmp, dev)
        model = (cfg, pool, make_vae,
                 lambda vae: make_loss_fn(vae, nsamples=args.nsamples, train=True))
        for i in range(args.runs):
            run, _ = cs.graph_run(model, "plain", not args.eager, dev)
            print(json.dumps({"nsamples": args.nsamples, "run": i, "checkout": str(Path.cwd()),
                              **{k: run[k] for k in (
                                  "graphs", "steps_per_sec", "timed_steps", "first_pass_s",
                                  "device_busy_ms_per_step", "idle_share", "capture_seconds",
                                  "eager_steps", "graph_steps")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
