"""Experiment bookkeeping: run directories + stdout tee logging.

The port's own copy of ``vae_lagging_encoder_tpu/utils/exp_utils.py``:
``models/<dataset>/exp_.../`` run directories with a snapshot of the launch
script, a tee'd text log and a JSONL metric stream.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Iterable, Optional


def create_exp_dir(path: str, scripts_to_save: Optional[Iterable[str]] = None) -> str:
    """Create an experiment directory (and ``scripts/`` snapshot inside it)."""
    os.makedirs(path, exist_ok=True)
    if scripts_to_save:
        script_dir = os.path.join(path, "scripts")
        os.makedirs(script_dir, exist_ok=True)
        for script in scripts_to_save:
            if os.path.isfile(script):
                dst = os.path.basename(script) + ".snapshot"
                shutil.copyfile(script, os.path.join(script_dir, dst))
    return path


class Logger:
    """Tee stdout-style logging to a file, plus a JSONL metric stream."""

    def __init__(self, log_path: Optional[str] = None, quiet: bool = False):
        self.log_path = log_path
        self.quiet = quiet
        self._fh = open(log_path, "a") if log_path else None
        self._metrics_fh = (
            open(os.path.splitext(log_path)[0] + ".metrics.jsonl", "a") if log_path else None
        )

    def info(self, msg: str) -> None:
        if not self.quiet:
            print(msg, flush=True)
        if self._fh:
            self._fh.write(msg + "\n")
            self._fh.flush()

    def metric(self, **kv) -> None:
        """Append one structured metric record."""
        kv.setdefault("ts", time.time())
        if self._metrics_fh:
            self._metrics_fh.write(json.dumps(kv, default=float) + "\n")
            self._metrics_fh.flush()

    def close(self) -> None:
        for fh in (self._fh, self._metrics_fh):
            if fh:
                fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
