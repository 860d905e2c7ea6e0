"""Rank processes for data and tensor parallelism.

The JAX package sees every device from one process and runs its mesh under
``shard_map``; ``torch.distributed`` needs one process per rank. ``run_ranks``
starts them:

- ``world`` processes with the ``spawn`` start method (never ``fork``: the
  caller may hold an initialized CUDA context), each running
  ``fn(device, *args)`` inside an initialized default process group;
- rendezvous through a ``file://`` store in a temporary directory (the
  caller's ``workdir``, else a fresh one), with an explicit timeout for
  every collective;
- rank ``r`` on ``cuda:{r % torch.cuda.device_count()}``, or on the CPU;
- the backend chosen once from that layout (``choose_backend``): ``nccl``
  when every rank has a card of its own, ``gloo`` when ranks share a card
  (two ranks on one H100) or run on the CPU. It is a rule about the
  layout, not a retry: a backend that fails to initialize fails the run;
- the CUDA kernels and the native text reader built in the parent first,
  so that ranks never build at once (``ops/build.py`` has no lock);
- a rank that fails fails the run: the others are terminated and the
  parent raises, ``SystemExit`` with the rank's message when the rank
  exited with one (a refused configuration), ``RuntimeError`` with its
  traceback otherwise; ``timeout`` bounds the whole run, and a rank whose
  parent is gone ends itself;
- a CPU rank computes on one thread (``torch.set_num_threads(1)``), so that
  ranks beside each other, or beside other work, do not thrash the cores.

Ranks are numbered ``r = d * tp + t`` for dp index ``d`` and tp index ``t``
(parallel/dp.py::make_tp_mesh builds the groups). Each rank's return value
and its counters (kernel launches, peak device memory, seconds) come back
to the parent in ``RankOutcome``s, rank 0's first.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a collective may wait for the other ranks before it raises
COLLECTIVE_TIMEOUT = 1800.0


@dataclass
class RankOutcome:
    """What one rank returned, with its counters."""
    rank: int
    device: str
    backend: str
    result: Any
    launches: Dict[str, int]
    max_memory_allocated: int
    seconds: float


def choose_backend(world: int, device) -> Tuple[str, List[str]]:
    """(backend, device of each rank) for ``world`` ranks on ``device``:
    on the CPU ``gloo``; on CUDA rank ``r`` takes ``cuda:{r % n}`` of the
    ``n`` visible cards, with ``nccl`` when ``world <= n`` (a card per
    rank) and ``gloo`` when ranks share a card (NCCL refuses two ranks on
    one card)."""
    from ..ops.build import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", ["cpu"] * world
    if dev.type != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device!r}")
    n = torch.cuda.device_count()
    return ("nccl" if world <= n else "gloo"), [f"cuda:{r % n}" for r in range(world)]


def _rank_main(rank: int, world: int, backend: str, device: str, store: str, workdir: str,
               fn: Callable, args: Sequence) -> None:
    """One rank: join the group, run ``fn(device, *args)``, write the outcome
    (or the failure) to ``workdir/rank<r>.pkl`` for the parent."""
    from ..ops import build

    dev = torch.device(device)
    out_path = Path(workdir) / f"rank{rank}.pkl"
    t0 = time.perf_counter()
    threading.Thread(target=_exit_with_parent, args=(os.getppid(),), daemon=True).start()
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # one thread a rank: ranks that each took every core would thrash
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=store, world_size=world, rank=rank,
                                timeout=timedelta(seconds=COLLECTIVE_TIMEOUT))
        try:
            build.reset_launches()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            result = fn(dev, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            dist.destroy_process_group()
        outcome = RankOutcome(rank, device, backend, result, dict(build.LAUNCHES),
                              torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
                              time.perf_counter() - t0)
    except SystemExit as e:
        _write(out_path, {"exit": e.code})
        raise
    except BaseException:
        _write(out_path, {"error": traceback.format_exc()})
        raise
    _write(out_path, {"ok": outcome})


def _exit_with_parent(parent: int) -> None:
    """End this rank when the process that started it is gone (killed, or
    ended without reaping it), so that no rank outlives its run."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def _write(path: Path, record: Dict) -> None:
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(record, fh)
    os.replace(tmp, path)


def _read(path: Path) -> Optional[Dict]:
    if not path.exists():
        return None
    with open(path, "rb") as fh:  # written by this module's ranks only
        return pickle.load(fh)


def run_ranks(fn: Callable, world: int, device, args: Sequence = (),
              workdir: Optional[str] = None, timeout: Optional[float] = None
              ) -> List[RankOutcome]:
    """Run ``fn(device, *args)`` in ``world`` rank processes (module
    docstring) and return every rank's ``RankOutcome``, rank 0's first.
    ``fn`` and ``args`` cross into the ranks by pickling (``fn`` by its
    import path). ``timeout`` (seconds, default none) bounds the run; past
    it every rank is terminated and ``TimeoutError`` raised."""
    from ..data import native
    from ..ops import build

    backend, devices = choose_backend(world, device)
    if devices[0].startswith("cuda"):
        build.build()
    native.build()
    own_dir = workdir is None
    workdir = tempfile.mkdtemp(prefix="ranks-") if own_dir else workdir
    os.makedirs(workdir, exist_ok=True)
    store = Path(workdir) / "rendezvous"
    for p in [store, *Path(workdir).glob("rank*.pkl")]:
        p.unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world, backend, devices[r], store.resolve().as_uri(),
                               workdir, fn, tuple(args)))
             for r in range(world)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                _stop(procs)
                _raise_failure(workdir, failed, codes)
            if all(c == 0 for c in codes):
                break
            if timeout is not None and time.perf_counter() - t0 > timeout:
                _stop(procs)
                raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
            time.sleep(0.05)
        outcomes = []
        for r in range(world):
            rec = _read(Path(workdir) / f"rank{r}.pkl")
            if rec is None or "ok" not in rec:
                raise RuntimeError(f"rank {r} exited 0 but left no outcome")
            outcomes.append(rec["ok"])
        return outcomes
    finally:
        _stop(procs)
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)


def _stop(procs) -> None:
    """Terminate every rank still running and reap them all."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        if p.pid is not None:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()


def _raise_failure(workdir: str, failed: List[int], codes: List) -> None:
    """Raise for the first rank that failed of its own accord (a rank
    terminated after another failed left no record)."""
    for r in sorted(range(len(codes)), key=lambda r: r not in failed):
        rec = _read(Path(workdir) / f"rank{r}.pkl")
        if rec is None:
            continue
        if "exit" in rec:
            raise SystemExit(rec["exit"])
        if "error" in rec:
            raise RuntimeError(f"rank {r} failed:\n{rec['error']}")
    raise RuntimeError(f"ranks {failed} failed (exit codes {codes}) without a record; "
                       "a rank that dies in native code or is killed leaves none")
