"""Build and load the hand-written CUDA kernels; device checks; launch counts.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into its own
shared library with a plain C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. ``nvcc``'s output
(``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library as ``<name>-<hash>.log``, followed by a census of each kernel's
tensor-core instructions (``HMMA``: ``mma.sync``; ``HGMMA``: ``wgmma``) and
asynchronous copies (``LDGSTS``: ``cp.async``; ``UTMALDG``: TMA tile loads;
``UBLKCP``: bulk copies) from ``cuobjdump -sass``; ``kernel_report`` reads
both back. Nothing here runs at import time.

This module is the port's counterpart of ``ops/vmem.py::pallas_available``
in the JAX package: where that probe decided whether the Pallas kernels
could run, here a CUDA tensor always goes to its kernel, and a build
failure raises instead of falling back.

Every kernel wrapper adds one to its entry of ``LAUNCHES`` where it
launches the kernel, and nowhere else. A kernel captured into a CUDA graph
is counted at each replay of the graph instead (train/graphs.py), so
``LAUNCHES`` counts the kernels that ran either way; ``GRAPHS`` counts the
captures and the replays of the training step's graphs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
SOURCES = ("lstm_fwd", "lstm_infer", "lstm_bwd", "ce_fwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel, counted by the wrappers in lstm_cuda.py / ce_cuda.py
LAUNCHES: Dict[str, int] = {"lstm_fwd_residuals": 0, "lstm_fwd_infer": 0,
                            "lstm_bwd": 0, "ce_fwd": 0, "ce_fwd_train": 0}

# CUDA graphs of the training step: captured, and replays (train/graphs.py)
GRAPHS: Dict[str, int] = {"captured": 0, "replays": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and ``GRAPHS``."""
    for counts in (LAUNCHES, GRAPHS):
        for k in counts:
            counts[k] = 0


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; CUDA without a usable card raises
    (the port never picks the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run the plain "
            "PyTorch versions on the CPU")
    return dev


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every missing library among ``names``, one ``nvcc`` per
    source, all started together. Returns the wall seconds spent; raises
    with the compiler's output when a build fails."""
    t0 = time.perf_counter()
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, path in todo:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        procs.append((name, path, tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, path, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + path.with_suffix(".log").read_text()[-4000:])
        else:
            with open(path.with_suffix(".log"), "a") as f:
                f.write(_sass_census(tmp, nvcc))
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


SASS_COUNTED = ("HMMA", "HGMMA", "LDGSTS", "UTMALDG", "UBLKCP")
TENSOR_CORE_SASS = ("HMMA", "HGMMA")
ASYNC_COPY_SASS = ("LDGSTS", "UTMALDG", "UBLKCP")


def _sass_census(lib: Path, nvcc: str) -> str:
    """``sass <function> HMMA <n> HGMMA <n> ...`` lines (``SASS_COUNTED``)
    for each kernel in ``lib``, from ``cuobjdump -sass`` beside ``nvcc``."""
    tool = Path(nvcc).parent / "cuobjdump"
    if not tool.is_file():
        return "sass census: cuobjdump not found\n"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    lines, fn, counts = [], None, {}

    def flush():
        if fn:
            lines.append(f"sass {fn} " + " ".join(f"{k} {counts[k]}" for k in SASS_COUNTED))

    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            flush()
            fn, counts = m.group(1), dict.fromkeys(SASS_COUNTED, 0)
        elif fn:
            for k in SASS_COUNTED:
                counts[k] += bool(re.search(rf"\b{k}\b", line))
    flush()
    return "".join(l + "\n" for l in lines)


def kernel_report(name: str) -> List[Dict]:
    """Per kernel of ``csrc/<name>.cu`` (built): registers, stack and spill
    bytes from ``-Xptxas -v``, and the SASS census, read from the build
    log. Kernels are named by their mangled symbol."""
    text = _lib_path(name).with_suffix(".log").read_text()
    info: Dict[str, Dict] = {}
    fn = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            info[fn] = {"function": fn}
        elif fn and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)):
            info[fn].update(stack_bytes=int(m.group(1)), spill_bytes=int(m.group(2)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            info[fn]["registers"] = int(m.group(1))
        elif m := re.match(r"sass (\S+) (.*)", line):
            vals = m.group(2).split()
            info.setdefault(m.group(1), {"function": m.group(1)}).update(
                {k.lower(): int(v) for k, v in zip(vals[::2], vals[1::2])})
    return list(info.values())


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` after the launch, or an earlier refusal)."""
    if err != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
