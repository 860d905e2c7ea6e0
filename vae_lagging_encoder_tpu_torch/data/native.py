"""The native text reader: ``csrc/textproc.cpp`` through ``ctypes``.

Counterpart of ``vae_lagging_encoder_tpu/data/native.py``: the corpus's
vocabulary counts (``count_vocab``) and its id-encoding (``encode_corpus``)
in C++, one pass over the buffered file. ``data/text.py::MonoTextData`` and
``data/vocab.py::Vocab.from_file`` read through it by default; the
pure-Python reader there is its plain version (``native=False``) and
computes the same vocabulary and ids.

The library is built with ``g++`` at first use into
``build/torch_native/textproc-<hash>.so`` (the hash covers the source and
the flags, so an edited source is rebuilt; the file is written under a
temporary name and renamed, so processes that build at once do not clash).
A failed build or a failed read raises: there is no silent switch to the
Python reader. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "textproc.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: List[ctypes.CDLL] = []  # the loaded library, once


class _TpVocabCounts(ctypes.Structure):
    # the blob is read by address and length: a word may hold a NUL byte,
    # where a ``c_char_p`` field would cut the blob short
    _fields_ = [("words_blob", ctypes.c_void_p),
                ("words_blob_len", ctypes.c_int64),
                ("counts", ctypes.POINTER(ctypes.c_int64)),
                ("num_words", ctypes.c_int64),
                ("num_sentences", ctypes.c_int64),
                ("num_tokens", ctypes.c_int64)]


class _TpEncoded(ctypes.Structure):
    _fields_ = [("ids", ctypes.POINTER(ctypes.c_int32)),
                ("offsets", ctypes.POINTER(ctypes.c_int64)),
                ("labels", ctypes.POINTER(ctypes.c_int64)),
                ("num_sentences", ctypes.c_int64),
                ("num_ids", ctypes.c_int64)]


def lib_path() -> Path:
    """``build/torch_native/textproc-<hash of source and flags>.so``."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"textproc-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it exists; raise with ``g++``'s output
    when the build fails."""
    path = lib_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the native text reader cannot be built "
                           "(MonoTextData(..., native=False) reads in Python)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run([gxx, *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native text reader build failed (g++ exit {out.returncode}):\n"
                           + (out.stdout + out.stderr)[-4000:])
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed, with its signatures."""
    if not _LIB:
        lib = ctypes.CDLL(str(build()))
        lib.tp_count_vocab.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.POINTER(_TpVocabCounts)]
        lib.tp_count_vocab.restype = ctypes.c_int
        lib.tp_encode_corpus.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                                         ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                         ctypes.POINTER(_TpEncoded)]
        lib.tp_encode_corpus.restype = ctypes.c_int
        lib.tp_free_counts.argtypes = [ctypes.POINTER(_TpVocabCounts)]
        lib.tp_free_counts.restype = None
        lib.tp_free_encoded.argtypes = [ctypes.POINTER(_TpEncoded)]
        lib.tp_free_encoded.restype = None
        _LIB.append(lib)
    return _LIB[0]


def count_vocab(path: str, label_mode: bool) -> Tuple[List[str], np.ndarray]:
    """(words ordered by count descending, then lexicographically; their
    counts) of the corpus file ``path``."""
    lib = library()
    out = _TpVocabCounts()
    status = lib.tp_count_vocab(os.fsencode(path), int(label_mode), ctypes.byref(out))
    try:
        if status:
            raise OSError(f"native reader: tp_count_vocab({path!r}) returned {status}")
        blob = ctypes.string_at(out.words_blob, out.words_blob_len)
        words = blob.decode("utf-8").split("\n")[: out.num_words]
        counts = (np.ctypeslib.as_array(out.counts, (out.num_words,)).copy()
                  if out.num_words else np.zeros(0, np.int64))
        return words, counts
    finally:
        lib.tp_free_counts(ctypes.byref(out))


def encode_corpus(path: str, label_mode: bool, vocab_words: List[str], unk_id: int,
                  first_id: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The corpus as CSR ``(ids, offsets, labels)``: sentence ``i`` is
    ``ids[offsets[i]:offsets[i + 1]]`` (no specials), with ids over
    ``vocab_words`` numbered from ``first_id`` (``unk_id`` elsewhere);
    labels are -1 where a line has none."""
    lib = library()
    blob = ("\n".join(vocab_words) + "\n").encode("utf-8")
    out = _TpEncoded()
    status = lib.tp_encode_corpus(os.fsencode(path), int(label_mode), blob, len(blob),
                                  unk_id, first_id, ctypes.byref(out))
    try:
        if status:
            raise OSError(f"native reader: tp_encode_corpus({path!r}) returned {status}")
        ids = np.ctypeslib.as_array(out.ids, (max(out.num_ids, 1),))[: out.num_ids].copy()
        offs = np.ctypeslib.as_array(out.offsets, (out.num_sentences + 1,)).copy()
        labels = np.ctypeslib.as_array(out.labels,
                                       (max(out.num_sentences, 1),))[: out.num_sentences].copy()
        return ids, offs, labels
    finally:
        lib.tp_free_encoded(ctypes.byref(out))
