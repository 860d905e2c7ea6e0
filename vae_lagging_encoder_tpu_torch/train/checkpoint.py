"""Checkpoints in the JAX package's formats.

The port's own reader/writer of ``vae_lagging_encoder_tpu/train/
checkpoint.py``: the current format is a ``.npz`` archive of raw arrays
named ``a0, a1, ...`` plus ``__tree__``, a JSON skeleton of the nested
dicts/lists/tuples and plain scalars, loaded with ``allow_pickle=False``;
one checkpoint loads in both packages. ``load_checkpoint`` also reads the
formats a user may arrive with: the JAX package's legacy round-1 pickle,
through an unpickler that admits numpy array reconstruction only, and the
reference's ``torch.save(vae.state_dict())`` (a zip with a ``data.pkl``
member, or the legacy torch format), converted by utils/torch_import.py.
Parameters travel as the JAX package's nested dict of numpy arrays
(``utils/jax_params.py`` maps them to and from a ``state_dict``).
"""
from __future__ import annotations

import json
import os
import pickle
import zipfile
from typing import Any, Dict, Tuple

import numpy as np


def _encode(node, arrays: Dict[str, np.ndarray]):
    if isinstance(node, dict):
        return {"t": "d", "v": {str(k): _encode(v, arrays) for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"t": "l" if isinstance(node, list) else "u",
                "v": [_encode(v, arrays) for v in node]}
    if hasattr(node, "shape") and hasattr(node, "dtype"):
        name = f"a{len(arrays)}"
        arrays[name] = np.asarray(node)
        return {"t": "a", "v": name}
    if isinstance(node, (np.floating, np.integer, np.bool_)):
        node = node.item()
    return {"t": "v", "v": node}  # str / int / float / bool / None


def _decode(skel, arrays):
    t, v = skel["t"], skel["v"]
    if t == "d":
        return {k: _decode(s, arrays) for k, s in v.items()}
    if t == "l":
        return [_decode(s, arrays) for s in v]
    if t == "u":
        return tuple(_decode(s, arrays) for s in v)
    if t == "a":
        return arrays[v]
    return v


def save_checkpoint(path: str, params, extra: Dict[str, Any] | None = None) -> None:
    """Write ``{"params": params, "extra": extra}``; atomic (temp file + rename)."""
    arrays: Dict[str, np.ndarray] = {}
    skel = _encode({"params": params, "extra": extra or {}}, arrays)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, __tree__=np.frombuffer(json.dumps(skel).encode("utf-8"),
                                            dtype=np.uint8), **arrays)
    os.replace(tmp, path)


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Legacy-pickle reader: admits numpy array and scalar reconstruction
    only (no other class or callable, so loading executes no code)."""

    _OK = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" and (name in self._OK or module == "numpy.dtypes"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint requested forbidden global {module}.{name}")


class CheckpointFormatError(pickle.UnpicklingError, ValueError):
    """A file that is no checkpoint of any readable format."""


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """(params, extra) from a checkpoint in any of the formats of the module
    docstring. A file that is no zip and that both safe readers refuse (the
    legacy pickle's and torch's ``weights_only`` one) raises
    ``CheckpointFormatError`` naming both refusals."""
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"PK":  # zip: the .npz format or a torch archive
        with zipfile.ZipFile(path) as zf:
            is_torch = any(n.endswith("data.pkl") for n in zf.namelist())
        if is_torch:
            from ..utils.torch_import import load_torch_checkpoint
            return load_torch_checkpoint(path)
        with np.load(path, allow_pickle=False) as z:
            if "__tree__" not in z.files:
                raise ValueError(f"{path}: .npz archive without a __tree__ skeleton")
            arrays = {k: z[k] for k in z.files if k != "__tree__"}
            skel = json.loads(z["__tree__"].tobytes().decode("utf-8"))
        state = _decode(skel, arrays)
        return state["params"], state.get("extra", {})
    # the legacy round-1 pickle, or a legacy (pre-zip) torch save
    try:
        with open(path, "rb") as fh:
            state = _NumpyOnlyUnpickler(fh).load()
        if not (isinstance(state, dict) and "params" in state):
            # a legacy torch save's first pickle is its magic number
            raise pickle.UnpicklingError("not a checkpoint of this format")
    except pickle.UnpicklingError as our_err:
        from ..utils.torch_import import load_torch_checkpoint
        try:
            return load_torch_checkpoint(path)
        except Exception as torch_err:
            raise CheckpointFormatError(
                f"{path}: not a loadable checkpoint (no .npz archive) — legacy-pickle "
                f"reader: {our_err}; "
                f"torch weights_only reader: {type(torch_err).__name__}: "
                f"{torch_err}") from None
    return state["params"], state.get("extra", {})
