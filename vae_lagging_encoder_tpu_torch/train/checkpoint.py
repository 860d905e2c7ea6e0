"""Checkpoints in the JAX package's format, read and written with numpy only.

The port's own reader/writer of ``vae_lagging_encoder_tpu/train/
checkpoint.py``'s current format: a ``.npz`` archive of raw arrays named
``a0, a1, ...`` plus ``__tree__``, a JSON skeleton of the nested
dicts/lists/tuples and plain scalars, loaded with ``allow_pickle=False``.
One checkpoint loads in both packages. Parameters travel as the JAX
package's nested dict of numpy arrays (``utils/jax_params.py`` maps them
to and from a ``state_dict``). The JAX package's legacy pickle and
PyTorch-reference formats are not read here.
"""
from __future__ import annotations

import json
import os
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


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """(params, extra) from a ``.npz`` checkpoint of this format."""
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic != b"PK":
        raise ValueError(f"{path}: not a .npz checkpoint (the legacy pickle and "
                         "PyTorch-reference formats are read by the JAX package only)")
    with np.load(path, allow_pickle=False) as z:
        if "__tree__" not in z.files:
            raise ValueError(f"{path}: .npz archive without a __tree__ skeleton")
        arrays = {k: z[k] for k in z.files if k != "__tree__"}
        skel = json.loads(z["__tree__"].tobytes().decode("utf-8"))
    state = _decode(skel, arrays)
    return state["params"], state.get("extra", {})
