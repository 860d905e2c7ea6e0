"""Map the JAX package's parameter pytree to this package's state dict.

The port keeps the JAX layouts at its public functions (``wx [ni, 4H]``,
``wh [H, 4H]``, ``pred [nh, V]``, ``emb [V, ni]``), so the mapping is a
renaming: nested dict keys ``{"enc": {"lstm": {"wx": ...}}}`` become
``"enc.lstm.wx"``. A legacy merged LSTM bias ``"b"`` maps to
``b_ih = b, b_hh = 0`` (their sum is what the cell adds).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> flat ``state_dict`` of f32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            if "b" in node and "wx" in node:  # legacy merged LSTM bias
                node = dict(node, b_ih=node["b"],
                            b_hh=np.zeros_like(np.asarray(node["b"])))
                del node["b"]
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
            return
        out[prefix[:-1]] = torch.tensor(np.asarray(node, dtype=np.float32))

    walk(tree, "")
    return out


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat ``state_dict`` -> the JAX package's nested dict of f32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, value in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value.detach().to("cpu", torch.float32).numpy().copy()
    return tree
