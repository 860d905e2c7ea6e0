"""Map the JAX package's parameter pytree to this package's state dict.

The port keeps the JAX layouts at its public functions (``wx [ni, 4H]``,
``wh [H, 4H]``, ``pred [nh, V]``, ``emb [V, ni]``, HWIO conv weights), so
the mapping is a renaming: nested dict keys ``{"enc": {"lstm": {"wx": ...}}}``
become ``"enc.lstm.wx"``, and list items (the image model's
``enc.blocks[i]``, ``dec.layers[i]``) become their index,
``"enc.blocks.0.down"``. A legacy merged LSTM bias ``"b"`` maps to
``b_ih = b, b_hh = 0`` (their sum is what the cell adds).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dicts/lists of numpy arrays -> flat ``state_dict`` of f32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            if "b" in node and "wx" in node:  # legacy merged LSTM bias
                node = dict(node, b_ih=node["b"],
                            b_hh=np.zeros_like(np.asarray(node["b"])))
                del node["b"]
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix[:-1]] = torch.tensor(np.asarray(node, dtype=np.float32))
            return
        for k, v in items:
            walk(v, f"{prefix}{k}.")

    walk(tree, "")
    return out


def _lists(node):
    """Dicts keyed "0".."n-1" (list items flattened by name) back to lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and sorted(node) == sorted(map(str, range(len(node)))):
        return [node[str(i)] for i in range(len(node))]
    return node


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat ``state_dict`` -> the JAX package's nested dicts/lists of f32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, value in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value.detach().to("cpu", torch.float32).numpy().copy()
    return _lists(tree)
