"""The numbers that decide ``correct``, and their limits.

Training (the first three static steps of the run, which set-up drives
through the window's own call; the reference follows them from the same
weights, batches and noise):

- ``loss``: per step, |program's mean loss - reference's| / |reference's|,
  the largest of the steps whose loss the program reports;
- ``grad``: the first step's gradient as the optimizer got it (SGD: the
  parameters' change over lr; Adam: its first moment over 1 - b1), per
  leaf it updated: |‖program‖ - ‖reference‖| / max(‖reference's leaf‖,
  ‖median leaf‖), the worst leaf;
- ``change``: the parameters' change after the three steps, the same gap
  per leaf, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves under Adam by round-off alone).

IW-NLL: ``nll``, per compared batch |program's mean IW-NLL - reference's|
/ |reference's|, the largest.

Norms and gaps are taken in float64. A number that is not finite reads as
infinite.
"""
from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Iterable, List

import torch

Tensors = Dict[str, torch.Tensor]
GRAD_FLOOR = 1e-3  # of the median leaf's reference gradient norm


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def leaf_gap(prog: Tensors, ref: Tensors, leaves: Iterable[str]) -> float:
    """The worst leaf's gap of norms, against max(its reference norm, the
    median leaf's)."""
    leaves = list(leaves)
    if not leaves:
        return 0.0
    rn = {k: _norm(ref[k]) for k in leaves}
    med = statistics.median(rn.values())
    worst = 0.0
    for k in leaves:
        gap = abs(_norm(prog[k]) - rn[k]) / max(rn[k], med, 1e-30)
        worst = max(worst, _finite(gap))
    return worst


def moved_leaves(ref_grad: Tensors) -> List[str]:
    """Leaves whose reference gradient norm is at least ``GRAD_FLOOR`` of
    the median leaf's."""
    n = {k: _norm(v) for k, v in ref_grad.items()}
    med = statistics.median(n.values())
    return sorted(k for k, v in n.items() if v >= GRAD_FLOOR * med)


def rel_gap(prog: float, ref: float) -> float:
    return _finite(abs(prog - ref) / max(abs(ref), 1e-30))


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> bool:
    """Every number within its limit; a number without a limit fails."""
    return all(k in limits and numbers[k] <= limits[k]["limit"] for k in numbers)


def report(numbers: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, dict]:
    """``{name: {"value": .., "limit": ..}}`` in a fixed order, printed on
    standard error as the run's last lines."""
    out = {k: {"value": numbers[k], "limit": limits.get(k, {}).get("limit")}
           for k in sorted(numbers)}
    for k, v in out.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return out
