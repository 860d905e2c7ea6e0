"""The benchmark's loader: every piece found by its name.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
the configurations and the metrics. Each piece lives in a file named after
it, under this directory:

- ``configs/<config>.json``: the configuration as it is run (widths,
  optimizer, data distribution, precision, ``reduced``, ``assumed``);
- ``traffic/<traffic>.json``: a traffic mix, the parameters one general
  driver reads (``entry``: ``train`` or ``iwnll``; its mode, pool and
  window parameters);
- ``workloads/<cell>.json``: the limits of the comparison that decides the
  cell's ``correct``, with the readings each was set from;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run) ->
  float | None``; its layer, unit, the metric it moves and its cells are
  the ones its entry in ``BENCHMARK.json`` gives, and nowhere else;
- ``models/<model>.py``: the model type a configuration's ``model`` names.

Adding a cell is adding its entry to ``BENCHMARK.json`` and its files;
nothing here names a cell, a configuration or a metric.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, dict]
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object] = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_reader(name: str, root: Path = HERE):
    """The module ``metrics/<name>.py`` (a name may hold dots)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("port_bench_metric_" + name.replace(".", "_")
                                                  .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``manifest`` (BENCHMARK.json's content)."""
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"workload {name!r}: {len(entries)} entries in BENCHMARK.json")
    w = entries[0]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(root.parent / cfg_entry["file"])
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
    limits_path = root / "workloads" / f"{name}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() else {}
    e2e = [m for m in manifest["end_to_end"] if applies(m, name)]
    per_layer = [m for m in manifest["per_layer"] if applies(m, name)]
    cell = Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer)
    cell.readers = {m["name"]: load_reader(m["name"], root) for m in per_layer}
    return cell


def find_manifest(start: Optional[Path] = None) -> Path:
    """``BENCHMARK.json`` beside this directory (the checkout's root)."""
    path = (start or HERE.parent) / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json")
    return path
