"""Rehearsal of BENCHMARK.json on the CPU: every cell's files load through
the harness's loader, names and units keep to the contract, every
per-layer metric has a reader that declares nothing its entry holds, and
a cell, a metric or a model type added as files alone is found without an
edit."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from port_bench import manifest

MANIFEST = manifest.load_json(manifest.find_manifest())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads(cell):
    c = manifest.load_cell(cell, MANIFEST)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) == 2, names  # setup_s and the cell's rate
    assert c.per_layer, "every cell reports a per-layer metric"
    assert c.traffic["rate_of"] in ("steps", "examples")
    assert c.traffic["entry"] in ("train", "iwnll")
    assert c.limits, "the comparison that decides correct has its limits"
    for lim in c.limits.values():
        assert lim["lower"] < lim["limit"] < lim["upper"] and lim["upper"] >= 3 * lim["lower"]
    for m in c.per_layer:  # a metric's cells report the end-to-end metric it moves
        assert m["moves"] in names, (m["name"], cell)


def test_names_units_and_entries():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[key]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for key, keys in allowed.items():
        for e in MANIFEST[key]:
            assert set(e) <= keys, (key, e)
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in MANIFEST["configs"]:
        cfg = manifest.load_json(manifest.HERE.parent / c["file"])
        assert set(c["reduced"]) <= set(cfg) and all(NAME.match(k) for k in c["reduced"])
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank", "_nh")) and k not in ("ni", "nz")
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_every_metric_has_a_reader_and_one_source_of_truth():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        r = manifest.load_reader(m["name"])
        assert callable(r.read), m["name"]
        # layer, unit, moves and cells live in BENCHMARK.json alone
        assert not {"LAYER", "UNIT", "MOVES", "CELLS"} & set(vars(r)), m["name"]
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", CELLS))
    files = {p.stem for p in (manifest.HERE / "metrics").glob("*.py")}
    assert files == {m["name"] for m in MANIFEST["per_layer"]}


def test_unknown_entries_and_models_are_refused():
    from port_bench import models
    from port_bench.run import entry_class

    assert entry_class("train").__name__ == "TrainCell"
    with pytest.raises(KeyError):
        entry_class("serve")
    with pytest.raises(KeyError):
        models.model_for({"model": "no_such_model"}, {})
    with pytest.raises(KeyError):
        models.model_for({"model": "../run"}, {})


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads(json.dumps(MANIFEST))
    m["workloads"].append({"name": "yahoo.train_short", "config": "yahoo",
                           "traffic": "train_short", "chips": 1, "why": "a later cell"})
    tr = manifest.load_json(manifest.HERE / "traffic" / "train_plain.json")
    (root / "port_bench" / "traffic" / "train_short.json").write_text(
        json.dumps(dict(tr, outer_per_call=32)))
    (root / "port_bench" / "workloads" / "yahoo.train_short.json").write_text(
        json.dumps({"limits": {"grad": {"limit": 1.0}}}))
    (root / "port_bench" / "metrics" / "steps_seen.train.py").write_text(
        'def read(run):\n    return run.steps\n')
    m["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "step and inner loop",
                           "moves": "train_steps_per_s", "workloads": ["yahoo.train_short"]})
    next(e for e in m["end_to_end"] if e["name"] == "train_steps_per_s")["workloads"].append(
        "yahoo.train_short")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.load_cell("yahoo.train_short",
                              manifest.load_json(manifest.find_manifest(root)),
                              root / "port_bench")
    assert cell.traffic["outer_per_call"] == 32 and cell.limits["grad"]["limit"] == 1.0
    assert cell.readers["steps_seen.train"].read(type("R", (), {"steps": 7})) == 7
    assert {x["name"] for x in cell.end_to_end} == {"train_steps_per_s", "setup_s"}


def test_an_existing_metric_in_a_new_cell_needs_no_edit(tmp_path):
    """A later cell that reports ``mfu.train`` names itself in the metric's
    ``workloads`` in BENCHMARK.json; the reader file stays as it is."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = (root / "port_bench" / "metrics" / "mfu.train.py").read_text()
    m = json.loads(json.dumps(MANIFEST))
    m["workloads"].append({"name": "yahoo.train_long", "config": "yahoo",
                           "traffic": "train_plain", "chips": 1, "why": "a later cell"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "yahoo.train_plain" in e.get("workloads", []):
            e["workloads"].append("yahoo.train_long")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.load_cell("yahoo.train_long",
                              manifest.load_json(manifest.find_manifest(root)),
                              root / "port_bench")
    assert "mfu.train" in cell.readers and cell.traffic["entry"] == "train"
    assert (root / "port_bench" / "metrics" / "mfu.train.py").read_text() == before


def test_a_model_type_added_as_a_file_is_found(tmp_path, monkeypatch):
    from port_bench import models

    (tmp_path / "toy_vae.py").write_text(
        "class Model:\n    def __init__(self, config, tr):\n        self.c = config\n")
    # the models directory of a checkout that holds one more file
    monkeypatch.setattr(models, "HERE", tmp_path)
    monkeypatch.setattr(models, "__path__", [str(tmp_path)] + list(models.__path__))
    assert models.model_for({"model": "toy_vae"}, {}).c == {"model": "toy_vae"}
