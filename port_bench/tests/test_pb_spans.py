"""The readers of the program's spans and counters
(``starved_share.train``, ``reads_per_step.train``,
``input_proj_ms_per_example.eval``, ``chunk_glue_ms_per_example.eval``) on
a synthetic recorder state: each gives its value, and None on an empty
state, in a cell of the other kind, and with a program that has no
recorder (a parent commit's)."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from port_bench import manifest
from vae_lagging_encoder_tpu_torch.utils import profiling

MS = 10 ** 6  # ns


def _span(name, a, b, parent=None, ms=None):
    return {"name": name, "start_ns": a, "end_ns": b, "parent": parent, "attrs": {},
            "device_ms": ms}


TRAIN = {"spans": [_span("step", 0, 4 * MS), _span("fill", 0, 1 * MS, 0),
                   _span("replay", 1 * MS, 2 * MS, 0, ms=3.0),
                   _span("plateau_read", 5 * MS, 9 * MS),
                   _span("step", 10 * MS, 14 * MS), _span("fill", 10 * MS, 11 * MS, 4),
                   _span("replay", 12 * MS, 13 * MS, 4, ms=3.0),
                   _span("segment_read", 20 * MS, 25 * MS)],  # no replay after it
         "counters": {"spans_dropped": 0, "device_reads": 2}}
# two chunks: 10 and 8 device ms, with parts 2 + 3 + 1 (one nested one level
# down) and 4 + 0.5; a part outside any chunk does not count
IW = {"spans": [_span("iw_chunk", 1, 50, None, ms=10.0),
                _span("lstm.input_proj", 2, 3, 0, ms=2.0),
                _span("lstm.recurrence", 3, 4, 0, ms=3.0),
                _span("host_part", 4, 9, 0),
                _span("ce", 5, 8, 3, ms=1.0),
                _span("iw_chunk", 51, 99, None, ms=8.0),
                _span("lstm.input_proj", 52, 53, 5, ms=4.0),
                _span("ce", 54, 55, 5, ms=0.5),
                _span("lstm.input_proj", 200, 201, None, ms=7.0)],
      "counters": {"spans_dropped": 0}}
EMPTY = {"spans": [], "counters": {"spans_dropped": 0}}


def _run(kind, **kw):
    base = dict(kind=kind, wall_s=0.5, steps=4, examples=2.0)
    return SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("name,kind,state,want", [
    ("starved_share.train", "train", TRAIN, 100.0 * (12 - 9) * 1e-3 / 0.5),
    ("reads_per_step.train", "train", TRAIN, 2 / 4),
    ("input_proj_ms_per_example.eval", "iwnll", IW, (2.0 + 4.0 + 7.0) / 2.0),
    ("chunk_glue_ms_per_example.eval", "iwnll", IW, ((10 - 2 - 3 - 1) + (8 - 4 - 0.5)) / 2.0),
])
def test_readers_on_a_synthetic_state(monkeypatch, name, kind, state, want):
    reader = manifest.load_reader(name)
    monkeypatch.setattr(profiling, "recorded", lambda: state)
    assert reader.read(_run(kind)) == pytest.approx(want)
    other = "iwnll" if kind == "train" else "train"
    assert reader.read(_run(other)) is None
    monkeypatch.setattr(profiling, "recorded", lambda: EMPTY)
    assert reader.read(_run(kind)) is None


@pytest.mark.parametrize("name,kind", [("starved_share.train", "train"),
                                       ("reads_per_step.train", "train"),
                                       ("input_proj_ms_per_example.eval", "iwnll"),
                                       ("chunk_glue_ms_per_example.eval", "iwnll")])
def test_readers_without_the_recorder_read_nothing(monkeypatch, name, kind):
    """A program without ``recorded`` (a parent commit's): None, no raise."""
    reader = manifest.load_reader(name)
    stub = SimpleNamespace()  # a profiling module without the recorder
    monkeypatch.setitem(sys.modules, "vae_lagging_encoder_tpu_torch.utils.profiling", stub)
    assert reader.read(_run(kind)) is None


def test_a_training_state_with_no_replay_after_a_read_reads_nothing(monkeypatch):
    reader = manifest.load_reader("starved_share.train")
    state = {"spans": [_span("replay", 0, 1, ms=1.0), _span("segment_read", 2, 3)],
             "counters": {"device_reads": 1}}
    monkeypatch.setattr(profiling, "recorded", lambda: state)
    assert reader.read(_run("train")) is None
