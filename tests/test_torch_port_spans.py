"""The port's span and counter recorder (``utils/profiling.py``) on the CPU.

- Off (no profiler session): a span is the shared no-op context, reads no
  clock and records nothing; a counter adds nothing.
- Under ``torch.profiler.profile(activities=[CPU])``: spans keep their
  parents and their attrs, and enter a profiler annotation whose trace
  event agrees with their stamps (``ts = (ns - baseTimeNanoseconds) /
  1e3``); ``device=True`` records no CUDA event on the CPU; ``take()``
  clears; past the cap spans are counted in ``spans_dropped``.
- The boundaries: an IW evaluation's ``iw_chunk`` > ``lstm.input_proj`` /
  ``lstm.recurrence`` / ``ce``, no read counted, and the decoder's shared
  input rows counted (``lstm.input_rows_shared``); an aggressive epoch's ``step`` (eager on the CPU), ``plateau_read`` and
  ``segment_read``, one ``device_reads`` each; the answers equal those of
  the same run with tracing off.
- The dossier's span sections: idle gaps split into starved and bubble
  under the innermost open span, replay device time by (mode, shape),
  appended after the rendered text.

Imports neither JAX nor the JAX package; the ``cuda`` tests of the same
recorder (the trace's clock, captures, launch counts) are in
tests/test_torch_port_cuda.py.
"""
import gzip
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vae_lagging_encoder_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _fresh():
    profiling.take()
    yield
    profiling.take()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _boom():
    raise AssertionError("the clock was read with tracing off")


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    monkeypatch.setattr(profiling, "_clock", _boom)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not profiling.tracing()
    a = profiling.span("step", mode="plain")
    b = profiling.span("replay", device=True)
    assert a is b is profiling.NO_SPAN
    with a:
        with b:
            profiling.count("device_reads")
    state = profiling.take()
    assert state == {"spans": [], "counters": {"spans_dropped": 0}}


def test_spans_carry_parents_and_attrs():
    with _cpu_profile() as prof:
        assert profiling.tracing()
        with profiling.span("step", mode="sub", shape=(4, 9)):
            with profiling.span("fill"):
                pass
            with profiling.span("replay", device=True):
                with profiling.span("inner"):
                    pass
        with profiling.span("segment_read"):
            pass
        profiling.count("device_reads")
        profiling.count("device_reads", 2)
    state = profiling.recorded()
    spans = state["spans"]
    assert [s["name"] for s in spans] == ["step", "fill", "replay", "inner", "segment_read"]
    assert [s["parent"] for s in spans] == [None, 0, 0, 2, None]
    assert spans[0]["attrs"] == {"mode": "sub", "shape": (4, 9)}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    assert state["counters"] == {"spans_dropped": 0, "device_reads": 3}
    names = [e.name for e in prof.events()]
    for n in ("step", "fill", "replay", "inner", "segment_read"):
        assert names.count(n) == 1, n
    # recorded() leaves the state; a span after the session records nothing
    assert profiling.recorded()["spans"] == spans
    with profiling.span("late"):
        pass
    assert len(profiling.recorded()["spans"]) == 5


def test_spans_share_the_trace_clock(tmp_path):
    with _cpu_profile():  # a process's first annotation holds ~1 ms of set-up
        with profiling.span("warm"):
            pass
    profiling.take()
    with _cpu_profile() as prof:
        for k in range(50):
            with profiling.span("outer"):
                with profiling.span("inner", k=k):
                    torch.ones(16).sum()
    spans = profiling.take()["spans"]
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    gaps = []
    for name in ("outer", "inner"):
        evs = sorted((e for e in trace["traceEvents"] if e.get("ph") == "X"
                      and e["name"] == name), key=lambda e: e["ts"])
        got = [s for s in spans if s["name"] == name]
        assert len(evs) == len(got) == 50
        for s, e in zip(got, evs):
            gaps += [abs((s["start_ns"] - base) / 1e3 - e["ts"]),
                     abs((s["end_ns"] - base) / 1e3 - (e["ts"] + e["dur"]))]
    # the same clock: the typical gap is the annotation's own few us (a shared
    # CPU can preempt single stamps; the cuda test bounds every one)
    assert float(np.median(gaps)) < 50.0


def test_device_spans_record_no_event_on_the_cpu():
    with _cpu_profile():
        with profiling.span("lstm.input_proj", device=True):
            torch.ones(3, 4) @ torch.ones(4, 5)
    (s,) = profiling.recorded()["spans"]
    assert s["device_ms"] is None and s["end_ns"] is not None
    assert profiling._spans[0].events is None


def test_take_clears():
    with _cpu_profile():
        with profiling.span("a"):
            profiling.count("device_reads")
    got = profiling.take()
    assert len(got["spans"]) == 1 and got["counters"]["device_reads"] == 1
    assert profiling.recorded() == {"spans": [], "counters": {"spans_dropped": 0}}
    with _cpu_profile():  # indices start again after take()
        with profiling.span("b"):
            with profiling.span("c"):
                pass
    assert [s["parent"] for s in profiling.recorded()["spans"]] == [None, 0]


def test_the_cap_counts_spans_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 2)
    with _cpu_profile():
        for _ in range(2):
            with profiling.span("kept"):
                with profiling.span("dropped"):
                    pass
        profiling.count("device_reads")
    state = profiling.take()
    assert [s["name"] for s in state["spans"]] == ["kept", "dropped"]
    assert state["counters"] == {"spans_dropped": 2, "device_reads": 1}
    assert profiling.recorded()["counters"] == {"spans_dropped": 0}


# ------------------------------------------------------------ the boundaries
def _text_setup(tmp_path, vocab=1030, **over):
    """A tiny kernel-route text VAE over a corpus of ``vocab`` words (the
    fused CE's route needs V >= 1024), its pool, on the CPU."""
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.data import BucketedPool, MonoTextData
    from vae_lagging_encoder_tpu_torch.models import build_text_vae

    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in rng.permutation(vocab)]
    lines = [" ".join(words[i:i + 10]) for i in range(0, vocab, 10)]
    (tmp_path / "c.txt").write_text("\n".join(lines) + "\n")
    data = MonoTextData(str(tmp_path / "c.txt"))
    cfg = get_config("synthetic", ni=8, enc_nh=12, nz=2, dec_nh=12, batch_size=8,
                     use_pallas=True, iw_nsamples=8, iw_batch=4, **over)
    vae = build_text_vae(cfg, len(data.vocab), device="cpu",
                         generator=torch.Generator().manual_seed(1))
    pool = BucketedPool(data.create_data_batch(cfg.batch_size, (8, 16)), "cpu")
    return cfg, vae, pool


def _descends(spans, i, name):
    while spans[i]["parent"] is not None:
        i = spans[i]["parent"]
        if spans[i]["name"] == name:
            return True
    return False


def test_iw_spans_nest_under_the_chunk_and_leave_the_answer(tmp_path):
    from vae_lagging_encoder_tpu_torch.train.epoch import IndexedNoise, make_iwnll_fn

    cfg, vae, pool = _text_setup(tmp_path)
    assert vae.dec.fused_ce
    vae.eval()
    fn = make_iwnll_fn(vae, pool, nsamples=cfg.iw_nsamples, ns=cfg.iw_batch)
    off = fn(IndexedNoise(5, "cpu"))
    with _cpu_profile():
        on = fn(IndexedNoise(5, "cpu"))
    assert on == off
    state = profiling.take()
    spans = state["spans"]
    names = [s["name"] for s in spans]
    n_batches = pool.num_batches
    chunks = cfg.iw_nsamples // cfg.iw_batch
    assert names.count("iw_chunk") == n_batches * chunks
    # per chunk: the encoder's and the decoder's LSTM, one CE (iw_batch 4 <= iw_chunk)
    for n in ("lstm.input_proj", "lstm.recurrence"):
        assert names.count(n) == 2 * n_batches * chunks, n
    assert names.count("ce") == n_batches * chunks
    for i, s in enumerate(spans):
        if s["name"] in ("lstm.input_proj", "lstm.recurrence", "ce"):
            assert spans[s["parent"]]["name"] == "iw_chunk"
        if s["name"] == "iw_chunk":
            assert s["parent"] is None
    assert set(names) == {"iw_chunk", "lstm.input_proj", "lstm.recurrence", "ce"}
    # no read; each decoder call computes its B sentences' input product once
    # for its iw_batch * B rows
    sentences = sum(int(x.shape[0]) for x, _, _ in pool)
    assert state["counters"] == {
        "spans_dropped": 0, "lstm.input_rows_shared": chunks * (cfg.iw_batch - 1) * sentences}


@pytest.mark.parametrize("aggressive", [True, False])
def test_training_spans_and_reads(tmp_path, aggressive):
    from vae_lagging_encoder_tpu_torch.train.epoch import GeneratorNoise, make_train_epoch

    runs = {}
    for traced in (False, True):
        cfg, vae, pool = _text_setup(tmp_path, burn_window=2, burn_max_iters=5)
        epoch_fn, opt_init = make_train_epoch(vae, pool, cfg)
        order = np.arange(pool.num_batches)[:4]
        if traced:
            with _cpu_profile():
                out = epoch_fn(opt_init(), GeneratorNoise(4, "cpu"), np.float32(0.1), cfg.lr,
                               order, aggressive, seg=3)
        else:
            out = epoch_fn(opt_init(), GeneratorNoise(4, "cpu"), np.float32(0.1), cfg.lr,
                           order, aggressive, seg=3)
        runs[traced] = (out, [p.detach().clone() for p in vae.parameters()])
    (o0, p0), (o1, p1) = runs[False], runs[True]
    assert o0[2].tolist() == o1[2].tolist() and o0[3] == o1[3]
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    state = profiling.take()
    spans = state["spans"]
    steps = [s for s in spans if s["name"] == "step"]
    inner = o1[3]
    assert len(steps) == len(order) + inner
    assert {s["attrs"]["path"] for s in steps} == {"eager"}  # the CPU runs no graph
    modes = [s["attrs"]["mode"] for s in steps]
    assert modes.count("sub") == inner
    assert modes.count("outer" if aggressive else "plain") == len(order)
    assert all(len(s["attrs"]["shape"]) == 2 for s in steps)
    plateau = [s for s in spans if s["name"] == "plateau_read"]
    segment = [s for s in spans if s["name"] == "segment_read"]
    assert len(segment) == 2  # segments [0, 3), [3, 4)
    assert (len(plateau) > 0) == aggressive
    assert state["counters"]["device_reads"] == len(plateau) + len(segment)
    # the eager steps' LSTM spans sit inside their step
    for i, s in enumerate(spans):
        if s["name"].startswith("lstm."):
            assert _descends(spans, i, "step")


# ------------------------------------------------------------ the dossier's sections
def _synthetic_window():
    """Three kernels: B queued before the gap [20, 30) opens (a bubble
    under ``replay``), C launched at 50 inside the gap [40, 55) (starved,
    under ``segment_read``); µs from a base of 1e6 ns."""
    base = 10 ** 6
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 0, "dur": 2,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 15, "dur": 2,
           "args": {"correlation": 2}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 50, "dur": 2,
           "args": {"correlation": 3}},
          {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 10, "dur": 10, "pid": 0, "tid": 7,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 30, "dur": 10, "pid": 0, "tid": 7,
           "args": {"correlation": 2}},
          {"ph": "X", "cat": "kernel", "name": "k_c", "ts": 55, "dur": 5, "pid": 0, "tid": 7,
           "args": {"correlation": 3}}]

    def sp(name, a, b, parent, attrs=None, ms=None):
        return {"name": name, "start_ns": base + a * 1000, "end_ns": base + b * 1000,
                "parent": parent, "attrs": attrs or {}, "device_ms": ms}

    state = {"spans": [sp("step", 0, 26, None, {"mode": "sub", "shape": (32, 97),
                                                "path": "replay"}),
                       sp("replay", 1, 25, 0, ms=1.0),
                       sp("step", 26, 34, None, {"mode": "sub", "shape": (32, 97),
                                                 "path": "replay"}),
                       sp("replay", 27, 33, 2, ms=3.0),
                       sp("segment_read", 35, 45, None)],
             "counters": {"spans_dropped": 0}}
    return ev, base, state


def test_span_sections_split_starved_and_bubble():
    ev, base, state = _synthetic_window()
    lines, extra = profiling.span_sections(state, ev, base)
    assert extra["idle_by_span"] == {
        "segment_read": {"starved_ms": 0.015, "bubble_ms": 0.0, "gaps": 1},
        "replay": {"starved_ms": 0.0, "bubble_ms": 0.01, "gaps": 1}}
    (row,) = extra["step_device_ms"]
    assert row["mode"] == "sub" and row["shape"] == "32x97" and row["replays"] == 2
    assert row["median_ms"] == pytest.approx(2.0) and row["p97_5_ms"] == pytest.approx(2.95)
    assert "## Idle gaps by span" in lines and "## Step device time by (mode, shape)" in lines
    assert "| all | 0.015 | 0.010 | 2 |" in lines


def test_write_dossier_appends_the_span_sections(tmp_path):
    ev, base, state = _synthetic_window()
    path = tmp_path / "w.pt.trace.json.gz"
    with gzip.open(path, "wt") as fh:
        json.dump({"baseTimeNanoseconds": base, "traceEvents": ev}, fh)
    out = tmp_path / "DOSSIER.md"
    summary = profiling.write_dossier(str(tmp_path), steps=2, out_path=str(out), spans=state)
    text = out.read_text()
    plain = profiling.render_dossier(profiling.distill_trace(str(tmp_path), 2),
                                     header_lines=("- 1 CUDA-graph replays (cudaGraphLaunch) "
                                                   "in the window: the kernels inside them "
                                                   "are counted below as their own device "
                                                   "events", ""))
    assert text.startswith(plain)
    assert text.index("## Idle gaps by span") < text.index("## Step device time by")
    assert summary["idle_by_span"]["segment_read"]["gaps"] == 1
    assert json.loads((tmp_path / "DOSSIER.json").read_text())["step_device_ms"][0]["replays"] == 2
    # without spans the dossier is the rendered text alone
    profiling.write_dossier(str(tmp_path), steps=2, out_path=str(out))
    assert out.read_text() == plain
