"""utils/profiling.py of the port: distilling a ``torch.profiler`` Chrome
trace into the dossier.

The cases of tests/test_profiling.py on hand-written traces in torch's
format (device work = complete events of the categories ``kernel``,
``gpu_memcpy``, ``gpu_memset``; a (pid, tid) pair per stream): exact self
times under nesting, back-to-back siblings, no device timeline (a CPU
run), an empty directory, the ``--profile_dir`` hook of ``run_training`` on
the CPU (the trace is written, the dossier skipped), per-device means over
two devices; and, in place of the JAX package's ``--parse_only`` script
case, the newest of several traces (plain and gzipped) is the one read.
``render_dossier`` writes the JAX package's text for the same summary.
Times are microsecond integers in the fixtures, so the checks are exact
up to float rounding (``pytest.approx``).
"""
import gzip
import json
import os
import time

import numpy as np
import pytest

from vae_lagging_encoder_tpu.utils.profiling import render_dossier as jax_render_dossier
from vae_lagging_encoder_tpu_torch.utils.profiling import (distill_trace, find_trace, op_name,
                                                           render_dossier, write_dossier)

LSTM_BWD = "void lstm_bwd_mma_kernel<16>(float const*, float const*, __nv_bfloat16 const*)"
CE_TRAIN = "void ce_bf16_kernel<true>(__nv_bfloat16 const*, __nv_bfloat16 const*, int const*)"
GEMM = "sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32_warpgroupsize1x1x1"


def _write_trace(root, events, name="host_1.1.pt.trace.json", gz=False):
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, name + (".gz" if gz else ""))
    with (gzip.open(path, "wt") if gz else open(path, "w")) as fh:
        json.dump({"schemaVersion": 1, "traceEvents": events}, fh)
    return str(root)


def _ev(name, ts, dur, pid=0, tid=7, cat="kernel", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _host():
    return [{"ph": "M", "name": "process_name", "pid": 1234, "args": {"name": "python"}},
            _ev("aten::mm", 0, 300, pid=1234, tid=1234, cat="cpu_op"),
            _ev("cudaLaunchKernel", 5, 4, pid=1234, tid=1234, cat="cuda_runtime")]


def test_self_time_subtracts_nested_children(tmp_path):
    """outer [0,100] > middle [10,90] > {lstm_bwd [20,50], lstm_bwd [60,80]}:
    self times outer 20, middle 30, lstm_bwd 30 + 20 over two calls; the
    device-busy union, with a copy after them, is 110: no double counting."""
    ev = _host() + [_ev("outer_kernel", 0, 100), _ev("void reduce_kernel<512>()", 10, 80),
                    _ev(LSTM_BWD, 20, 30), _ev(LSTM_BWD, 60, 20),
                    _ev("Memcpy HtoD (Pageable -> Device)", 120, 10, cat="gpu_memcpy",
                        bytes=5_000_000)]
    s = distill_trace(_write_trace(tmp_path, ev), steps=10)
    assert s["device_busy_ms"] == pytest.approx(0.11)
    assert s["ops_total_ms"] == pytest.approx(0.11)  # reconciles: no double count
    rows = {(r["op"], r["category"]): r for r in s["table"]}
    bwd = rows[("lstm_bwd", "port kernel")]
    assert bwd["ms_total"] == pytest.approx(0.05) and bwd["calls"] == 2
    assert bwd["ms_per_step"] == pytest.approx(0.005)
    assert rows[("outer_kernel", "other")]["ms_total"] == pytest.approx(0.02)
    assert rows[("reduce_kernel<512>", "reduce")]["ms_total"] == pytest.approx(0.03)
    cp = rows[("Memcpy HtoD (Pageable -> Device)", "memcpy")]
    assert cp["gb_accessed"] == pytest.approx(0.005)
    cats = {c["category"]: c for c in s["categories"]}
    assert cats["port kernel"]["pct_device"] == pytest.approx(100 * 50 / 110, abs=0.01)
    md = render_dossier(s, title="T")
    assert "| lstm_bwd" in md.replace("`", "") and "port kernel" in md
    # the port's kernels under their wrappers' names, others by symbol and kind
    assert op_name(CE_TRAIN) == ("ce_fwd_train", "port kernel")
    assert op_name("void lstm_infer_kernel<4, 2, true>(float const*)") == \
        ("lstm_fwd_residuals", "port kernel")
    assert op_name("void lstm_infer_kernel<4, 2, false>(float const*)") == \
        ("lstm_fwd_infer", "port kernel")
    assert op_name(GEMM)[1] == "gemm"
    assert op_name("void at::native::vectorized_elementwise_kernel<4>(int)")[1] == "elementwise"


def test_sibling_events_not_treated_as_nested(tmp_path):
    ev = [_ev("a_kernel", 0, 10), _ev("b_kernel", 10, 15)]
    s = distill_trace(_write_trace(tmp_path, ev), steps=1)
    rows = {r["op"]: r for r in s["table"]}
    assert rows["a_kernel"]["ms_total"] == pytest.approx(0.01)
    assert rows["b_kernel"]["ms_total"] == pytest.approx(0.015)
    assert s["device_busy_ms"] == pytest.approx(0.025)


def test_no_device_timeline_returns_none(tmp_path):
    root = _write_trace(tmp_path, _host())
    assert distill_trace(root, steps=4) is None
    out = tmp_path / "D.md"
    assert write_dossier(root, 4, str(out)) is None
    assert not out.exists()


def test_graph_replays_are_counted_and_named_in_the_dossier(tmp_path):
    """A window of CUDA-graph replays: its kernels are device events like any
    other; the dossier's header says how many replays the host launched."""
    graph = [_ev("cudaGraphLaunch", t, 3, pid=1234, tid=1234, cat="cuda_runtime")
             for t in (0, 100)]
    ev = _host() + graph + [_ev(LSTM_BWD, 10, 30), _ev(LSTM_BWD, 110, 30)]
    s = distill_trace(_write_trace(tmp_path / "t", ev), steps=2)
    assert s["graph_launches"] == 2
    assert {r["op"]: r["calls"] for r in s["table"]} == {"lstm_bwd": 2}
    assert write_dossier(str(tmp_path / "t"), 2, str(tmp_path / "D.md")) is not None
    md = (tmp_path / "D.md").read_text()
    assert "2 CUDA-graph replays (cudaGraphLaunch)" in md.splitlines()[2]
    plain = distill_trace(_write_trace(tmp_path / "p", _host() + [_ev(LSTM_BWD, 10, 30)]), 1)
    assert plain["graph_launches"] == 0


def test_empty_trace_root_returns_none(tmp_path):
    assert distill_trace(str(tmp_path), steps=1) is None


@pytest.mark.parametrize("epochs", [2, 1])
def test_profile_dir_hook_runs_gracefully_on_cpu(tmp_path, epochs):
    """``--profile_dir`` on the CPU: the epoch JAX picks (1, or 0 with
    ``--epochs 1``) is traced and exported, the dossier finds no device
    timeline and is skipped, and training completes."""
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.data import BucketedPool, MonoTextData
    from vae_lagging_encoder_tpu_torch.data.synthetic import generate_synthetic_corpus
    from vae_lagging_encoder_tpu_torch.models import build_text_vae
    from vae_lagging_encoder_tpu_torch.train.loop import run_training

    class Capture:
        def __init__(self):
            self.lines = []

        def info(self, msg):
            self.lines.append(msg)

        def metric(self, **kv):
            pass

    cfg = get_config("synthetic", ni=8, enc_nh=12, nz=2, dec_nh=12, batch_size=16,
                     epochs=epochs, aggressive=False, warm_up=1, iw_nsamples=4, iw_batch=4,
                     decay_epoch=5, profile_dir=str(tmp_path / "trace"),
                     save_path=str(tmp_path / "m.ckpt"))
    sents, _ = generate_synthetic_corpus(num_sentences=96, vocab_size=20, min_len=4,
                                         max_len=12, seed=3)
    (tmp_path / "c.txt").write_text("".join(" ".join(s) + "\n" for s in sents))
    data = MonoTextData(str(tmp_path / "c.txt"))
    mk = lambda: BucketedPool(data.create_data_batch(16, (8, 16)), "cpu")
    vae = build_text_vae(cfg, len(data.vocab), device="cpu")
    log = Capture()
    results = run_training(cfg, vae, mk(), mk(), mk(), log)
    assert np.isfinite(results["elbo_loss"])
    traced = epochs - 1 if epochs > 1 else 0
    assert os.path.isfile(tmp_path / "trace" / f"epoch{traced}.pt.trace.json.gz")
    assert find_trace(str(tmp_path / "trace")).endswith(f"epoch{traced}.pt.trace.json.gz")
    assert any("no device timeline" in l for l in log.lines)
    assert not (tmp_path / "trace" / "DOSSIER.md").exists()


def test_multi_device_trace_reports_per_device_mean(tmp_path):
    ev = []
    for pid in (0, 1):
        ev += [_ev(GEMM, 0, 40, pid=pid), _ev(CE_TRAIN, 50, 50, pid=pid, tid=8)]
    s = distill_trace(_write_trace(tmp_path, ev), steps=10)
    assert s["devices"] == 2
    assert s["device_busy_ms"] == pytest.approx(0.09)  # per device, not 0.18
    rows = {r["op"]: r for r in s["table"]}
    assert rows["ce_fwd_train"]["ms_total"] == pytest.approx(0.05)
    assert rows["ce_fwd_train"]["calls"] == 1
    assert rows["ce_fwd_train"]["pct_device"] == pytest.approx(100 * 50 / 90, abs=0.01)


def test_newest_trace_is_read(tmp_path):
    """Several traces under the directory (plain and gzipped, one in a
    subdirectory): the newest by modification time is distilled."""
    old = _write_trace(tmp_path, [_ev("old_kernel", 0, 10)], name="a.pt.trace.json")
    past = time.time() - 100
    os.utime(os.path.join(old, "a.pt.trace.json"), (past, past))
    _write_trace(tmp_path / "sub", [_ev("new_kernel", 0, 30)], name="b.pt.trace.json",
                 gz=True)
    s = distill_trace(str(tmp_path), steps=3)
    assert s["trace"].endswith("b.pt.trace.json.gz")
    assert [r["op"] for r in s["table"]] == ["new_kernel"]
    assert s["ms_per_step_device"] == pytest.approx(0.01)


def test_render_dossier_matches_jax_text(tmp_path):
    ev = ([_ev(GEMM, 0, 400, pid=p) for p in (0, 1)]
          + [_ev(LSTM_BWD, 500, 250, pid=p, tid=9) for p in (0, 1)])
    s = distill_trace(_write_trace(tmp_path, ev), steps=4)
    for kw in ({}, {"title": "Epoch-1 profiler dossier (yahoo)", "top": 1,
                    "header_lines": ("- card: test",)}):
        assert render_dossier(s, **kw) == jax_render_dossier(s, **kw)
