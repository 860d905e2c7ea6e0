"""The yardstick's arithmetic, pinned: model FLOPs, launch bounds, the
trace walk, the comparison's numbers."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from port_bench import compare, flops, inputs, tracing
from port_bench.manifest import HERE

YAHOO = json.loads((HERE / "configs" / "yahoo.json").read_text())


def test_padded_text_step_is_bench_py_s_612_gflop():
    assert flops.text_padded_train_flops(YAHOO, 32, 96) == pytest.approx(611.8e9, rel=1e-3)


def test_real_positions_count_less_than_the_padding():
    full = flops.text_train_flops(YAHOO, [96] * 32)
    # the decoder predicts T - 1 positions where the padded count took T
    assert full == pytest.approx(flops.text_padded_train_flops(YAHOO, 32, 96), rel=1e-2)
    ragged = flops.text_train_flops(YAHOO, [82] * 32)  # a Yahoo-like batch padded to 96
    assert ragged < 0.87 * full
    per_token = flops.text_token_flops(YAHOO, 20004)
    iw = flops.text_iwnll_flops(YAHOO, [82], 500, 100)
    assert iw == pytest.approx(5 * 82 * per_token["enc"] + 500 * 81 * per_token["dec"], rel=1e-3)


def test_launch_bounds_match_chip_smoke():
    # chip_smoke.py's phase 2: the 32-row residual forward at T 96 is bound
    # by its bytes at 0.040 ms; the CE forward at N 60800 by its operations
    # at 2.52 ms; its VJP at N 3040 at 0.252 ms
    assert flops.lstm_fwd_bound(96, 32, 1024, 96 * 32, True) * 1e3 == pytest.approx(0.040,
                                                                                    rel=0.05)
    assert flops.ce_fwd_bound(60800, 1024, 20004, False) * 1e3 == pytest.approx(2.52, rel=0.01)
    assert flops.ce_bwd_bound(3040, 1024, 20004) * 1e3 == pytest.approx(0.252, rel=0.01)
    # masked positions need no product: fewer real positions, a lower bound
    assert flops.lstm_bwd_bound(96, 640, 1024, 50000, ) < flops.lstm_bwd_bound(96, 640, 1024,
                                                                             96 * 640)


def _ev(name, ts, dur, cat="kernel", corr=0):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "args": {"correlation": corr}}


def test_trace_walk():
    dev = [_ev("void lstm_bwd_narrow_kernel<1>(float*)", 0, 10),
           _ev("void ce_bwd_d_kernel(x)", 10, 5), _ev("ce_bwd_gemm_kernel<true>", 15, 5),
           _ev("cutlass::Kernel2<cutlass_80_simt_sgemm_128x256>(p)", 30, 10),
           _ev("void at::native::(anonymous namespace)::cat_kernel(x)", 45, 5),
           _ev("Memset (Device)", 50, 1, cat="gpu_memset")]
    rt = [_ev("cudaGraphLaunch", -5, 2, cat="cuda_runtime"),
          _ev("cudaStreamSynchronize", 19, 12, cat="cuda_runtime"),
          _ev("cudaMemcpyAsync", 41, 1, cat="cuda_runtime")]
    t = tracing.Trace(wall_s=60e-6, device=dev, runtime=rt)
    assert t.busy_s() == pytest.approx(36e-6)
    ops = t.op_seconds()
    assert ops[("lstm_bwd", "port")] == pytest.approx(10e-6)
    assert ops[("cutlass::Kernel2<cutlass_80_simt_sgemm_128x256>", "gemm")] == pytest.approx(10e-6)
    assert ("at::native::cat_kernel", "other") in ops
    assert ("memset Memset (Device)", "memset") in ops
    assert t.port_calls() == {"lstm_bwd": 1, "ce_bwd_d": 1, "ce_bwd_dw": 1, "ce_bwd": 1}
    assert t.launch_calls() == 2
    assert dict(t.idle_gaps()) == pytest.approx({"cudaStreamSynchronize": 10e-6,
                                                 "host": 5e-6})


def test_leaf_gaps():
    ref = {"a": torch.ones(4), "b": 2 * torch.ones(4), "c": 1e-9 * torch.ones(4)}
    same = {k: v.clone() for k, v in ref.items()}
    assert compare.leaf_gap(same, ref, ref) == 0.0
    off = dict(same, c=torch.zeros(4))  # a tiny leaf judged against the median leaf
    assert compare.leaf_gap(off, ref, ref) == pytest.approx(1e-9 * 2 / 2)
    assert compare.leaf_gap({k: 0 * v for k, v in ref.items()}, ref, ref) == 1.0
    assert compare.moved_leaves(ref) == ["a", "b"]
    assert compare.leaf_gap(dict(same, a=torch.full((4,), float("nan"))), ref, ref) == np.inf
    assert compare.judge({"x": 1.0}, {"x": {"limit": 1.0}})
    assert not compare.judge({"x": 1.0}, {})


def test_schedule_keeps_the_padded_batch_in_place():
    counts = [2, 4, 9, 15, 8, 3]
    runs = [list(__import__("itertools").islice(inputs.schedule(counts, s, 5), 123))
            for s in (1, 2 ** 33 + 7)]
    starts = np.cumsum([0] + counts)
    bucket = np.searchsorted(starts, np.array(runs), side="right") - 1
    assert (bucket[0] == bucket[1]).all()  # the same shapes in the same order
    for b, c in enumerate(counts):  # each cycle visits every batch once
        cyc = [f for f in runs[0][:41] if starts[b] <= f < starts[b + 1]]
        assert sorted(cyc) == list(range(starts[b], starts[b + 1]))
    last = [f for f in starts[1:] - 1]
    pos = [[i for i, f in enumerate(r) if f in last] for r in runs]
    assert pos[0] == pos[1]
    assert runs[0] != runs[1]
    first = inputs.first_of_largest(counts, 3, 9, 1)
    assert len(set(first)) == 3 and all(starts[3] <= f < starts[4] - 1 for f in first)


def test_rooflines_sum_bounds_over_the_family_s_kernels():
    from types import SimpleNamespace

    from port_bench import manifest
    from port_bench.run import layer_context

    launches = [("ce_fwd_train", 1e-4), ("ce_bwd", 2e-4), ("lstm_bwd", 3e-5)]
    c = SimpleNamespace(iw_chunk=lambda: 20, counts_of=lambda w, k: (4.0e9, launches))
    dev = [_ev("ce_bf16_kernel<true>(p)", 0, 250), _ev("ce_pack_wt_kernel(p)", 250, 50),
           _ev("ce_bwd_d_kernel(p)", 300, 100), _ev("ce_bwd_gemm_kernel<true>(p)", 400, 200),
           _ev("lstm_bwd_narrow_kernel<1>(p)", 600, 300), _ev("sm80_xmma_gemm_f32", 900, 100)]
    t = tracing.Trace(wall_s=1.25e-3, device=dev, runtime=[])
    cell = SimpleNamespace(name="x", traffic={"entry": "train"})
    w = SimpleNamespace(steps=2)
    ctx = layer_context(cell, c, w, t, {"ce_fwd_train": 1, "ce_bwd": 1, "lstm_bwd": 1})
    assert ctx.bounds == pytest.approx({"ce": 3e-4, "lstm": 3e-5, })
    assert ctx.family_s == pytest.approx({"ce": 600e-6, "lstm": 300e-6})
    read = {n: manifest.load_reader(n).read(ctx) for n in (
        "ce_roofline.train", "lstm_roofline.train", "idle_share.train", "mfu.train",
        "gemm_ms_per_step.train", "mfu.eval")}
    assert read["ce_roofline.train"] == pytest.approx(50.0)
    assert read["lstm_roofline.train"] == pytest.approx(10.0)
    assert read["idle_share.train"] == pytest.approx(20.0)
    assert read["mfu.train"] == pytest.approx(100 * 4.0e9 / (1.25e-3 * flops.PEAK_BF16))
    assert read["gemm_ms_per_step.train"] == pytest.approx(0.05)
    assert read["mfu.eval"] is None  # a reader with nothing to read returns nothing
    with pytest.raises(RuntimeError):  # the traced kernels must be the launches counted
        layer_context(cell, c, w, t, {"ce_fwd_train": 2, "ce_bwd": 1, "lstm_bwd": 1})
