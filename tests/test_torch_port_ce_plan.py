"""Launch plan and index math of the bf16 CE kernel, held on the CPU.

``ops/ce_cuda.py::ce_plan`` computes the grid that ``csrc/ce_fwd.cu``'s
tensor-core kernel runs with, and the padded operand layout the wrapper
builds. At the main paths' shapes (N 3040 in training, 60800 in the IW
evaluation, nh 1024, V 20004), a ragged N and the CUDA tests' small ones,
on an H100 SXM's 132 SMs and an H100 PCIe's 114, each plan must

- fit one block's shared memory (232,448 bytes on the H100) and one wave;
- split the vocab tiles of every row tile into ranges that partition
  [0, Vp), none empty;
- give every row that TMA or cp.async reads a 16-byte-aligned start, and
  every slab a 1024-byte-aligned one (the 128-byte swizzle);
- be one the kernel was built for: its tile constants and the plan
  arguments in the order the C entry point names them.

Then a numpy model of the kernel: the swizzled slab addresses the loader
writes are a bijection and are what the wgmma descriptor reads (the
128-byte swizzle as the PTX ISA defines it), each (row, column) of the
128 x 256 tile belongs to exactly one (warpgroup, lane, register) of the
wgmma accumulators, and the kernel's reductions (per-lane online
logsumexp, quad merge, the splits' merge) reproduce ``ce_logp_plain``.
"""
import re

import numpy as np
import pytest
import torch

from vae_lagging_encoder_tpu_torch.ops import build, ce_cuda

NSM = 132  # H100 SXM
NSM_PCIE = 114  # H100 PCIe
SRC = (build.CSRC_DIR / "ce_fwd.cu").read_text()
SHAPES = [(3040, 1024, 20004), (60800, 1024, 20004), (1000, 1024, 20004), (70, 40, 1100),
          (1, 40, 1100), (300, 36, 1300)]


def _int_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+)", SRC).group(1))


def test_ce_plan_constants_match_the_kernel():
    assert _int_const("kWarpgroups") == ce_cuda.CE_WARPGROUPS
    assert re.search(r"kBN = (\d+)", SRC).group(1) == str(ce_cuda.CE_BLOCK_N)
    assert re.search(r"kBK = (\d+)", SRC).group(1) == str(ce_cuda.CE_BLOCK_K)
    assert _int_const("kStages") == ce_cuda.CE_STAGES
    assert _int_const("kAlign") == ce_cuda.CE_ALIGN
    sig = re.search(r"int ce_fwd_bf16\(([^)]*)\)", SRC).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    names = list(ce_cuda.CE_PLAN_ARGS)
    assert params[-len(names) - 1:-1] == names and params[-1] == "stream"
    assert len(params) == len(ce_cuda._BF16_ARGTYPES)


@pytest.mark.parametrize("nsm", [NSM, NSM_PCIE])
@pytest.mark.parametrize("N,nh,V", SHAPES)
def test_ce_plan(N, nh, V, nsm):
    plan = ce_cuda.ce_plan(N, nh, V, nsm)
    assert (plan.N, plan.nh, plan.V) == (N, nh, V)
    assert plan.smem_bytes == plan.stages * plan.stage_bytes + 1024 <= 232448
    assert plan.block_m == 128
    # one wave: splits only while there are fewer row tiles than SMs
    if plan.row_tiles >= nsm:
        assert plan.splits == 1
    else:
        assert plan.blocks <= nsm
        assert plan.splits == min(plan.vocab_tiles, nsm // plan.row_tiles)
    assert plan.blocks == plan.row_tiles * plan.splits
    # the splits' vocab ranges partition [0, Vp), none empty
    ranges = [plan.vocab_range(s) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.vocab_tiles
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    cols = np.concatenate([np.arange(a * plan.block_n, b * plan.block_n) for a, b in ranges])
    assert np.array_equal(cols, np.arange(plan.Vp))
    # padded operands: W^T [Vp, Kp], spill [N, Vp]; every tile starts below V
    assert plan.Vp % plan.block_n == 0 and 0 <= plan.Vp - V < plan.block_n
    assert plan.Kp % plan.block_k == 0 and 0 <= plan.Kp - nh < plan.block_k
    assert plan.ldh % 8 == 0 and 0 <= plan.ldh - nh < 8
    # 16-byte rows for cp.async (h, W^T) and the spill's packed pairs;
    # 1024-byte slabs and warpgroup parts for the swizzle
    assert (2 * plan.ldh) % 16 == 0 and (2 * plan.Kp) % 16 == 0 and (2 * plan.Vp) % 16 == 0
    assert plan.stage_bytes % 1024 == 0 and (plan.block_m * 128) % 1024 == 0
    assert plan.smem_bytes < 1 << 18  # the descriptor's 14-bit start address field
    assert len(plan.args()) == len(ce_cuda.CE_PLAN_ARGS)
    assert all(isinstance(a, int) for a in plan.args())


def test_ce_plan_main_paths():
    """Training (N 3040): 24 row tiles x 5 vocab splits, 120 blocks in one
    wave; IW (N 60800): 475 row tiles, no split; V 20004 pads to 20224."""
    train, iw = ce_cuda.ce_plan(3040, 1024, 20004, NSM), ce_cuda.ce_plan(60800, 1024, 20004, NSM)
    assert (train.row_tiles, train.splits, train.blocks) == (24, 5, 120)
    assert (iw.row_tiles, iw.splits, iw.blocks) == (475, 1, 475)
    assert (train.Vp, train.Kp, train.ldh, train.vocab_tiles) == (20224, 1024, 1024, 79)


# ------------------------------------------------------------ index math
def _swz(r, c):
    """The loader's byte offset of 16-byte chunk c of row r (ce_fwd.cu swz)."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def _sw128(addr):
    """The 128-byte swizzle on a shared-memory byte address (PTX ISA, shared
    memory matrix layouts): bits [4, 7) XOR bits [7, 10)."""
    return addr ^ (((addr >> 7) & 7) << 4)


@pytest.mark.parametrize("rows", [pytest.param(64 * ce_cuda.CE_WARPGROUPS, id="h_slab"),
                                  pytest.param(ce_cuda.CE_BLOCK_N, id="w_slab")])
def test_ce_loader_covers_each_chunk_once(rows):
    """Thread t copies chunk t & 7 of rows t / 8 + 32 u at the kernel's
    offset swz(t / 8, t & 7) + 4096 u: that is the swizzled place of (row,
    chunk), and the threads cover every 16-byte chunk of the slab once."""
    t, u = np.meshgrid(np.arange(2 * 64 * ce_cuda.CE_WARPGROUPS), np.arange(rows // 32),
                       indexing="ij")
    r, c = (t >> 3) + 32 * u, t & 7
    off = _swz(t >> 3, t & 7) + 4096 * u
    assert np.array_equal(off, _swz(r, c))
    assert sorted(off.ravel()) == list(range(0, rows * 128, 16))


def test_ce_descriptor_reads_what_the_loader_wrote():
    """For each warpgroup's A part and the B slab, k16 step and (row, k):
    the address a K-major SWIZZLE_128B descriptor (start + 32 per k16 step,
    8-row groups 1024 bytes apart, 128 bytes a row) makes the hardware read
    equals the address the loader wrote that element to."""
    base = 3 * 1024 * 48  # any 1024-aligned stage
    for part_base, rows in [(base, 64), (base + 64 * 128, 64),
                            (base + 128 * 128, ce_cuda.CE_BLOCK_N)]:
        r, k16, kin = np.meshgrid(np.arange(rows), np.arange(4), np.arange(16), indexing="ij")
        start = part_base + 32 * k16
        read = _sw128(start + (r >> 3) * 1024 + (r & 7) * 128 + 2 * kin)
        k = 16 * k16 + kin
        row_in_slab = r + (part_base - base) // 128
        written = base + _swz(row_in_slab, k >> 3) + 2 * (k & 7)
        assert np.array_equal(read, written)


BN = ce_cuda.CE_BLOCK_N


def _acc_owner():
    """(row, col) of accumulator register `reg` of lane `lane`, warp `warp`
    of warpgroup `wg` (PTX ISA, wgmma .m64nNk16 D fragments), as the
    kernel's epilogue reads acc[4 i + 2 hh + e]."""
    wg, warp, lane, reg = np.meshgrid(np.arange(2), np.arange(4), np.arange(32),
                                      np.arange(BN // 2), indexing="ij")
    i, hh, e = reg >> 2, (reg >> 1) & 1, reg & 1
    row = wg * 64 + warp * 16 + (lane >> 2) + 8 * hh
    col = 8 * i + 2 * (lane & 3) + e
    return row, col, lane


def test_ce_accumulator_layout_partitions_the_tile():
    row, col, lane = _acc_owner()
    flat = (row * BN + col).ravel()
    assert np.array_equal(np.sort(flat), np.arange(128 * BN))
    # the four lanes of one quad hold a whole row
    for r in (0, 9, 77, 127):
        sel = row == r
        assert np.unique(lane[sel] >> 2).size == 1 and np.unique(col[sel]).size == BN


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy().astype(np.float64)


def _kernel_model(h, w, tgt, plan, save):
    """The kernel's reductions in numpy: bf16 operands, each lane's online
    (max, sum, sum of the rounded, target) over its columns of each vocab
    tile of its split, masked past V; the quad merge; the splits' merge."""
    N, V = h.shape[0], w.shape[1]
    logits = np.zeros((N, plan.Vp))
    logits[:, :V] = _bf16(h).astype(np.float32) @ _bf16(w).astype(np.float32)
    parts = []
    for s in range(plan.splits):
        m = np.full((N, 4), -np.inf)
        acc_s, acc_s2, acc_t = np.zeros((N, 4)), np.zeros((N, 4)), np.zeros((N, 4))
        t0, t1 = plan.vocab_range(s)
        for jt in range(t0, t1):
            col0 = jt * BN
            # vals[n, lane tq, i, e] = tile[n, 8 i + 2 tq + e]
            vals = logits[:, col0:col0 + BN].reshape(N, BN // 8, 4, 2).transpose(0, 2, 1, 3)
            cols = col0 + (8 * np.arange(BN // 8)[None, :, None] + 2 * np.arange(4)[:, None, None]
                           + np.arange(2)[None, None, :])
            valid = cols < V
            lm = np.where(valid, vals, -np.inf).max(axis=(2, 3))
            acc_t += np.where(cols[None] == tgt[:, None, None, None], vals, 0).sum(axis=(2, 3))
            upd = lm > -np.inf
            mn = np.maximum(m, lm)
            with np.errstate(invalid="ignore"):
                ex = np.where(valid, np.exp(vals - mn[..., None, None]), 0).sum(axis=(2, 3))
                ex2 = np.where(valid, np.exp(_bf16(vals) - mn[..., None, None]), 0).sum(axis=(2, 3))
                sc = np.where(np.isinf(m), 0.0, np.exp(m - mn))
            acc_s = np.where(upd, acc_s * sc + ex, acc_s)
            acc_s2 = np.where(upd, acc_s2 * sc + ex2, acc_s2)
            m = np.where(upd, mn, m)
        M = m.max(axis=1, keepdims=True)
        sc = np.where(np.isinf(m), 0.0, np.exp(m - M))
        parts.append((M[:, 0], (acc_s * sc).sum(1), (acc_s2 * sc).sum(1), acc_t.sum(1)))
    Ms = np.stack([p[0] for p in parts])
    M = Ms.max(0)
    sc = np.exp(Ms - M)
    ssum = (np.stack([p[1] for p in parts]) * sc).sum(0)
    ssum2 = (np.stack([p[2] for p in parts]) * sc).sum(0)
    t = np.stack([p[3] for p in parts]).sum(0)
    l = M + np.log(ssum)
    lse = M + np.log(ssum2) if save else l
    return t - l, lse, _bf16(logits[:, :V])


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("N,nh,V,nsm", [(70, 40, 1100, NSM), (300, 36, 1300, 8),
                                          (130, 64, 1026, NSM), (257, 72, 2000, 3)])
def test_ce_kernel_model_matches_plain(N, nh, V, nsm, save):
    """Ragged N, ragged K (nh 36, 40, 72), a ragged last vocab tile, one and
    many splits (a split of one tile whose last lanes see no real column)."""
    rng = np.random.RandomState(N + V)
    h = (rng.randn(N, nh) * 0.5).astype(np.float32)
    w = (rng.randn(nh, V) * 0.3).astype(np.float32)
    tgt = rng.randint(0, V, N).astype(np.int32)
    plan = ce_cuda.ce_plan(N, nh, V, nsm)
    logp, lse, spill = _kernel_model(h, w, tgt, plan, save)
    ref = ce_cuda.ce_logp_plain(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(tgt),
                                torch.bfloat16, save_logits=save)
    np.testing.assert_allclose(logp, ref[0].numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(lse, ref[1].numpy(), atol=1e-4, rtol=0)
    if save:  # the same logits may round to neighbouring bf16 values (one step)
        np.testing.assert_allclose(spill, ref[2].float().numpy(), rtol=2.0 ** -7, atol=1e-6)
