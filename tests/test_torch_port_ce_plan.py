"""Launch plan and index math of the bf16 CE kernel, held on the CPU.

``ops/ce_cuda.py::ce_plan`` computes the persistent schedule that
``csrc/ce_fwd.cu``'s tensor-core kernel runs, and the padded operand layout
the wrapper builds. At the main paths' shapes (N 3040 in training, 60800 in
the IW evaluation, nh 1024, V 20004), a ragged N and the CUDA tests' small
ones, on an H100 SXM's 132 SMs (66 clusters of two) and an H100 PCIe's 114
(57), each plan must

- fit one block's shared memory (232,448 bytes on the H100), and refuse a
  card without a cluster;
- give each cluster a contiguous, non-empty range of the (row group, vocab
  tile) units, covering every unit once, each row group's vocab tiles
  once, the clusters at about the same W^T columns at each step;
- give every (cluster, row group) segment its own partial slot, which the
  merge reads in segment order;
- give every row that TMA reads a 16-byte-aligned start, and every tile a
  1024-byte-aligned one (the 128-byte swizzle);
- be one the kernel was built for: its tile constants and the plan
  arguments in the order the C entry point names them.

Then a numpy model of the kernel: the TMA boxes of h and of W^T (each
block's multicast half) cover a ring slab once and are what the wgmma
descriptors read (the 128-byte swizzle as the PTX ISA defines it); each
(row, column) of a warpgroup's 64 x 256 tile belongs to exactly one (lane,
register) of the wgmma accumulators; the spill's transpose within a quad
gives each lane 8 consecutive columns; and the kernel's reductions
(per-lane online logsumexp over a segment's units, quad merge, the
segments' merge) reproduce ``ce_logp_plain``.
"""
import re

import numpy as np
import pytest
import torch

from vae_lagging_encoder_tpu_torch.ops import build, ce_cuda

NSM = 132  # H100 SXM
NSM_PCIE = 114  # H100 PCIe
SMEM_MAX = 232448
SRC = (build.CSRC_DIR / "ce_fwd.cu").read_text()
SHAPES = [(3040, 1024, 20004), (60800, 1024, 20004), (1000, 1024, 20004), (70, 40, 1100),
          (1, 40, 1100), (300, 36, 1300)]


def _int_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+)", SRC).group(1))


def test_ce_plan_constants_match_the_kernel():
    assert _int_const("kWarpgroups") == ce_cuda.CE_WARPGROUPS
    assert "kBM = 64 * kWarpgroups" in SRC
    for name, want in (("kBN", ce_cuda.CE_BLOCK_N), ("kBK", ce_cuda.CE_BLOCK_K)):
        assert re.search(rf"{name} = (\d+)", SRC).group(1) == str(want)
    assert _int_const("kStages") == ce_cuda.CE_STAGES
    assert _int_const("kCluster") == ce_cuda.CE_CLUSTER
    assert _int_const("kAlign") == ce_cuda.CE_ALIGN
    assert ce_cuda.CE_BLOCK_N == ce_cuda.CE_BWD_BLOCK_N  # W^T and the spill are ce_bwd's
    sig = re.search(r"int ce_fwd_bf16\(([^)]*)\)", SRC).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    names = list(ce_cuda.CE_PLAN_ARGS)
    assert params[-len(names) - 1:-1] == names and params[-1] == "stream"
    assert len(params) == len(ce_cuda._BF16_ARGTYPES)
    ints = {i for i, q in enumerate(sig.split(",")) if q.split()[0] == "int"}
    assert ints == {i for i, t in enumerate(ce_cuda._BF16_ARGTYPES) if t is ce_cuda.ctypes.c_int}
    # no cp.async path is left in the bf16 kernel: its copies are TMA's
    assert "cp.async.cg" not in SRC and "cp_async" not in SRC


@pytest.mark.parametrize("nsm", [NSM, NSM_PCIE])
@pytest.mark.parametrize("N,nh,V", SHAPES)
def test_ce_plan(N, nh, V, nsm):
    plan = ce_cuda.ce_plan(N, nh, V, nsm // 2)
    assert (plan.N, plan.nh, plan.V) == (N, nh, V)
    assert plan.block_m == 128 and plan.block_n == 256 and plan.cluster == 2
    assert plan.group_rows == 256 and plan.row_groups == -(-N // 256)
    assert plan.units == plan.row_groups * plan.vocab_tiles
    # the card's clusters, or one a unit where there are fewer units
    assert plan.clusters == min(nsm // 2, plan.units) and plan.blocks == 2 * plan.clusters
    assert plan.slots == plan.clusters + plan.row_groups - 1
    assert plan.part_shape == (4, plan.slots, 256)
    # shared memory: 1024 of slack, the ring of 48 KB slabs, 8 barriers
    assert plan.smem_bytes == 1024 + 4 * 48 * 1024 + 8 * 8 == 197696 <= SMEM_MAX
    assert plan.smem_bytes < 1 << 18  # the descriptor's 14-bit start address field
    # padded operands: W^T [Vp, Kp] (ce_bwd's Vp), spill [N, Vp]; every tile starts below V
    assert plan.Vp % 256 == 0 and 0 <= plan.Vp - V < 256
    assert plan.vocab_tiles * plan.block_n == plan.Vp
    assert plan.Kp % plan.block_k == 0 and 0 <= plan.Kp - nh < plan.block_k
    assert plan.ldh % 8 == 0 and 0 <= plan.ldh - nh < 8
    # 16-byte rows for TMA (h, W^T) and the spill's 16-byte stores; 1024-byte tiles
    assert (2 * plan.ldh) % 16 == 0 and (2 * plan.Kp) % 16 == 0 and (2 * plan.Vp) % 16 == 0
    assert (plan.box_bytes, plan.a_bytes, plan.b_bytes) == (8192, 16384, 32768)
    assert plan.stage_bytes % 1024 == 0
    # L2 -> shared: each block's rows of h every slab, W^T once a slab for both
    assert plan.l2_bytes == plan.units * (plan.Kp // 64) * (2 * 16384 + 32768)
    assert len(plan.args()) == len(ce_cuda.CE_PLAN_ARGS)
    assert all(isinstance(a, int) for a in plan.args())


def test_ce_plan_main_paths():
    """Training (N 3040): 12 row groups x 79 vocab tiles over 66 clusters
    (14 or 15 units each, so most row groups are split mid-vocab); IW (N
    60800): 238 row groups, 284 or 285 units a cluster; V 20004 pads to
    20224 for W^T and the spill; L2 -> shared bytes 1.0 / 19.7 GB (the
    blocks of 128 x 256 tiles without the multicast: 1.5 / 29 GB)."""
    train, iw = (ce_cuda.ce_plan(n, 1024, 20004, NSM // 2) for n in (3040, 60800))
    assert (train.row_groups, train.vocab_tiles, train.units, train.clusters) == (12, 79, 948, 66)
    assert (iw.row_groups, iw.units, iw.clusters, iw.slots) == (238, 18802, 66, 303)
    assert {b - a for a, b in map(train.unit_range, range(66))} == {14, 15}
    assert {b - a for a, b in map(iw.unit_range, range(66))} == {284, 285}
    assert (train.Vp, train.Kp, train.ldh, train.smem_bytes) == (20224, 1024, 1024, 197696)
    assert 0.99e9 < train.l2_bytes < 1.0e9 and 19.7e9 < iw.l2_bytes < 19.8e9


def test_ce_plan_refuses_what_no_card_holds():
    """A card that holds no cluster of two blocks has no plan: it raises.
    The shared memory is the ring's whatever nh (more K slabs, not more
    bytes a slab)."""
    assert ce_cuda.ce_plan(100, 4100, 500, 1).smem_bytes == 197696
    with pytest.raises(ValueError, match="no cluster"):
        ce_cuda.ce_plan(100, 1024, 500, 0)


@pytest.mark.parametrize("nsm", [NSM, NSM_PCIE])
@pytest.mark.parametrize("N,nh,V", SHAPES)
def test_ce_schedule_covers_each_unit_once(N, nh, V, nsm):
    """The clusters' ranges partition the units in order, none empty; each
    row group's vocab tiles are a permutation of its tiles; every segment
    has its own slot; at each step the clusters use few distinct W^T
    tiles."""
    plan = ce_cuda.ce_plan(N, nh, V, nsm // 2)
    nv, G = plan.vocab_tiles, plan.clusters
    ranges = [plan.unit_range(c) for c in range(G)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.units
    assert all(a < b for a, b in ranges) and all(ranges[c][1] == ranges[c + 1][0]
                                                 for c in range(G - 1))
    seen = np.zeros((plan.row_groups, nv), int)
    slots = []
    for c, (u0, u1) in enumerate(ranges):
        assert all(plan.cluster_of(u) == c for u in range(u0, u1))
        segs = plan.segments(c)
        assert segs[0][1] == u0 and segs[-1][2] == u1
        assert all(segs[k][2] == segs[k + 1][1] for k in range(len(segs) - 1))
        for rg, lo, hi in segs:
            assert rg * nv <= lo < hi <= (rg + 1) * nv
            slots.append(c + rg)
            for u in range(lo, hi):
                seen[rg, plan.vocab_tile(u)] += 1
    assert (seen == 1).all()
    assert len(set(slots)) == len(slots) and max(slots) < plan.slots
    # lockstep: the W^T tiles the clusters use at local step i; a row group
    # spans at most ceil(nv / L) + 1 clusters, each at its own offset, the
    # first one's part at a second one (with each group's tiles numbered
    # from its first unit, the clusters would be at up to 66 tiles of 79 at
    # N 3040)
    L = max(b - a for a, b in ranges)
    for i in range(0, L, max(1, L // 40)):
        tiles = {plan.vocab_tile(u0 + i) for u0, u1 in ranges if u0 + i < u1}
        assert len(tiles) <= 2 * (-(-nv // L) + 1), (i, sorted(tiles))


def test_ce_merge_runs_in_segment_order():
    """A row group's partials are merged in the order of its segments along
    the units (cluster order), at the slots the kernel wrote, for row groups
    split over one, two and several clusters."""
    for N, nh, V, clusters in ((3040, 1024, 20004, 66), (60800, 1024, 20004, 66),
                               (300, 36, 1300, 8), (257, 72, 2000, 5)):
        plan = ce_cuda.ce_plan(N, nh, V, clusters)
        written = {}
        for c in range(plan.clusters):
            for rg, lo, hi in plan.segments(c):
                assert c + rg not in written
                written[c + rg] = (rg, lo)
        split = 0
        for rg in range(plan.row_groups):
            order = plan.merge_order(rg)
            assert all(written[k][0] == rg for k in order)
            assert sorted(k for k in written if written[k][0] == rg) == sorted(order)
            los = [written[k][1] for k in order]
            assert los == sorted(los) and order == sorted(order)
            split += len(order) > 1
        assert split > 0


# ------------------------------------------------------------ index math
def _sw128(addr):
    """The 128-byte swizzle on a shared-memory byte address (PTX ISA, shared
    memory matrix layouts; TMA's SWIZZLE_128B): bits [4, 7) XOR bits [7, 10)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_box(dst, rows):
    """Byte address TMA writes element (r, k) of a rows x 64 bf16 box to, at
    a 1024-byte-aligned ``dst`` with SWIZZLE_128B: [r, k]."""
    r, k = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    return _sw128(dst + r * 128 + 2 * k)


def _desc_read(start, rows):
    """Byte address a K-major SWIZZLE_128B wgmma descriptor at ``start`` (8-row
    groups 1024 bytes apart, 128 bytes a row) reads element (r, kk) of its
    rows x 16 operand from: [r, kk]."""
    r, kk = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    return _sw128(start + (r >> 3) * 1024 + (r & 7) * 128 + 2 * kk)


@pytest.mark.parametrize("operand", ["h", "wt"])
def test_ce_tma_boxes_cover_each_tile_once(operand):
    """A ring slab is the block's 128 rows of h (two boxes of 64 rows x 64
    k at 0 and 8 KB; warpgroup w reads box w) and the 256-row W^T slab at
    16 KB: the two blocks' halves of 128 vocab rows, two boxes each (rank
    r's box q at 16 KB + (2 r + q) x 8 KB, multicast to both blocks). The
    six boxes cover the slab's bytes once, and for every k16 step the
    descriptors (start + 32 per k16) read each operand element where TMA
    wrote it."""
    plan = ce_cuda.ce_plan(3040, 1024, 20004, 66)
    stage = 1024 + 2 * plan.stage_bytes  # any slot of the aligned ring
    a_boxes = [stage + q * plan.box_bytes for q in range(2)]
    b_boxes = [stage + plan.a_bytes + (2 * r + q) * plan.box_bytes
               for r in range(ce_cuda.CE_CLUSTER) for q in range(2)]
    written = np.concatenate([_tma_box(dst, 64).ravel() for dst in a_boxes + b_boxes])
    assert sorted(written[::8]) == list(range(stage, stage + plan.stage_bytes, 16))
    for k16 in range(4):
        if operand == "h":  # warpgroup w's row r, k 16 k16 + kk: box w, its row r
            for w in range(ce_cuda.CE_WARPGROUPS):
                read = _desc_read(stage + w * plan.box_bytes + 32 * k16, 64)
                want = _tma_box(a_boxes[w], 64)[:, 16 * k16:16 * k16 + 16]
                assert np.array_equal(read, want)
        else:  # vocab row n of the slab, kk: box n // 64, its row n % 64
            read = _desc_read(stage + plan.a_bytes + 32 * k16, plan.block_n)
            want = np.concatenate([_tma_box(dst, 64)[:, 16 * k16:16 * k16 + 16]
                                   for dst in b_boxes])
            assert np.array_equal(read, want)
    # the ring and the barriers fit in the plan's shared memory
    assert 1023 + plan.stages * plan.stage_bytes + 8 * 2 * plan.stages <= plan.smem_bytes


BN = ce_cuda.CE_BLOCK_N


def _acc_owner():
    """(row, col) of accumulator register `reg` of lane `lane`, warp `warp`
    of a warpgroup (PTX ISA, wgmma .m64nNk16 D fragments), as the kernel's
    epilogue reads acc[4 i + 2 hh + e]."""
    warp, lane, reg = np.meshgrid(np.arange(4), np.arange(32), np.arange(BN // 2), indexing="ij")
    i, hh, e = reg >> 2, (reg >> 1) & 1, reg & 1
    row = warp * 16 + (lane >> 2) + 8 * hh
    col = 8 * i + 2 * (lane & 3) + e
    return row, col, lane


def test_ce_accumulator_layout_partitions_the_tile():
    row, col, lane = _acc_owner()
    flat = (row * BN + col).ravel()
    assert np.array_equal(np.sort(flat), np.arange(64 * BN))
    # the four lanes of one quad hold a whole row
    for r in (0, 9, 37, 63):
        sel = row == r
        assert np.unique(lane[sel] >> 2).size == 1 and np.unique(col[sel]).size == BN


def _quad_transpose(words):
    """csrc/ce_fwd.cu's quad_transpose on words [4 lanes, 4]: the shuffles
    (xor 2, then xor 1) and selects of the kernel, lane by lane."""
    w = [list(x) for x in words]
    for bit, pairs in ((2, ((0, 2), (1, 3))), (1, ((0, 1), (2, 3)))):
        # lane t sends x_j = w[t][lo_j] where bit is set in t, else w[t][hi_j]
        sent = [[w[t][lo] if t & bit else w[t][hi] for lo, hi in pairs] for t in range(4)]
        for t in range(4):
            got = sent[t ^ bit]
            for (lo, hi), x in zip(pairs, got):
                if t & bit:
                    w[t][lo] = x
                else:
                    w[t][hi] = x
    return w


def test_ce_spill_transpose_gives_each_lane_8_consecutive_columns():
    """Lane t of a quad holds, for a group a of 4 accumulator pairs, the bf16
    pairs of columns 8 (4a + k) + 2t, + 1 (k < 4); after the transpose it
    stores columns 8 (4a + t) .. + 7 in order at col0 + 32 a + 8 t: 16 bytes,
    and the quad's stores cover the tile's row once."""
    for a in range(BN // 32):
        cols = [[(8 * (4 * a + k) + 2 * t, 8 * (4 * a + k) + 2 * t + 1) for k in range(4)]
                for t in range(4)]
        out = _quad_transpose(cols)
        for t in range(4):
            flat = [c for pair in out[t] for c in pair]
            assert flat == list(range(32 * a + 8 * t, 32 * a + 8 * t + 8))
    # the kernel's shuffle distances and the select bits are these
    body = SRC[SRC.index("quad_transpose(uint32_t"):SRC.index("return make_uint4")]
    assert re.findall(r"__shfl_xor_sync\(0xffffffffu, \w+, (\d)\)", body) == ["2", "2", "1", "1"]


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy().astype(np.float64)


def _kernel_model(h, w, tgt, plan, save):
    """The kernel's reductions in numpy: bf16 operands; for each cluster's
    segment (row group), each lane's online (max, sum, sum of the rounded,
    target) over its columns of each unit's vocab tile, in the segment's
    order, masked past V; the quad merge into the segment's partial at slot
    c + rg; the merge of a row's partials in ``merge_order``."""
    N, V = h.shape[0], w.shape[1]
    R = plan.row_groups * plan.group_rows
    logits = np.zeros((R, plan.vocab_tiles * BN))
    logits[:N, :V] = _bf16(h).astype(np.float32) @ _bf16(w).astype(np.float32)
    tg = np.full(R, -1)
    tg[:N] = tgt
    part = np.full(plan.part_shape, np.nan)
    for c in range(plan.clusters):
        for rg, lo, hi in plan.segments(c):
            rows = slice(rg * plan.group_rows, (rg + 1) * plan.group_rows)
            m = np.full((plan.group_rows, 4), -np.inf)
            acc_s, acc_s2, acc_t = (np.zeros((plan.group_rows, 4)) for _ in range(3))
            for u in range(lo, hi):
                col0 = plan.vocab_tile(u) * BN
                # vals[n, lane tq, i, e] = tile[n, 8 i + 2 tq + e]
                vals = logits[rows, col0:col0 + BN].reshape(-1, BN // 8, 4, 2)
                vals = vals.transpose(0, 2, 1, 3)
                cols = col0 + (8 * np.arange(BN // 8)[None, :, None]
                               + 2 * np.arange(4)[:, None, None] + np.arange(2)[None, None, :])
                valid = cols < V
                lm = np.where(valid, vals, -np.inf).max(axis=(2, 3))
                acc_t += np.where(cols[None] == tg[rows, None, None, None], vals,
                                  0).sum(axis=(2, 3))
                upd = lm > -np.inf
                mn = np.maximum(m, lm)
                with np.errstate(invalid="ignore"):
                    ex = np.where(valid, np.exp(vals - mn[..., None, None]), 0).sum(axis=(2, 3))
                    ex2 = np.where(valid, np.exp(_bf16(vals) - mn[..., None, None]),
                                   0).sum(axis=(2, 3))
                    sc = np.where(np.isinf(m), 0.0, np.exp(m - mn))
                acc_s = np.where(upd, acc_s * sc + ex, acc_s)
                acc_s2 = np.where(upd, acc_s2 * sc + ex2, acc_s2)
                m = np.where(upd, mn, m)
            M = m.max(axis=1, keepdims=True)
            with np.errstate(invalid="ignore"):
                sc = np.where(np.isinf(m), 0.0, np.exp(m - M))
            slot = c + rg
            assert np.isnan(part[0, slot]).all()  # one segment a slot
            part[:, slot] = (M[:, 0], (acc_s * sc).sum(1), (acc_s2 * sc).sum(1), acc_t.sum(1))
    logp, lse = np.zeros(N), np.zeros(N)
    for n in range(N):
        rg, r = divmod(n, plan.group_rows)
        ps = np.array([part[:, slot, r] for slot in plan.merge_order(rg)])
        M = ps[:, 0].max()
        sc = np.exp(ps[:, 0] - M)
        l = M + np.log((ps[:, 1] * sc).sum())
        lse[n] = M + np.log((ps[:, 2] * sc).sum()) if save else l
        logp[n] = ps[:, 3].sum() - l
    return logp, lse, _bf16(logits[:N, :V])


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("N,nh,V,clusters", [(70, 40, 1100, 66), (300, 36, 1300, 8),
                                               (130, 64, 1026, 66), (257, 72, 2000, 5)])
def test_ce_kernel_model_matches_plain(N, nh, V, clusters, save):
    """Ragged N (a row group with one real row tile, and one with a single
    row), ragged K (nh 36, 40, 72), a ragged last vocab tile, one unit a
    cluster and many (segments that split a row group mid-vocab), the vocab
    tiles visited from each group's origin."""
    rng = np.random.RandomState(N + V)
    h = (rng.randn(N, nh) * 0.5).astype(np.float32)
    w = (rng.randn(nh, V) * 0.3).astype(np.float32)
    tgt = rng.randint(0, V, N).astype(np.int32)
    plan = ce_cuda.ce_plan(N, nh, V, clusters)
    if clusters < plan.units:  # a row group split between clusters mid-vocab
        assert any(len(plan.merge_order(rg)) > 1 for rg in range(plan.row_groups))
    logp, lse, spill = _kernel_model(h, w, tgt, plan, save)
    ref = ce_cuda.ce_logp_plain(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(tgt),
                                torch.bfloat16, save_logits=save)
    np.testing.assert_allclose(logp, ref[0].numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(lse, ref[1].numpy(), atol=1e-4, rtol=0)
    if save:  # the same logits may round to neighbouring bf16 values (one step)
        np.testing.assert_allclose(spill, ref[2].float().numpy(), rtol=2.0 ** -7, atol=1e-6)


# ------------------------------------------------- the f32-operand kernel
F32_SRC = (build.CSRC_DIR / "ce_f32.cu").read_text()
F32_SHAPES = [(3040, 1024, 20004), (60800, 1024, 20004), (1000, 1024, 20004), (70, 40, 1100),
              (129, 36, 1026), (1, 40, 1100), (300, 72, 1300)]


def _f32_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+)", F32_SRC).group(1))


def test_ce_f32_plan_constants_match_the_kernel():
    assert re.search(r"kBM = (\d+), kBN = (\d+), kBK = (\d+);", F32_SRC).groups() == tuple(
        str(x) for x in (ce_cuda.CE_F32_BLOCK_M, ce_cuda.CE_F32_BLOCK_N, ce_cuda.CE_F32_BLOCK_K))
    assert _f32_const("kStages") == ce_cuda.CE_F32_STAGES
    assert _f32_const("kConsumerWarps") == ce_cuda.CE_F32_WARPS
    assert _f32_const("kAlign") == ce_cuda.CE_ALIGN
    assert "kSmemBytes = kAlign + kStages * kStageBytes + 8 * 2 * kStages + kStateBytes" \
        in F32_SRC and "kStateBytes = 4 * 8 * kConsumers * 4;" in F32_SRC
    sig = re.search(r"int ce_fwd_f32\(([^)]*)\)", F32_SRC).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    names = list(ce_cuda.CE_F32_PLAN_ARGS)
    assert params[-len(names) - 1:-1] == names and params[-1] == "stream"
    assert len(params) == len(ce_cuda._F32_ARGTYPES)
    ints = {i for i, q in enumerate(sig.split(",")) if q.split()[0] == "int"}
    assert ints == {i for i, t in enumerate(ce_cuda._F32_ARGTYPES) if t is ce_cuda.ctypes.c_int}
    # f32 products on the FMA pipes: no tensor-core instruction, no bf16
    for instr in ("wgmma.mma_async", "mma.sync", "__nv_bfloat16", "ce_wgmma.cuh"):
        assert instr not in F32_SRC
    # the old SIMT design (a logits tile in shared memory, one block a row tile) is gone
    assert "ce_fwd_f32" not in SRC and "logits_tile" not in SRC and "ce_f32_kernel" not in SRC


@pytest.mark.parametrize("nsm", [NSM, NSM_PCIE])
@pytest.mark.parametrize("N,nh,V", F32_SHAPES)
def test_ce_f32_plan(N, nh, V, nsm):
    plan = ce_cuda.ce_f32_plan(N, nh, V, nsm)
    R, nv = -(-N // 128), -(-V // 128)
    assert (plan.row_tiles, plan.vocab_tiles) == (R, nv)
    assert 1 <= plan.band <= R and 1 <= plan.lanes <= nv and plan.blocks <= nsm
    assert plan.blocks == plan.band * plan.lanes
    assert plan.units == -(-R // plan.band) * plan.band * nv
    assert plan.band * plan.tile_bytes <= ce_cuda.CE_F32_L2_WINDOW or plan.band == 1
    # the busiest block within 1 % of the fewest units any grid gives
    fewest = min(-(-(-(-R // b)) * nv // l) for b in range(1, min(R, nsm) + 1)
                 for l in range(1, min(nv, nsm // b) + 1))
    assert plan.waves <= fewest * ce_cuda.CE_F32_WAVE_SLACK
    assert max(len(plan.block_units(c)) for c in range(plan.blocks)) <= plan.waves
    # shared memory: 1024 of slack, 4 slabs of h's 128 x 32 and W's 32 x 128 f32, 8
    # barriers, the running (m, s, t, target) of 8 rows of 256 threads
    assert plan.smem_bytes == 1024 + 4 * 32768 + 64 + 32768 == 164928 <= SMEM_MAX
    # rows of whole 16 bytes for TMA and the spill's 16-byte stores
    assert plan.ldh % 4 == 0 and 0 <= plan.ldh - nh < 4
    assert plan.ldw % 4 == 0 and 0 <= plan.ldw - V < 4
    assert plan.part_shape == (3, 2 * plan.lanes, R * 128)
    # L2 -> shared: each real unit's slabs of h and W
    assert plan.l2_bytes == R * nv * -(-nh // 32) * 32768
    assert len(plan.args()) == len(ce_cuda.CE_F32_PLAN_ARGS)
    assert all(isinstance(a, int) for a in plan.args())


def test_ce_f32_plan_main_paths():
    """Training (N 3040): 24 row tiles x 157 vocab tiles over 12 x 11
    blocks, 2 bands, 28 or 29 units a block; IW (N 60800): 475 row tiles
    over 4 x 33, 119 bands (the last with one empty row tile), 561 to 567
    units a block; W read from device memory once a band: 0.18 / 10.0 GB;
    L2 -> shared 3.95 / 78.2 GB."""
    train, iw = (ce_cuda.ce_f32_plan(n, 1024, 20004, NSM) for n in (3040, 60800))
    assert (train.band, train.lanes, train.bands, train.waves) == (12, 11, 2, 29)
    assert (iw.band, iw.lanes, iw.bands, iw.waves) == (4, 33, 119, 567)
    assert {len(train.block_units(c)) for c in range(132)} == {28, 29}
    # the blocks of the band's row 3 have one empty unit in each of the last band's waves
    assert {len(iw.block_units(c)) for c in range(132)} == {561, 562, 566, 567}
    assert (train.ldh, train.ldw, train.slabs) == (1024, 20004, 32)
    assert 0.17e9 < train.dram_bytes < 0.18e9 and 10.0e9 < iw.dram_bytes < 10.1e9
    assert 3.9e9 < train.l2_bytes < 4.0e9 and 78.1e9 < iw.l2_bytes < 78.3e9
    # 114 SMs: 19 x 6 blocks, 655 units (74,575 over 114: 654.2)
    assert ce_cuda.ce_f32_plan(60800, 1024, 20004, NSM_PCIE).args()[4:7] == (19, 6, 114)


def test_ce_f32_plan_refuses_what_no_card_holds():
    """A card that holds no block has no plan: it raises. The shared memory
    is the ring's whatever nh (more K slabs, not more bytes a slab)."""
    assert ce_cuda.ce_f32_plan(100, 4100, 500, 1).smem_bytes == 164928
    with pytest.raises(ValueError, match="no block"):
        ce_cuda.ce_f32_plan(100, 1024, 500, 0)


@pytest.mark.parametrize("nsm", [NSM, NSM_PCIE, 7])
@pytest.mark.parametrize("N,nh,V", F32_SHAPES)
def test_ce_f32_schedule_covers_each_unit_once(N, nh, V, nsm):
    """The blocks' units cover every (row tile, vocab tile) once; block c
    keeps row tile c % band of each band and vocab lane c // band; its
    units on one row tile are consecutive (one segment), and each (row
    tile, lane) has one segment; the blocks resident together work on
    about ``band`` row tiles and ``lanes`` vocab tiles at each step."""
    plan = ce_cuda.ce_f32_plan(N, nh, V, nsm)
    R, nv, G = plan.row_tiles, plan.vocab_tiles, plan.blocks
    seen = np.zeros((R, nv), int)
    owner = {}
    for c in range(G):
        units = plan.block_units(c)
        for rt, v in units:
            seen[rt, v] += 1
            assert rt % plan.band == c % plan.band
            assert plan.lane(rt, v) == c // plan.band
        segs = plan.segments(c)
        assert [rt for rt, _ in segs] == sorted({rt for rt, _ in units})
        for rt, vs in segs:
            assert (rt, c // plan.band) not in owner
            owner[rt, c // plan.band] = vs
            assert vs == sorted(vs) and all(b - a == plan.lanes for a, b in zip(vs, vs[1:]))
    assert (seen == 1).all()
    for rt in range(R):  # a row tile's segments: its lanes, split mid-row-tile where lanes > 1
        lanes = sorted(j for r, j in owner if r == rt)
        assert lanes == sorted(plan.merge_order(rt))
        assert [owner[rt, j][0] for j in plan.merge_order(rt)] == list(range(len(lanes)))
    for step in range(plan.waves):
        rows = {plan.unit(u)[0] for u in range(step * G, min((step + 1) * G, plan.units))}
        cols = {plan.unit(u)[1] for u in range(step * G, min((step + 1) * G, plan.units))}
        # (a step that crosses into the next band holds the ends of both)
        assert len(rows) <= 2 * plan.band and len(cols) <= plan.lanes + 2


def test_ce_f32_thread_layout_and_shared_loads():
    """csrc/ce_f32.cu's consumer threads: warp w, lane l is (ty, tx) = (4 (w %
    4) + l / 8, 8 (w / 4) + l % 8), the 256 threads cover 16 x 16 once, and
    thread rows 16 i + ty cover the tile's 128 rows. Each 16-byte load of h
    (row 16 i + ty, k 4q .. 4q + 3) reads where TMA's 128-byte swizzle put
    those k, and the warp's 4 distinct addresses of a load fall in distinct
    bank groups; each 16-byte load of W reads 8 distinct consecutive 16-byte
    chunks (128 bytes): one wavefront a load."""
    warp, lane = np.meshgrid(np.arange(8), np.arange(32), indexing="ij")
    ty, tx = 4 * (warp % 4) + lane // 8, 8 * (warp // 4) + lane % 8
    assert np.array_equal(np.sort((16 * ty + tx).ravel()), np.arange(256))
    assert np.array_equal(np.sort((16 * np.arange(8)[:, None] + np.arange(16)).ravel()),
                          np.arange(128))
    assert "ty = 4 * (warp & 3) + (lane >> 3), tx = 8 * (warp >> 2) + (lane & 7)" in F32_SRC
    assert "return 16 * i + ty;" in F32_SRC
    a_off = (ty * 128) | ((ty & 7) << 4)  # the kernel's per-thread base
    for i in range(8):
        for q in range(8):
            addr = (a_off ^ (q << 4)) + i * 16 * 128  # [warp, lane]
            row = 16 * i + ty
            assert np.array_equal(addr, _sw128(row * 128 + 16 * q))
            for w in range(8):
                uniq = np.unique(addr[w])
                assert uniq.size == 4 and np.unique((uniq >> 4) & 7).size == 4
    b_addr = 16 * tx  # W's chunk of columns 4 tx .. + 3 at one k (and + 256 bytes)
    for w in range(8):
        uniq = np.unique(b_addr[w])
        assert uniq.size == 8 and uniq.max() - uniq.min() == 7 * 16


def _f32_kernel_model(h, w, tgt, plan, save):
    """The f32 kernel's reductions in numpy (f32 operands): for each block's
    segment, each thread's online (max, sum, target) per row over its
    columns (4 tx + j, 64 + 4 tx + j) of each unit's vocab tile, in the
    segment's order, masked past V; the row's threads of each warp (tx 0-7,
    8-15) merged into the segment's partials at part[:, 2 lane + half, row];
    the merge of a row's partials in ``merge_order``, each lane's two halves
    in turn; the spill [N, ldw] with the logits below V."""
    N, V = h.shape[0], w.shape[1]
    R, BM, BN = plan.row_tiles, plan.block_m, plan.block_n
    logits = np.zeros((R * BM, plan.vocab_tiles * BN))
    logits[:N, :V] = h.astype(np.float32) @ w.astype(np.float32)
    tg = np.full(R * BM, -1)
    tg[:N] = tgt
    tx = np.arange(16)
    cols = np.concatenate([4 * tx[:, None] + np.arange(4), 64 + 4 * tx[:, None] + np.arange(4)],
                          axis=1)  # [thread tx, its 8 columns]
    part = np.full(plan.part_shape, np.nan)
    spill = np.full((N, plan.ldw), np.nan)
    for c in range(plan.blocks):
        lane = c // plan.band
        for rt, vs in plan.segments(c):
            rows = slice(rt * BM, (rt + 1) * BM)
            m = np.full((BM, 16), -np.inf)
            s, t = np.zeros((BM, 16)), np.zeros((BM, 16))
            for v in vs:
                cc = v * BN + cols  # [16, 8]
                vals = logits[rows][:, cc]  # [rows, 16, 8]
                if save:
                    r_real = min(BM, N - rt * BM)
                    for k in range(2):  # the 16-byte stores of column quads that start below V
                        for q in range(16):
                            c0 = cc[q, 4 * k]
                            if c0 < V:
                                spill[rt * BM:rt * BM + r_real, c0:c0 + 4] = \
                                    vals[:r_real, q, 4 * k:4 * k + 4]
                vals = np.where(cc[None] < V, vals, -np.inf)
                t += np.where(cc[None] == tg[rows, None, None], vals, 0).sum(-1)
                lm = vals.max(-1)
                upd = lm > -np.inf
                mn = np.maximum(m, lm)
                with np.errstate(invalid="ignore"):
                    ex = np.exp(vals - mn[..., None]).sum(-1)
                    sc = np.where(np.isinf(m), 0.0, np.exp(m - mn))
                s = np.where(upd, s * sc + ex, s)
                m = np.where(upd, mn, m)
            for half in range(2):
                hs = slice(8 * half, 8 * half + 8)
                Mh = m[:, hs].max(1, keepdims=True)
                with np.errstate(invalid="ignore"):
                    sc = np.where(np.isinf(m[:, hs]), 0.0, np.exp(m[:, hs] - Mh))
                slot = 2 * lane + half
                assert np.isnan(part[0, slot, rows]).all()  # one segment a (lane, row tile)
                part[:, slot, rows] = (Mh[:, 0], (s[:, hs] * sc).sum(1), t[:, hs].sum(1))
    logp, lse = np.zeros(N), np.zeros(N)
    for n in range(N):
        ps = np.array([part[:, 2 * j + half, n] for j in plan.merge_order(n // BM)
                       for half in range(2)])
        M = ps[:, 0].max()
        lse[n] = M + np.log((ps[:, 1] * np.exp(ps[:, 0] - M)).sum())
        logp[n] = ps[:, 2].sum() - lse[n]
    return logp, lse, spill[:, :V]


def _jax_f32_ce(h, w, tgt, save):
    """The JAX package's kernel with full-precision operands
    (``mxu_dtype=None``) in interpret mode, rows padded to its block of 8 as
    ``fused_ce_logp`` pads them: (logp, lse, logits [N, V] or None)."""
    import jax.numpy as jnp
    from vae_lagging_encoder_tpu.ops.ce_pallas import _ce_forward

    N, pad = h.shape[0], -h.shape[0] % 8
    hp = np.pad(h, ((0, pad), (0, 0)))
    tp = np.pad(tgt, (0, pad))
    logp, lse, logits = _ce_forward(jnp.asarray(hp), jnp.asarray(w), jnp.asarray(tp), block_n=8,
                                    block_v=1024, mxu_dtype=None, interpret=True,
                                    save_logits=save)
    return (np.asarray(logp)[:N], np.asarray(lse)[:N],
            np.asarray(logits)[:N, :w.shape[1]] if save else None)


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("N,nh,V,blocks", [(70, 40, 1100, 132), (129, 36, 1026, 132),
                                           (300, 72, 1300, 7), (257, 36, 1030, 5)])
def test_ce_f32_kernel_model_matches_plain_and_jax(N, nh, V, blocks, save):
    """Ragged N (129 and 257: one row in the last tile), nh not a multiple of
    the 32-deep K slab (36, 40, 72), V neither a multiple of the 128-wide
    tile nor of 4 (1026, 1030; 1100 and 1300 past the tile), segments that
    split a row tile between lanes (every plan here), a row tile with lanes
    of one tile and of two, several bands. Against ``ce_logp_plain`` with
    f32 operands and the JAX package's kernel with ``mxu_dtype=None``."""
    rng = np.random.RandomState(N + V + save)
    h = (rng.randn(N, nh) * 0.5).astype(np.float32)
    w = (rng.randn(nh, V) * 0.3).astype(np.float32)
    tgt = rng.randint(0, V, N).astype(np.int32)
    tgt[0], tgt[-1] = 0, V - 1
    plan = ce_cuda.ce_f32_plan(N, nh, V, blocks)
    assert plan.lanes > 1 and any(len(plan.segments(c)) > 1 for c in range(plan.blocks)) \
        or blocks == 132
    logp, lse, spill = _f32_kernel_model(h, w, tgt, plan, save)
    ref = ce_cuda.ce_logp_plain(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(tgt),
                                None, save_logits=save)
    jl, jlse, jlogits = _jax_f32_ce(h, w, tgt, save)
    for got in (logp, lse):
        assert np.isfinite(got).all()
    for a, b in ((logp, ref[0].numpy()), (lse, ref[1].numpy()), (logp, jl), (lse, jlse)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    if save:  # f32 logits are their own rounding: lse of the spill is lse
        assert not np.isnan(spill).any()
        np.testing.assert_allclose(spill, ref[2].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(spill, jlogits, atol=1e-5, rtol=0)
