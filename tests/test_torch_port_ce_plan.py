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
