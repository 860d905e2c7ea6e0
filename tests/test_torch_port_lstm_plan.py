"""Launch plans of the tensor-core LSTM kernels, held on the CPU.

``ops/lstm_cuda.py::infer_plan`` and ``bwd_plan`` compute the partition
that ``csrc/lstm_infer.cu`` and the bf16 path of ``csrc/lstm_bwd.cu`` run
with: the mma.sync plan (``MMAPlan``) below ``WIDE_MIN_ROWS`` rows, the
wide-row plan (``WidePlan``: wgmma, TMA, clusters of two) from there. At
the main paths' shapes (32 and 640 rows, H 1024) and odd ones, on an H100
SXM's 132 SMs and an H100 PCIe's 114 (where H 1024 needs 16 units per
block in the mma.sync plan), each plan must

- give every (row, unit) pair to exactly one (block, warp), as the
  kernels' index arithmetic (mirrored by ``plan_owners``) assigns it;
- fit one block's shared memory (232,448 bytes on the H100);
- fit the grid one block per SM (a cooperative launch needs every block
  resident);
- be one the kernel was built for: the pipeline depth, the warp limit and
  the (n_sub, m_group) instantiations read from the CUDA sources, and the
  plan arguments in the order the C entry point names them.

The wide-row kernels' index arithmetic is also run by a numpy model (the
swizzled operands, the wgmma accumulator layout, the multicast halves, the
K halves' exchange) and held against the plain versions.
"""
import dataclasses
import re

import numpy as np
import pytest

from vae_lagging_encoder_tpu_torch.ops import build, lstm_cuda

NSM = 132  # H100 SXM
NSM_PCIE = 114  # H100 PCIe
CSRC = build.CSRC_DIR


def _source(name):
    return (CSRC / name).read_text()


def _int_const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _entry_params(src, fn):
    """Names of the C entry point's parameters."""
    sig = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


@pytest.mark.parametrize("H", [32, 200, 1024])
@pytest.mark.parametrize("rows", [1, 20, 32, 37, 640])
@pytest.mark.parametrize("nsm", [NSM, NSM_PCIE])
@pytest.mark.parametrize("kind", ["infer", "bwd"])
def test_lstm_mma_plan(kind, nsm, rows, H):
    """The mma.sync plan (the one below ``WIDE_MIN_ROWS``)."""
    plan = (lstm_cuda.mma_infer_plan if kind == "infer" else lstm_cuda.mma_bwd_plan)(rows, H, nsm)
    assert (plan.kind, plan.rows, plan.H) == (kind, rows, H)
    # the fewest units per block that fit the grid on the SMs
    assert plan.n_sub == (1 if H <= 8 * nsm else 2)

    owners = lstm_cuda.plan_owners(plan)
    assert owners.shape == (rows * H, 3)
    assert (owners[:, 2] == 1).all(), "a (row, unit) pair is owned by no or several warps"
    assert (owners[:, 0] < plan.blocks).all() and (owners[:, 1] < plan.warps).all()
    assert owners[:, 0].min() >= 0 and owners[:, 1].min() >= 0

    assert plan.smem_bytes <= 232448
    assert plan.blocks <= nsm
    assert 1 <= plan.warps <= 16 and plan.threads == 32 * plan.warps
    assert plan.warps % plan.k_split == 0 and plan.k_chunk >= 1
    assert plan.ring_elems == 2 * plan.m_tiles * plan.k_steps * 256

    # the plan is one the kernel was written for
    src = _source("lstm_infer.cu" if kind == "infer" else "lstm_bwd.cu")
    macro = "LSTM_INFER_CASE" if kind == "infer" else "LSTM_BWD_CASE"
    built = {tuple(map(int, m)) for m in re.findall(rf"^\s*{macro}\((\d+), (\d+)\)", src, re.M)}
    variants = lstm_cuda.INFER_VARIANTS if kind == "infer" else lstm_cuda.BWD_VARIANTS
    assert built == set(variants)
    assert (plan.n_sub, plan.m_group) in built
    assert plan.stages == _int_const(src, "kStages") == lstm_cuda.MMA_STAGES
    assert plan.warps <= _int_const(_source("lstm_mma.cuh"), "kMaxWarps") == lstm_cuda.MAX_WARPS
    fn, names = (("lstm_infer", lstm_cuda.INFER_PLAN_ARGS) if kind == "infer"
                 else ("lstm_bwd_bf16", lstm_cuda.BWD_PLAN_ARGS))
    params = _entry_params(src, fn)
    assert params[-len(names) - 1:-1] == list(names) and params[-1] == "stream"
    assert len(plan.args()) == len(names) and all(isinstance(a, int) for a in plan.args())


@pytest.mark.parametrize("H", [200, 1024])
@pytest.mark.parametrize("rows", [20, 32, 37, 64, 640])
@pytest.mark.parametrize("nsm", [NSM, NSM_PCIE])
def test_lstm_residual_plan(nsm, rows, H):
    """The residual-saving forward (``save_residuals``) runs on
    ``csrc/lstm_infer.cu`` too: its mma.sync plan is a partition that fits, its
    (n_sub, m_group) is a built residual instantiation (LSTM_RESID_CASE),
    and up to 16 m-tiles (the training batch B 32, a short last batch of
    20) it is the plan of the forward without residuals."""
    plan = lstm_cuda.mma_infer_plan(rows, H, nsm, save_residuals=True)
    assert (plan.kind, plan.rows, plan.H) == ("infer", rows, H)
    assert plan.n_sub == (1 if H <= 8 * nsm else 2)
    owners = lstm_cuda.plan_owners(plan)
    assert (owners[:, 2] == 1).all(), "a (row, unit) pair is owned by no or several warps"
    assert plan.smem_bytes <= 232448 and plan.blocks <= nsm and 1 <= plan.warps <= 16
    src = _source("lstm_infer.cu")
    built = {tuple(map(int, m)) for m in re.findall(r"^\s*LSTM_RESID_CASE\((\d+), (\d+)\)", src,
                                                      re.M)}
    assert built == set(lstm_cuda.RESID_VARIANTS)
    assert (plan.n_sub, plan.m_group) in built
    if plan.m_tiles <= 16:
        assert plan == lstm_cuda.mma_infer_plan(rows, H, nsm)
    assert _entry_params(src, "lstm_infer")[-len(lstm_cuda.INFER_PLAN_ARGS) - 2] == \
        "save_residuals"


def test_lstm_mma_plan_main_paths():
    """The plans the main paths run, 128 blocks each: the IW decoder's 640
    rows (and ``--nsamples 40`` training's forward and backward) on the
    wide plan, two row groups of 320 rows (five m-tiles over two
    warpgroups), 16 units a block in clusters of two sharing h (the
    forward), 32 units a block split over a cluster's two K halves (the
    backward), four-deep rings; the encoder's 32 rows, and the training
    forward's (with residuals), as 16 warps of 8 units, two m-tile columns
    x 8 K slices; the training backward's 32 rows as one pass of two
    m-tiles, K split over the 16 warps."""
    iw, enc, bwd = (lstm_cuda.infer_plan(640, 1024, NSM), lstm_cuda.infer_plan(32, 1024, NSM),
                    lstm_cuda.bwd_plan(32, 1024, NSM))
    train = lstm_cuda.infer_plan(32, 1024, NSM, save_residuals=True)
    wide_fields = ("row_groups", "rows_per_group", "units", "k_slices", "cluster", "warpgroups",
                   "stages", "blocks", "m_tiles")
    assert tuple(getattr(iw, f) for f in wide_fields) == (2, 320, 16, 1, 2, 2, 4, 128, 5)
    assert lstm_cuda.infer_plan(640, 1024, NSM, save_residuals=True) == iw
    bwd640 = lstm_cuda.bwd_plan(640, 1024, NSM)
    assert tuple(getattr(bwd640, f) for f in wide_fields) == (2, 320, 32, 2, 2, 2, 4, 128, 5)
    assert np.all(lstm_cuda.plan_owners(bwd640)[:, 2] == 1)
    assert (enc.units_per_block, enc.blocks, enc.warps, enc.k_split) == (8, 128, 16, 8)
    assert train == enc and train.m_group == 1
    assert (bwd.units_per_block, bwd.blocks, bwd.warps, bwd.m_group) == (8, 128, 16, 2)
    assert np.all(lstm_cuda.plan_owners(bwd)[:, 2] == 1)


# ------------------------------------------------------------ wide-row plans
# csrc/lstm_infer.cu's and csrc/lstm_bwd.cu's wide-row kernels (namespace
# wide, csrc/lstm_wgmma.cuh), from lstm_cuda.WIDE_MIN_ROWS rows.
WIDE_NS = r"namespace wide \{(.*?)\}  // namespace wide"


def _wide_source(name):
    return re.search(WIDE_NS, _source(name), re.S).group(1)


def test_lstm_wide_constants_match_the_kernels():
    """The constants the plans assume, read back from the wide kernels: the
    deepest ring, the warpgroups, the units a block, the cluster, the
    backward's receive slot; the plan arguments in the order the C entry
    points name them."""
    for name, kind in (("lstm_infer.cu", "infer"), ("lstm_bwd.cu", "bwd")):
        src = _wide_source(name)
        assert _int_const(src, "kStages") == lstm_cuda.WIDE_STAGES
        assert _int_const(src, "kWarpgroups") == lstm_cuda.WIDE_WARPGROUPS
        assert _int_const(src, "kUnits") == lstm_cuda.WIDE_UNITS[kind]
        assert _int_const(src, "kCluster") == lstm_cuda.WIDE_CLUSTER
        fn = "lstm_infer_wide" if kind == "infer" else "lstm_bwd_wide"
        params = _entry_params(_source(name), fn)
        names = lstm_cuda.WIDE_PLAN_ARGS if kind == "infer" else lstm_cuda.WIDE_BWD_PLAN_ARGS
        assert params[-len(names) - 1:-1] == list(names) and params[-1] == "stream"
    recv = re.search(r"constexpr int kRecvBytes = (\d+) \* (\d+) \* (\d+);",
                     _wide_source("lstm_bwd.cu")).groups()
    assert np.prod([int(v) for v in recv]) == lstm_cuda.WIDE_RECV_BYTES
    assert _int_const(_source("lstm_wgmma.cuh"), "kTileRows") == lstm_cuda.WIDE_TILE_ROWS


@pytest.mark.parametrize("rows", [600, 640, 656])
@pytest.mark.parametrize("nsm", [NSM, NSM_PCIE])
@pytest.mark.parametrize("kind", ["infer", "resid", "bwd"])
def test_lstm_wide_plan(kind, nsm, rows):
    """At the IW decoder's and ``--nsamples`` training's 640 rows, a ragged
    600 and 656, H 1024: the wrappers pick the wide plan; it is a partition of
    the (row, unit) pairs, its clusters divide the grid, the grid fits the
    SMs and a block's shared memory fits; row groups are whole m-tiles."""
    H = 1024
    plan = (lstm_cuda.bwd_plan(rows, H, nsm) if kind == "bwd"
            else lstm_cuda.infer_plan(rows, H, nsm, save_residuals=kind == "resid"))
    assert isinstance(plan, lstm_cuda.WidePlan)
    assert (plan.kind, plan.rows, plan.H) == ("bwd" if kind == "bwd" else "infer", rows, H)
    owners = lstm_cuda.plan_owners(plan)
    assert owners.shape == (rows * H, 3)
    assert (owners[:, 2] == 1).all(), "a (row, unit) pair is owned by no or several warps"
    assert (owners[:, 0] < plan.blocks).all() and (owners[:, 1] < plan.warps).all()
    assert plan.blocks % plan.cluster == 0 and plan.blocks <= nsm
    assert plan.smem_bytes <= lstm_cuda.SMEM_MAX and 2 <= plan.stages <= lstm_cuda.WIDE_STAGES
    assert plan.rows_per_group % 64 == 0 and plan.row_groups == -(-rows // plan.rows_per_group)
    assert plan.ring_elems == 2 * plan.row_groups * plan.rows_per_group * plan.k_pad
    names = lstm_cuda.WIDE_BWD_PLAN_ARGS if kind == "bwd" else lstm_cuda.WIDE_PLAN_ARGS
    assert len(plan.args()) == len(names)
    # the backward receives every m-tile of a step in a slot of its own here
    assert plan.recv_slots == (plan.m_tiles if kind == "bwd" else 0)
    if nsm == NSM:  # two row groups of whole m-tiles
        assert plan.row_groups == 2 and plan.blocks == 128


def test_lstm_plan_bytes_per_step():
    """The per-step operand bytes, by hand, at 640 and 32 rows (H 1024, 132
    SMs). 640 rows: the mma.sync backward's 128 blocks each read all of
    da_t (640 x 4096 bf16 = 5,242,880 bytes; 671,088,640 over the grid); the
    wide backward's block reads 320 rows x its K half (1,310,720; x 128 =
    167,772,160), 4x below both. The forward: 1,310,720 a block and
    167,772,160 over the grid before; 320 rows x 1024 (655,360) a block,
    each tile read once for a cluster of two (41,943,040) now. 32 rows keep
    the mma.sync plans."""
    bwd_old = lstm_cuda.mma_bwd_plan(640, 1024, NSM)
    fwd_old = lstm_cuda.mma_infer_plan(640, 1024, NSM)
    bwd, fwd = lstm_cuda.bwd_plan(640, 1024, NSM), lstm_cuda.infer_plan(640, 1024, NSM)
    assert (bwd_old.sm_bytes_per_step, bwd_old.l2_bytes_per_step) == (5242880, 671088640)
    assert (fwd_old.sm_bytes_per_step, fwd_old.l2_bytes_per_step) == (1310720, 167772160)
    assert (bwd.sm_bytes_per_step, bwd.l2_bytes_per_step) == (1310720, 167772160)
    assert (fwd.sm_bytes_per_step, fwd.l2_bytes_per_step) == (655360, 41943040)
    assert 4 * bwd.sm_bytes_per_step <= bwd_old.sm_bytes_per_step
    assert 4 * bwd.l2_bytes_per_step <= bwd_old.l2_bytes_per_step
    b32, f32_ = lstm_cuda.bwd_plan(32, 1024, NSM), lstm_cuda.infer_plan(32, 1024, NSM)
    assert isinstance(b32, lstm_cuda.MMAPlan) and isinstance(f32_, lstm_cuda.MMAPlan)
    assert (b32.sm_bytes_per_step, b32.l2_bytes_per_step) == (262144, 33554432)
    assert (f32_.sm_bytes_per_step, f32_.l2_bytes_per_step) == (65536, 8388608)


# (rows, SMs, stages, receive slots, m-tiles a row group) of the backward at
# H 1024 where a slot for every m-tile stops fitting: 132 SMs hold two row
# groups, 114 one; from 17 m-tiles (from 1088 rows on 114 SMs) the plan
# keeps the four-deep ring and refills 8 slots
RECV_SHAPES = [(2048, NSM, 2, 16, 16), (2049, NSM, 4, 8, 17), (2112, NSM, 4, 8, 17),
               (1024, NSM_PCIE, 2, 16, 16), (1088, NSM_PCIE, 4, 8, 17),
               (2112, NSM_PCIE, 4, 8, 33)]


@pytest.mark.parametrize("rows,nsm,stages,slots,m_tiles", RECV_SHAPES)
def test_lstm_wide_bwd_plan_receive_slots(rows, nsm, stages, slots, m_tiles):
    """Above ``WIDE_MIN_ROWS`` every row count has a wide backward plan: a
    receive slot for each m-tile while that fits shared memory, else fewer
    slots, refilled within a step, beside the deepest ring."""
    plan = lstm_cuda.bwd_plan(rows, 1024, nsm)
    assert isinstance(plan, lstm_cuda.WidePlan)
    assert (plan.stages, plan.recv_slots, plan.m_tiles) == (stages, slots, m_tiles)
    assert plan.smem_bytes <= lstm_cuda.SMEM_MAX and plan.blocks <= nsm
    assert plan.recv_slots >= lstm_cuda.WIDE_WARPGROUPS
    more = dataclasses.replace(plan, recv_slots=plan.recv_slots + 1)
    assert plan.recv_slots == plan.m_tiles or more.smem_bytes > lstm_cuda.SMEM_MAX
    assert np.all(lstm_cuda.plan_owners(plan)[:, 2] == 1)


@pytest.mark.parametrize("kind", ["infer", "resid", "bwd"])
@pytest.mark.parametrize("H,nsm", [(1023, NSM), (2048, NSM), (1024, 32)])
def test_lstm_wide_plan_raises_where_none_fits(kind, H, nsm):
    """From ``WIDE_MIN_ROWS`` rows a shape no wide plan fits raises, with no
    fall back to the mma.sync plan: odd H, wh's slice beyond shared memory,
    fewer SMs than one row group's blocks (the backward's 64 at H 1024; the
    forward's 64 fit 32 SMs no better)."""
    if kind == "bwd":
        with pytest.raises(ValueError, match="no wide-row plan"):
            lstm_cuda.bwd_plan(640, H, nsm)
    else:
        with pytest.raises(ValueError, match="no wide-row plan"):
            lstm_cuda.infer_plan(640, H, nsm, save_residuals=kind == "resid")


def _slot_use(T, t, mt, mtb, R):
    """lstm_bwd.cu slot_use: the use of receive slot mt % R by m-tile mt of
    step t, which is the phase of the slot's barriers that it waits for."""
    return (T - 1 - t) * (-(-(mtb - mt % R) // R)) + mt // R


def _simulate_receive_slots(T, mtb, R, seed):
    """The wide backward's receive-slot protocol over one cluster, one actor
    per consumer warpgroup and epilogue warpgroup of each block (a
    warpgroup's 128 arrivals as one), run in a seeded random order: the
    mbarriers' phases and parity waits as the PTX ISA defines them
    (try_wait.parity p passes once the phase of parity p has completed:
    completed-phase count % 2 != p), and each step's grid barrier. Returns
    the (step, m-tile) sums each epilogue read, in order; raises on a
    deadlock or on a slot written before its last use was read."""
    rng = np.random.RandomState(seed)
    recycle = R < mtb
    done = {}  # (barrier, block, slot) -> completed phases (one arrival each)
    slot = {(b, j): None for b in range(2) for j in range(R)}
    got = {0: [], 1: []}

    def arrive(bar, b, j):
        done[bar, b, j] = done.get((bar, b, j), 0) + 1

    def wait(bar, b, j, parity):
        while done.get((bar, b, j), 0) % 2 == parity:
            yield

    def consumer(b, w, t):
        pk = 1 - b
        for mt in range(w, mtb, 2):
            j, use = mt % R, _slot_use(T, t, mt, mtb, R)
            if mt >= R:
                yield from wait("free", b, j, (use - 1) & 1)
            assert slot[pk, j] is None, f"slot {j} of block {pk} overwritten before it was read"
            slot[pk, j] = ("partial", t, mt)
            arrive("recv", pk, j)
            yield
            yield from wait("recv", b, j, use & 1)
            assert slot[b, j] == ("partial", t, mt), (slot[b, j], t, mt)
            slot[b, j] = ("sum", t, mt)
            arrive("epi", b, j)
            yield

    def epilogue(b, t):
        for mt in range(mtb):
            j = mt % R
            yield from wait("epi", b, j, _slot_use(T, t, mt, mtb, R) & 1)
            assert slot[b, j] == ("sum", t, mt), (slot[b, j], t, mt)
            got[b].append((t, mt))
            slot[b, j] = None
            if recycle:
                arrive("free", 1 - b, j)
            yield

    for t in range(T - 1, -1, -1):  # the grid barrier: every actor ends the step
        actors = [consumer(b, w, t) for b in range(2) for w in range(2)]
        actors += [epilogue(b, t) for b in range(2)]
        stalls = 0
        while actors:
            a = actors[rng.randint(len(actors))]
            before = dict(done), dict(slot)
            try:
                next(a)
            except StopIteration:
                actors.remove(a)
                stalls = 0
                continue
            stalls = 0 if (dict(done), dict(slot)) != before else stalls + 1
            if stalls > 200 * len(actors):
                raise AssertionError(f"deadlock in step {t}")
    return got


@pytest.mark.parametrize("mtb,R", [(5, 5), (16, 16), (17, 8), (33, 8), (3, 2), (9, 4), (7, 2)])
def test_lstm_wide_bwd_receive_slot_protocol(mtb, R):
    """Every epilogue reads each (step, m-tile) sum once, in order, and no
    slot is written again before it was read, in many orders of the actors:
    with a slot for every m-tile (the barriers' parity is the step's) and
    with fewer (a slot refilled within a step)."""
    T = 4
    want = [(t, mt) for t in range(T - 1, -1, -1) for mt in range(mtb)]
    for seed in range(12):
        got = _simulate_receive_slots(T, mtb, R, seed)
        assert got[0] == want and got[1] == want


@pytest.mark.parametrize("kind", ["infer", "bwd"])
def test_lstm_wide_threshold(kind):
    """Below ``WIDE_MIN_ROWS`` the mma.sync plan, from there the wide one."""
    key = "infer" if kind == "infer" else "bwd"
    plan = lstm_cuda.infer_plan if kind == "infer" else lstm_cuda.bwd_plan
    n = lstm_cuda.WIDE_MIN_ROWS[key]
    assert isinstance(plan(n - 1, 1024, NSM), lstm_cuda.MMAPlan)
    assert isinstance(plan(n, 1024, NSM), lstm_cuda.WidePlan)


# A numpy model of the wide kernels' index arithmetic: the B fill at
# swz_elem, TMA's SWIZZLE_128B tiles (the forward's in two multicast halves),
# the wgmma descriptors' reads, the accumulator layout, the epilogue's pairs,
# the row-major bf16 ring's slots, the backward's K halves and their
# exchange. It runs the kernels' steps on the CPU and is held against the
# plain versions.
def _sw128(addr):
    """The 128-byte swizzle on a shared-memory byte address (PTX ISA)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _swz_elem(r, k):
    """lstm_wgmma.cuh swz_elem: byte offset of bf16 (r, k) in a swizzled slab."""
    return r * 128 + ((((k >> 3) ^ (r & 7)) & 7) << 4) + (k & 7) * 2


def _bf16(x):
    import torch
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _desc_read(mem, start, rows):
    """The [rows, 64] operand a K-major SWIZZLE_128B descriptor at byte
    `start` reads over one slab (four k16 steps 32 bytes apart, 8-row groups
    1024 bytes apart), from `mem` holding one bf16 value per 2 bytes."""
    r, k = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    k16, kin = k // 16, k % 16
    addr = _sw128(start + 32 * k16 + (r >> 3) * 1024 + (r & 7) * 128 + 2 * kin)
    return mem[addr // 2]


def _tma_tile(src, r0, c0, rows):
    """A TMA box (rows x 64 bf16, SWIZZLE_128B) of `src` at (r0, c0), as
    bytes of a 1024-aligned tile: element (r, k) at sw128(r 128 + 2 k)."""
    mem = np.zeros(rows * 64, np.float32)
    r, k = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    mem[_sw128(r * 128 + 2 * k) // 2] = src[r0 + r, c0 + k]
    return mem


def _acc_map(n):
    """For the 128 threads of a warpgroup and their n / 2 registers of a
    m64nNk16 accumulator: (row, col) (PTX ISA, wgmma D fragments)."""
    lt, reg = np.meshgrid(np.arange(128), np.arange(n // 2), indexing="ij")
    lane = lt & 31
    i, h, e = reg >> 2, (reg >> 1) & 1, reg & 1
    return (lt >> 5) * 16 + (lane >> 2) + 8 * h, 8 * i + 2 * (lane & 3) + e


def _wide_fwd_model(xw, mask, wh, h0, c0, plan, save):
    T, R, H4 = xw.shape
    H, Hp, Rp, MP, UG = H4 // 4, plan.k_pad, plan.ring_rows, plan.rows_per_group, plan.unit_groups
    KS, kN = Hp // 64, 4 * plan.units
    ring = np.zeros((2 * Rp, Hp), np.float32)
    ring[Rp:Rp + R, :H] = _bf16(h0)
    hs, cs, gts = np.zeros((T, R, H)), np.zeros((T, R, H)), np.zeros((T, R, H4))
    hT, cT = np.zeros((R, H)), np.zeros((R, H))
    acc_row, acc_col = _acc_map(kN)
    lt = np.arange(128)
    wq, g8, tq = lt >> 5, (lt & 31) >> 2, lt & 3
    for t in range(T):
        new_ring = ring.copy()
        for b in range(plan.blocks):
            rg, ug = divmod(b, UG)
            u0, row0 = 16 * ug, rg * MP
            # B fill: idx -> k = idx / kN, q = (idx % kN) >> 4, j = idx & 15
            idx = np.arange(Hp * kN)
            k, q, j = idx // kN, (idx % kN) >> 4, idx & 15
            ok = (k < H) & (u0 + j < H)
            val = np.where(ok, wh[np.minimum(k, H - 1), np.minimum(q * H + u0 + j, H4 - 1)], 0)
            bmem = np.zeros(Hp * kN, np.float32)
            n = 8 * (2 * q + (j >> 3)) + (j & 7)
            bmem[((k // 64) * kN * 128 + _swz_elem(n, k % 64)) // 2] = val
            mtb = -(-max(0, min(MP, R - row0)) // 64)
            for mt in range(mtb):  # warpgroup mt % 2; the same work in either
                src_row = ((t + 1) & 1) * Rp + row0 + mt * 64
                p = np.zeros((64, kN))
                for ks in range(KS):
                    tile = np.zeros(64 * 64, np.float32)  # two multicast halves
                    for crank in range(2):
                        half = _tma_tile(ring, src_row + 32 * crank, ks * 64, 32)
                        tile[crank * 2048:(crank + 1) * 2048] = half
                    a = _desc_read(tile, 0, 64)
                    bb = _desc_read(bmem, ks * kN * 128, kN)
                    p += a.astype(np.float64) @ bb.T.astype(np.float64)
                acc = p[acc_row, acc_col]  # [128 threads, 32 registers]
                xs = np.zeros((4, 64, 16))
                xr = t * R + row0 + mt * 64 + np.arange(64)
                flat = xw.reshape(T * R, H4)
                for qq in range(4):
                    cols = qq * H + u0 + np.arange(16)
                    okr, okc = xr < T * R, cols < H4
                    xs[qq][np.ix_(okr, okc)] = flat[np.ix_(xr[okr], cols[okc])]
                for h in range(2):
                    row = row0 + mt * 64 + wq * 16 + g8 + 8 * h
                    rl = wq * 16 + g8 + 8 * h
                    rr = np.minimum(row, R - 1)
                    mk = np.where(row < R, mask[t, rr], 0)
                    for jh in range(2):
                        for e in range(2):
                            jj = 8 * jh + 2 * tq + e
                            unit = u0 + jj
                            okp = (row < R) & (unit < H)
                            uu = np.minimum(unit, H - 1)
                            r_ = 2 * h + e
                            pre = [xs[qq, rl, jj] + acc[lt, 4 * (2 * qq + jh) + r_] for qq in range(4)]
                            sg = lambda v: 1 / (1 + np.exp(-v))
                            act = [sg(pre[0]), sg(pre[1]), np.tanh(pre[2]), sg(pre[3])]
                            c_prev = (c0 if t == 0 else cT)[rr, uu]
                            h_prev = (h0 if t == 0 else hs[t - 1])[rr, uu]
                            c_raw = act[1] * c_prev + act[0] * act[2]
                            hk = mk * act[3] * np.tanh(c_raw) + (1 - mk) * h_prev
                            ck = mk * c_raw + (1 - mk) * c_prev
                            r2, u2 = row[okp], unit[okp]
                            hs[t, r2, u2], cT[r2, u2] = hk[okp], ck[okp]
                            cs[t, r2, u2] = ck[okp]
                            for qq in range(4):
                                gts[t, r2, qq * H + u2] = act[qq][okp]
                            if t == T - 1:
                                hT[r2, u2] = hk[okp]
                            new_ring[(t & 1) * Rp + r2, u2] = _bf16(hk[okp])
        ring = new_ring
    return (hs, cs, gts, hT, cT) if save else (hs, hT, cT)


def _wide_bwd_model(gates, mask, wh, c_prev, dhs, dhT, dcT, plan):
    T, B, H4 = gates.shape
    H, Kp, Rp, MP, UG = H4 // 4, plan.k_pad, plan.ring_rows, plan.rows_per_group, plan.unit_groups
    Kh = Kp // 2
    KS = Kh // 64
    ring = np.zeros((2 * Rp, Kp), np.float32)
    da = np.zeros((T, B, H4))
    dh0, dc0 = dhT.astype(np.float64).copy(), dcT.astype(np.float64).copy()
    acc_row, acc_col = _acc_map(32)
    lt = np.arange(128)
    wq, g8, tq = lt >> 5, (lt & 31) >> 2, lt & 3

    def pairs(row0, mt, kc, ii, h):
        row = row0 + mt * 64 + wq * 16 + g8 + 8 * h
        unit = 16 * kc + 8 * ii + 2 * tq
        return row, unit

    def cell(tc, row, unit, dh_in, dc_in):
        ig, fg, gg, og = (gates[tc, row, q * H + unit] for q in range(4))
        cp = c_prev[tc, row, unit]
        tanh_c = np.tanh(fg * cp + ig * gg)
        dhk = dh_in + dhs[tc, row, unit]
        m = mask[tc, row]
        dh_raw, dc_raw = m * dhk, m * dc_in
        dc_tot = dc_raw + dh_raw * og * (1 - tanh_c ** 2)
        a = [dc_tot * gg * ig * (1 - ig), dc_tot * cp * fg * (1 - fg), dc_tot * ig * (1 - gg * gg),
             dh_raw * tanh_c * og * (1 - og)]
        for q in range(4):
            da[tc, row, q * H + unit] = a[q]
            ring[(tc & 1) * Rp + row, q * H + unit] = _bf16(a[q])
        dh0[row, unit] = (1 - m) * dhk
        dc0[row, unit] = dc_tot * fg + (1 - m) * dc_in

    def blocks():
        for b in range(plan.blocks):
            pair, kc = divmod(b, 2)
            rg, ug = divmod(pair, UG)
            yield b, kc, rg * MP, 32 * ug

    for b, kc, row0, u0 in blocks():  # step T-1 from dhT, dcT
        for mt in range(-(-max(0, min(MP, B - row0)) // 64)):
            for h in range(2):
                for ii in range(2):
                    for e in range(2):
                        row, unit = pairs(row0, mt, kc, ii, h)
                        unit = u0 + unit + e
                        ok = (row < B) & (unit < H)
                        r, u = row[ok], unit[ok]
                        cell(T - 1, r, u, dhT[r, u].astype(np.float64), dcT[r, u].astype(np.float64))
    for t in range(T - 1, -1, -1):
        partial = {}
        for b, kc, row0, u0 in blocks():
            idx = np.arange(32 * Kh)
            n, k = idx // Kh, idx % Kh
            ok = (u0 + n < H) & (kc * Kh + k < H4)
            val = np.where(ok, wh[np.minimum(u0 + n, H - 1), np.minimum(kc * Kh + k, H4 - 1)], 0)
            bmem = np.zeros(32 * Kh, np.float32)
            bmem[((k // 64) * 32 * 128 + _swz_elem(n, k % 64)) // 2] = val
            for mt in range(-(-max(0, min(MP, B - row0)) // 64)):
                p = np.zeros((64, 32))
                for ks in range(KS):
                    tile = _tma_tile(ring, (t & 1) * Rp + row0 + mt * 64, kc * Kh + ks * 64, 64)
                    p += (_desc_read(tile, 0, 64).astype(np.float64)
                          @ _desc_read(bmem, ks * 32 * 128, 32).T.astype(np.float64))
                partial[b, mt] = p[acc_row, acc_col]  # [128 threads, 16 registers]
        for b, kc, row0, u0 in blocks():
            for mt in range(-(-max(0, min(MP, B - row0)) // 64)):
                acc, peer = partial[b, mt], partial[b ^ 1, mt]
                mine = acc[:, 8 * kc:8 * kc + 8]
                recv = peer[:, 8 * kc:8 * kc + 8]  # the peer's 'theirs': its registers of my half
                dsum = mine + recv
                for h in range(2):
                    for ii in range(2):
                        for e in range(2):
                            row, unit = pairs(row0, mt, kc, ii, h)
                            unit = u0 + unit + e
                            ok = (row < B) & (unit < H)
                            r, u = row[ok], unit[ok]
                            dh = dsum[ok, 4 * ii + 2 * h + e] + dh0[r, u]
                            if t > 0:
                                cell(t - 1, r, u, dh, dc0[r, u].copy())
                            else:
                                dh0[r, u] = dh
    return da, dh0, dc0


def _lstm_inputs(T, R, H, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn(T, R, 4 * H, generator=g)
    mask = (torch.rand(T, R, generator=g) > 0.25).float()
    wh = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / H ** 0.5).bfloat16()
    h0, c0 = 0.3 * torch.randn(R, H, generator=g), 0.3 * torch.randn(R, H, generator=g)
    return xw, mask, wh, h0, c0


# (rows, H, SMs): two row groups, the second short (and a block whose units
# are all past H); one group of three m-tiles (a warpgroup with two)
WIDE_MODEL_SHAPES = [(150, 40, 8), (150, 64, 132), (190, 32, 4)]


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("rows,H,nsm", WIDE_MODEL_SHAPES)
def test_lstm_wide_forward_model_matches_plain(rows, H, nsm, save):
    xw, mask, wh, h0, c0 = _lstm_inputs(3, rows, H, seed=rows + H)
    plan = lstm_cuda.wide_plan("infer", rows, H, nsm)
    assert isinstance(plan, lstm_cuda.WidePlan)
    got = _wide_fwd_model(xw.numpy(), mask.numpy(), wh.float().numpy(), h0.numpy(), c0.numpy(),
                          plan, save)
    ref = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, save)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b.numpy(), atol=2e-3, rtol=0)


@pytest.mark.parametrize("rows,H,nsm", WIDE_MODEL_SHAPES)
def test_lstm_wide_backward_model_matches_plain(rows, H, nsm):
    import torch
    xw, mask, wh, h0, c0 = _lstm_inputs(3, rows, H, seed=7 * rows + H)
    _, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
    c_prev = torch.cat([c0[None], cs[:-1]])
    g = torch.Generator().manual_seed(3)
    dhs = 0.3 * torch.randn(3, rows, H, generator=g)
    dhT, dcT = 0.3 * torch.randn(rows, H, generator=g), 0.3 * torch.randn(rows, H, generator=g)
    plan = lstm_cuda.wide_plan("bwd", rows, H, nsm)
    assert isinstance(plan, lstm_cuda.WidePlan)
    args = (gates, mask, wh, c_prev, dhs, dhT, dcT)
    got = _wide_bwd_model(*(a.float().numpy() for a in args), plan)
    ref = lstm_cuda.lstm_bwd_plain(*args)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-3, rtol=0)
