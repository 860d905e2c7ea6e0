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
    backward), four-deep rings. The 32-row main paths run the narrow plans
    (test_lstm_narrow_plan_main_paths); the mma.sync plans at 32 rows, which
    the narrow ones replaced there and which serve the rows no narrow plan
    fits: the encoder's and the training forward's (with residuals) as 16
    warps of 8 units, two m-tile columns x 8 K slices; the training
    backward's as one pass of two m-tiles, K split over the 16 warps."""
    iw = lstm_cuda.infer_plan(640, 1024, NSM)
    enc, bwd = lstm_cuda.mma_infer_plan(32, 1024, NSM), lstm_cuda.mma_bwd_plan(32, 1024, NSM)
    train = lstm_cuda.mma_infer_plan(32, 1024, NSM, save_residuals=True)
    assert isinstance(lstm_cuda.infer_plan(32, 1024, NSM), lstm_cuda.NarrowPlan)
    assert isinstance(lstm_cuda.bwd_plan(32, 1024, NSM), lstm_cuda.NarrowPlan)
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
    each tile read once for a cluster of two (41,943,040) now. 32 rows: the
    mma.sync plans' (every block reading all of the operand) against the
    narrow plans' that replaced them (the forward's h tile read once a
    cluster of two; the backward's da_t split between the two blocks of a
    cluster)."""
    bwd_old = lstm_cuda.mma_bwd_plan(640, 1024, NSM)
    fwd_old = lstm_cuda.mma_infer_plan(640, 1024, NSM)
    bwd, fwd = lstm_cuda.bwd_plan(640, 1024, NSM), lstm_cuda.infer_plan(640, 1024, NSM)
    assert (bwd_old.sm_bytes_per_step, bwd_old.l2_bytes_per_step) == (5242880, 671088640)
    assert (fwd_old.sm_bytes_per_step, fwd_old.l2_bytes_per_step) == (1310720, 167772160)
    assert (bwd.sm_bytes_per_step, bwd.l2_bytes_per_step) == (1310720, 167772160)
    assert (fwd.sm_bytes_per_step, fwd.l2_bytes_per_step) == (655360, 41943040)
    assert 4 * bwd.sm_bytes_per_step <= bwd_old.sm_bytes_per_step
    assert 4 * bwd.l2_bytes_per_step <= bwd_old.l2_bytes_per_step
    b32, f32_ = lstm_cuda.mma_bwd_plan(32, 1024, NSM), lstm_cuda.mma_infer_plan(32, 1024, NSM)
    assert (b32.sm_bytes_per_step, b32.l2_bytes_per_step) == (262144, 33554432)
    assert (f32_.sm_bytes_per_step, f32_.l2_bytes_per_step) == (65536, 8388608)
    nb, nf = lstm_cuda.bwd_plan(32, 1024, NSM), lstm_cuda.infer_plan(32, 1024, NSM)
    assert (nb.sm_bytes_per_step, nb.l2_bytes_per_step) == (131072, 16777216)
    assert (nf.sm_bytes_per_step, nf.l2_bytes_per_step) == (65536, 4194304)


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


# ---------------------------------------------------------- narrow-row plans
# csrc/lstm_infer.cu's and csrc/lstm_bwd.cu's narrow-row kernels (namespace
# narrow), below lstm_cuda.WIDE_MIN_ROWS rows where a NarrowPlan fits.
NARROW_NS = r"namespace narrow \{(.*?)\}  // namespace narrow"


def _narrow_source(name):
    return re.search(NARROW_NS, _source(name), re.S).group(1)


def test_lstm_narrow_constants_match_the_kernels():
    """The constants the narrow plans assume, read back from the kernels:
    the pairs a thread, the backward's m-tiles and n-tiles a warp, the
    8-unit blocks in pairs the entry points take, the plan arguments in the
    order the C entry points name them, and the capacity queries the
    wrappers read."""
    for name in ("lstm_infer.cu", "lstm_bwd.cu"):
        assert _int_const(_narrow_source(name), "kMaxPairs") == lstm_cuda.NARROW_MAX_PAIRS
        fn = "lstm_infer_narrow" if name == "lstm_infer.cu" else "lstm_bwd_narrow"
        params = _entry_params(_source(name), fn)
        names = lstm_cuda.NARROW_PLAN_ARGS
        assert params[-len(names) - 1:-1] == list(names) and params[-1] == "stream"
    fwd = _narrow_source("lstm_infer.cu")
    assert (_int_const(fwd, "kNT"), _int_const(fwd, "kCluster")) == (
        lstm_cuda.NARROW_N_SUB, lstm_cuda.NARROW_CLUSTER)
    assert "n_sub != narrow::kNT || cluster != narrow::kCluster" in _source("lstm_infer.cu")
    bwd = _narrow_source("lstm_bwd.cu")
    assert _int_const(bwd, "kMaxM") == lstm_cuda.NARROW_MAX_M
    assert _int_const(bwd, "kMaxKPW") == lstm_cuda.NARROW_MAX_KPW
    # the backward's clusters are pairs, its warps one K part each
    assert (lstm_cuda.NARROW_N_SUB, lstm_cuda.NARROW_CLUSTER) == (1, 2)
    assert "NT != 1 || C != 2 ||" in _source("lstm_bwd.cu")
    assert "k_split != W" in _source("lstm_bwd.cu")
    # the clusters a launch may take are the portable ones; the wrappers ask
    # the card how many blocks its pairs hold
    assert "NonPortableClusterSizeAllowed" not in _source("lstm_wgmma.cuh")
    assert "int lstm_infer_narrow_blocks(int save_residuals, int* blocks)" in _source("lstm_infer.cu")
    assert "int lstm_bwd_narrow_blocks(int* blocks)" in _source("lstm_bwd.cu")


NARROW_ROWS = [1, 20, 32, 37, 64, "threshold"]


@pytest.mark.parametrize("H", [200, 1024])
@pytest.mark.parametrize("rows", NARROW_ROWS)
@pytest.mark.parametrize("nsm", [NSM, NSM_PCIE])
@pytest.mark.parametrize("kind", ["infer", "resid", "bwd"])
def test_lstm_narrow_plan(kind, nsm, rows, H):
    """Below ``WIDE_MIN_ROWS`` the wrappers take the narrow plan wherever one
    fits: every (row, unit) pair owned by exactly one (block, warp); whole
    pairs of 8-unit blocks, no more blocks than the card holds in pairs (by
    default its SMs in whole pairs: at H 1024 128 blocks fit 132 SMs, not
    114); shared memory, warps and pairs a thread within the kernels'
    limits; the bytes a step by hand. Where none fits (more rows than a
    block's shared memory holds, or too large a grid) the mma.sync plan, and
    at the threshold the wide plan."""
    key = "bwd" if kind == "bwd" else "infer"
    rows = lstm_cuda.WIDE_MIN_ROWS[key] - 1 if rows == "threshold" else rows
    plan = (lstm_cuda.bwd_plan(rows, H, nsm) if kind == "bwd"
            else lstm_cuda.infer_plan(rows, H, nsm, save_residuals=kind == "resid"))
    narrow = lstm_cuda.narrow_plan(key, rows, H, nsm)
    if narrow is None:
        assert isinstance(plan, lstm_cuda.MMAPlan)
        mt = -(-rows // 16)  # none of the candidates fits
        assert mt > (16 if key == "infer" else lstm_cuda.NARROW_MAX_M) or all(
            p.smem_bytes > lstm_cuda.SMEM_MAX or p.blocks > nsm // 2 * 2
            or rows * p.units_per_block > lstm_cuda.NARROW_MAX_PAIRS * p.threads
            or (key == "bwd" and -(-p.piece_k_steps // p.warps) > lstm_cuda.NARROW_MAX_KPW)
            for p in _narrow_candidates(key, rows, H))
        assert (nsm, H) != (NSM, 1024) or rows > (64 if key == "infer" else 32)
        assert lstm_cuda.infer_plan(lstm_cuda.WIDE_MIN_ROWS["infer"], H, nsm).__class__ \
            is lstm_cuda.WidePlan
        return
    assert plan == narrow and (plan.kind, plan.rows, plan.H) == (key, rows, H)
    owners = lstm_cuda.plan_owners(plan)
    assert owners.shape == (rows * H, 3)
    assert (owners[:, 2] == 1).all(), "a (row, unit) pair is owned by no or several warps"
    assert (owners[:, 0] < plan.blocks).all() and (owners[:, 1] < plan.warps).all()
    assert (plan.n_sub, plan.cluster) == (1, 2) and plan.blocks % plan.cluster == 0
    assert plan.blocks <= nsm
    # a card that holds fewer of the kernel's blocks in pairs gets no narrow plan
    assert lstm_cuda.narrow_plan(key, rows, H, nsm, plan.blocks) == plan
    assert lstm_cuda.narrow_plan(key, rows, H, nsm, plan.blocks - 2) is None
    assert plan.smem_bytes <= lstm_cuda.SMEM_MAX and 1 <= plan.warps <= lstm_cuda.MAX_WARPS
    assert rows * plan.units_per_block <= lstm_cuda.NARROW_MAX_PAIRS * plan.threads
    J, mt, ks = plan.units_per_block, -(-rows // 16), plan.k_steps
    assert plan.blocks == -(-(-(-H // J)) // plan.cluster) * plan.cluster
    assert plan.ring_elems == 2 * mt * ks * 256
    if key == "infer":
        assert plan.warps == mt * plan.k_split and ks == -(-H // 16)
        # the whole h tile into each SM; each cluster reads it once
        assert plan.sm_bytes_per_step == mt * 16 * (ks * 16) * 2
        assert plan.smem_bytes == (ks * 4 * J * 32 + mt * max(ks, J // 2) * 512
                                   + plan.warps * 4 * J * 64 + 8)
    else:
        ksc = -(-ks // plan.cluster)
        assert ks == -(-4 * H // 16) and plan.piece_k_steps == ksc
        assert plan.k_split == plan.warps and mt <= lstm_cuda.NARROW_MAX_M
        assert -(-ksc // plan.warps) <= lstm_cuda.NARROW_MAX_KPW
        # wh lives in registers; shared memory holds the da slice and the receive slots
        assert plan.smem_bytes == (mt * ksc * 512 + plan.warps * mt * plan.cluster * J * 64
                                   + plan.cluster * mt * J * 64 + 8)
        # this block's K slice into its SM; the cluster's slices cover K once
        assert plan.sm_bytes_per_step == mt * 16 * (ksc * 16) * 2
    assert plan.l2_bytes_per_step == plan.blocks // plan.cluster * mt * 16 * ks * 16 * 2
    assert len(plan.args()) == len(lstm_cuda.NARROW_PLAN_ARGS)
    assert all(isinstance(a, int) for a in plan.args())


def _narrow_candidates(kind, rows, H):
    mt = -(-rows // 16)
    if kind == "infer":
        return [lstm_cuda.NarrowPlan(kind, rows, H, 1, 2, mt * (w // mt), w // mt)
                for w in (16, 8) if w >= mt]
    return [lstm_cuda.NarrowPlan(kind, rows, H, 1, 2, 16, 16)]


def test_lstm_narrow_plan_main_paths():
    """The plans of the training step's and the encoder's 32 rows (H 1024,
    132 SMs), by hand: the forwards 128 blocks of 8 units in clusters of 2
    (16 warps: 2 m-tiles x 8 K slices); the backward 128 blocks of 8 units
    in clusters of 2 splitting 4H (16 warps, each both m-tiles x both
    n-tiles of the cluster over 8 of its block's 128 k-steps). Bytes a
    step: the forward 64 KiB of h into each SM, 4 MiB from L2 (8 MiB before,
    every block reading all of h); the backward 128 KiB into each SM (256
    KiB before), 16 MiB from L2 (32 MiB)."""
    fwd, res = lstm_cuda.infer_plan(32, 1024, NSM), lstm_cuda.infer_plan(32, 1024, NSM, True)
    bwd = lstm_cuda.bwd_plan(32, 1024, NSM)
    assert fwd == res == lstm_cuda.NarrowPlan("infer", 32, 1024, 1, 2, 16, 8)
    assert bwd == lstm_cuda.NarrowPlan("bwd", 32, 1024, 1, 2, 16, 16)
    assert (fwd.blocks, bwd.blocks, bwd.piece_k_steps) == (128, 128, 128)
    assert (fwd.sm_bytes_per_step, fwd.l2_bytes_per_step) == (65536, 4194304)
    assert (bwd.sm_bytes_per_step, bwd.l2_bytes_per_step) == (131072, 16777216)
    old_f, old_b = lstm_cuda.mma_infer_plan(32, 1024, NSM), lstm_cuda.mma_bwd_plan(32, 1024, NSM)
    assert (old_f.l2_bytes_per_step, old_b.l2_bytes_per_step) == (8388608, 33554432)
    assert lstm_cuda.bwd_plan(20, 1024, NSM) == dataclasses.replace(bwd, rows=20)


# A numpy model of the narrow kernels' index arithmetic, step by step: the
# bf16 ring in mma fragment order (lstm_mma.cuh a_frag_index), the B
# fragments (b_frag_index), the m16n8k16 fragments of A, B and the
# accumulator (PTX ISA, "Matrix Fragments for mma.m16n8k16"), the
# forward's pieces copied into every block of a cluster and its K slices'
# partial tiles summed in slice order before the cell,
# the backward's K slices and its partial tiles stored into their owners'
# receive slots (each block's sum of its warps' partials, in warp order)
# and summed in rank order. Held against the plain versions.
def _a_frag_index(row, k, KS):
    r, c = row & 15, k & 15
    lane = (r & 7) * 4 + ((c & 7) >> 1)
    reg = (r >> 3) + 2 * (c >> 3)
    return ((row >> 4) * KS + (k >> 4)) * 256 + lane * 8 + reg * 2 + (c & 1)


def _b_frag_index(k, n, ntiles):
    kk = k & 15
    lane = (n & 7) * 4 + ((kk & 7) >> 1)
    e = (kk & 1) + 2 * (kk >> 3)
    return (((k >> 4) * ntiles + (n >> 3)) * 32 + lane) * 4 + e


_LANE = np.arange(32)


def _a_regs(tile):
    """A [16, 16] from a fragment-order tile of 256 values (lane-major)."""
    lane, reg, e = np.meshgrid(_LANE, np.arange(4), np.arange(2), indexing="ij")
    a = np.zeros((16, 16))
    a[(lane >> 2) + 8 * (reg & 1), 2 * (lane & 3) + e + 8 * (reg >> 1)] = \
        tile[lane * 8 + reg * 2 + e]
    return a


def _b_regs(frag):
    """B [16, 8] from one n-tile's B fragments at one k-step (32 x 4 values)."""
    lane, e = np.meshgrid(_LANE, np.arange(4), indexing="ij")
    b = np.zeros((16, 8))
    b[2 * (lane & 3) + (e & 1) + 8 * (e >> 1), lane >> 2] = frag[lane * 4 + e]
    return b


def _c_frag(d):
    """The accumulator fragments [32 lanes, 4] of D [16, 8]."""
    lane, c = np.meshgrid(_LANE, np.arange(4), indexing="ij")
    return d[(lane >> 2) + 8 * (c >> 1), 2 * (lane & 3) + (c & 1)]


def _pair_slot(row, j):
    """The (lane, register) of the accumulator holding (row % 16, unit j % 8)."""
    r16 = row & 15
    return (r16 & 7) * 4 + ((j & 7) >> 1), (r16 >> 3) * 2 + (j & 1)


def _narrow_fwd_model(xw, mask, wh, h0, c0, plan, save):
    T, R, H4 = xw.shape
    H, J, NT, C = H4 // 4, plan.units_per_block, plan.n_sub, plan.cluster
    KS, MT, W, WK = plan.k_steps, plan.m_tiles, plan.warps, plan.k_split
    NTILES, slot = 4 * NT, MT * plan.k_steps * 256
    ring = np.zeros(2 * slot)
    hs, cs, gts = np.zeros((T, R, H)), np.zeros((T, R, H)), np.zeros((T, R, H4))
    h, c = h0.astype(np.float64).copy(), c0.astype(np.float64).copy()
    bfr = []
    for b in range(plan.blocks):  # wh's gate columns of block b in B-fragment order
        idx = np.arange(KS * 16 * NTILES * 8)
        n, k = idx % (NTILES * 8), idx // (NTILES * 8)
        unit = b * J + n % J
        ok = (k < H) & (unit < H)
        f = np.zeros(KS * NTILES * 128)
        f[_b_frag_index(k, n, NTILES)] = np.where(
            ok, wh[np.minimum(k, H - 1), np.minimum((n // J) * H + unit, H4 - 1)], 0)
        bfr.append(f)
    rr, uu = np.meshgrid(np.arange(R), np.arange(H), indexing="ij")
    ring[slot + _a_frag_index(rr, uu, KS)] = _bf16(h0)
    KSP = -(-KS // C)
    for t in range(T):
        src = ((t + 1) & 1) * slot
        tiles = np.full((plan.blocks, slot), np.nan)
        for b in range(plan.blocks):  # rank r's piece into every block of its cluster
            r = b % C
            p0, p1 = min(KS, r * KSP), min(KS, min(KS, r * KSP) + KSP)
            for mt in range(MT):
                off = (mt * KS + p0) * 256
                for d in range(b - r, b - r + C):
                    assert np.isnan(tiles[d, off:off + (p1 - p0) * 256]).all()
                    tiles[d, off:off + (p1 - p0) * 256] = ring[src + off:src + off + (p1 - p0) * 256]
        assert not np.isnan(tiles).any(), "a piece of the h tile was never copied"
        new = np.zeros((R, H), bool)
        for b in range(plan.blocks):
            red = np.zeros((W, NTILES, 32, 4))
            KSW = -(-KS // WK)
            for w in range(W):
                wm, wk = w % MT, w // MT
                for ks in range(min(KS, wk * KSW), min(KS, min(KS, wk * KSW) + KSW)):
                    a = _a_regs(tiles[b, (wm * KS + ks) * 256:(wm * KS + ks + 1) * 256])
                    for nt in range(NTILES):
                        f = bfr[b][(ks * NTILES + nt) * 128:(ks * NTILES + nt + 1) * 128]
                        red[w, nt] += _c_frag(a @ _b_regs(f))
            p = np.arange(R * J)
            row, unit = p // J, b * J + p % J
            ok = unit < H
            row, unit, j = row[ok], unit[ok], (p % J)[ok]
            pl, pc = _pair_slot(row, j)
            sums = np.zeros((MT, NTILES, 32, 4))  # the block's sums, in slice order
            for m in range(MT):
                for wk in range(WK):
                    sums[m] = sums[m] + red[wk * MT + m]
            pre = [xw[t, row, q * H + unit] + sums[row >> 4, q * NT + (j >> 3), pl, pc]
                   for q in range(4)]
            sg = lambda v: 1 / (1 + np.exp(-v))
            act = [sg(pre[0]), sg(pre[1]), np.tanh(pre[2]), sg(pre[3])]
            m = mask[t, row]
            c_raw = act[1] * c[row, unit] + act[0] * act[2]
            h[row, unit] = m * act[3] * np.tanh(c_raw) + (1 - m) * h[row, unit]
            c[row, unit] = m * c_raw + (1 - m) * c[row, unit]
            hs[t, row, unit], cs[t, row, unit] = h[row, unit], c[row, unit]
            for q in range(4):
                gts[t, row, q * H + unit] = act[q]
            ring[(t & 1) * slot + _a_frag_index(row, unit, KS)] = _bf16(h[row, unit])
            assert not new[row, unit].any()
            new[row, unit] = True
        assert new.all()
    return (hs, cs, gts, h, c) if save else (hs, h, c)


def _narrow_bwd_model(gates, mask, wh, c_prev, dhs, dhT, dcT, plan):
    T, B, H4 = gates.shape
    H, J, NT, C = H4 // 4, plan.units_per_block, plan.n_sub, plan.cluster
    KS, MT, W = plan.k_steps, plan.m_tiles, plan.warps
    KSC, NTU, slot = plan.piece_k_steps, C * NT, MT * plan.k_steps * 256
    KPW = -(-KSC // W)
    assert plan.k_split == W and KPW <= lstm_cuda.NARROW_MAX_KPW
    ring = np.zeros(2 * slot)
    da = np.zeros((T, B, H4))
    dh, dc = dhT.astype(np.float64).copy(), dcT.astype(np.float64).copy()

    def cell(tc, row, unit, dh_in):
        ig, fg, gg, og = (gates[tc, row, q * H + unit] for q in range(4))
        cp = c_prev[tc, row, unit]
        tanh_c = np.tanh(fg * cp + ig * gg)
        dhk = dh_in + dhs[tc, row, unit]
        dck = dc[row, unit]
        m = mask[tc, row]
        dc_tot = m * dck + m * dhk * og * (1 - tanh_c ** 2)
        a = [dc_tot * gg * ig * (1 - ig), dc_tot * cp * fg * (1 - fg), dc_tot * ig * (1 - gg * gg),
             m * dhk * tanh_c * og * (1 - og)]
        for q in range(4):
            da[tc, row, q * H + unit] = a[q]
            ring[(tc & 1) * slot + _a_frag_index(row, q * H + unit, KS)] = _bf16(a[q])
        dh[row, unit] = (1 - m) * dhk
        dc[row, unit] = dc_tot * fg + (1 - m) * dck

    def pairs(b):
        p = np.arange(B * J)
        row, unit = p // J, b * J + p % J
        ok = unit < H
        return row[ok], unit[ok], (p % J)[ok]

    def slice_of(b):
        r = b % C
        k0 = min(KS, r * KSC)
        return k0, min(KS, k0 + KSC)

    def b_regs(b, ks, nt):
        """The kernel's register B fragments of k-step ks, n-tile nt of
        block b's cluster: lane l's b0, b1 hold wh[n, k], wh[n, k + 1] at
        n = uc + 8 nt + l / 4, k = 16 ks + 2 (l % 4) (+ 8 for b1)."""
        uc = (b - b % C) * J
        f = np.zeros(128)
        lane = np.arange(32)
        n = uc + 8 * nt + (lane >> 2)
        for r in range(2):
            for e in range(2):
                k = 16 * ks + 2 * (lane & 3) + 8 * r + e
                ok = (n < H) & (k < H4)
                f[lane * 4 + 2 * r + e] = np.where(ok, wh[np.minimum(n, H - 1),
                                                          np.minimum(k, H4 - 1)], 0)
        return _b_regs(f)

    for b in range(plan.blocks):  # step T-1 from dhT, dcT
        row, unit, _ = pairs(b)
        cell(T - 1, row, unit, dh[row, unit].copy())
    for t in range(T - 1, -1, -1):
        tiles = {}
        for b in range(plan.blocks):
            k0, k1 = slice_of(b)
            tiles[b] = np.stack([ring[(t & 1) * slot + (mt * KS + k0) * 256:
                                      (t & 1) * slot + (mt * KS + k1) * 256] for mt in range(MT)])
        recv = np.full((plan.blocks, C, MT, NT, 32, 4), np.nan)
        for b in range(plan.blocks):
            k0, k1 = slice_of(b)
            red = np.zeros((W, MT, NTU, 32, 4))
            for w in range(W):
                kw0 = min(k1, k0 + w * KPW)
                for m in range(MT):
                    for nt in range(NTU):
                        for ks in range(kw0, min(k1, kw0 + KPW)):
                            kl = ks - k0
                            a = _a_regs(tiles[b][m, kl * 256:(kl + 1) * 256])
                            red[w, m, nt] += _c_frag(a @ b_regs(b, ks, nt))
            for m in range(MT):  # the block's sums in warp order, to the owners
                for nt in range(NTU):
                    owner = b - b % C + nt // NT
                    assert np.isnan(recv[owner, b % C, m, nt % NT]).all()
                    recv[owner, b % C, m, nt % NT] = sum(red[w, m, nt] for w in range(W))
        assert not np.isnan(recv).any(), "a receive slot was never written"
        for b in range(plan.blocks):
            row, unit, j = pairs(b)
            pl, pc = _pair_slot(row, j)
            tot = np.zeros(len(row))
            for src in range(C):
                tot = tot + recv[b, src, row >> 4, j >> 3, pl, pc]
            dh_in = tot + dh[row, unit]
            if t > 0:
                cell(t - 1, row, unit, dh_in)
            else:
                dh[row, unit] = dh_in
    return da, dh, dc


# (rows, H, SMs): 8-unit blocks in pairs; H 200 (a last block with half
# its units past H, padding blocks of a last cluster), H 8 (one k-step, fewer
# than the cluster's ranks: an empty piece), 37 rows (a partial third
# m-tile), 5 rows at 114 SMs
NARROW_MODEL_SHAPES = [(20, 200, 132), (37, 8, 132), (32, 96, 132), (5, 40, 114)]
# the backward's: a last cluster with a padding block (H 200, H 56), K parts
# past a short slice (H 40)
NARROW_BWD_MODEL_SHAPES = [(20, 200, 132), (32, 96, 132), (5, 40, 114), (17, 56, 132)]


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("rows,H,nsm", NARROW_MODEL_SHAPES)
def test_lstm_narrow_forward_model_matches_plain(rows, H, nsm, save):
    xw, mask, wh, h0, c0 = _lstm_inputs(3, rows, H, seed=rows + H)
    plan = lstm_cuda.narrow_plan("infer", rows, H, nsm)
    assert plan is not None
    got = _narrow_fwd_model(xw.numpy(), mask.numpy(), wh.float().numpy(), h0.numpy(),
                            c0.numpy(), plan, save)
    ref = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, save)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b.numpy(), atol=2e-3, rtol=0)


@pytest.mark.parametrize("rows,H,nsm", NARROW_BWD_MODEL_SHAPES)
def test_lstm_narrow_backward_model_matches_plain(rows, H, nsm):
    import torch
    xw, mask, wh, h0, c0 = _lstm_inputs(3, rows, H, seed=7 * rows + H)
    _, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
    c_prev = torch.cat([c0[None], cs[:-1]])
    g = torch.Generator().manual_seed(3)
    dhs = 0.3 * torch.randn(3, rows, H, generator=g)
    dhT, dcT = 0.3 * torch.randn(rows, H, generator=g), 0.3 * torch.randn(rows, H, generator=g)
    plan = lstm_cuda.narrow_plan("bwd", rows, H, nsm)
    assert plan is not None
    args = (gates, mask, wh, c_prev, dhs, dhT, dcT)
    got = _narrow_bwd_model(*(a.float().numpy() for a in args), plan)
    ref = lstm_cuda.lstm_bwd_plain(*args)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-3, rtol=0)


# The narrow kernels' step protocol, simulated with one actor per block (and
# one for the copy engine) run in seeded random orders: the grid barrier
# that ends each step, the full mbarrier (an expect-tx arrival and pieces,
# which may land before it: the tx count goes below zero meanwhile), the
# forward's pieces copied into every block of a cluster, the backward's
# block sums stored into their owners' receive slots and its cluster
# barrier, and the bulk copies, which read the ring at any time before they
# land. The ring holds, per block and slot, the step of what was written
# there last. The checks: every copy reads the step it was issued for, no
# piece lands in a tile still being read or while the barrier's phase of
# the step before is still open, every receive slot is read before it is
# written again, and nothing deadlocks.
def _run_actors(actors, rng, what):
    stalls = 0
    while actors:
        a = actors[rng.randint(len(actors))]
        try:
            progressed = next(a)
        except StopIteration:
            actors.remove(a)
            stalls = 0
            continue
        stalls = 0 if progressed else stalls + 1
        if stalls > 400 * len(actors):
            raise AssertionError(f"deadlock in the {what} protocol")


def _copy_engine(pending, blocks, rng):
    """Lands pending copies in random order, each at a random later turn."""
    while pending or any(blocks):
        if pending and rng.rand() < 0.3:
            pending.pop(rng.randint(len(pending)))()
            yield True
        else:
            yield False


def _grid_barrier(arrived, step, n):
    """Wait at the grid barrier of ``step`` until all ``n`` blocks arrived."""
    arrived[step] = arrived.get(step, 0) + 1
    while arrived[step] < n:
        yield False


def _simulate_narrow_fwd(T, H, J, C, KS, seed):
    rng = np.random.RandomState(seed)
    nblk = -(-(-(-H // J)) // C) * C
    KSP = -(-KS // C)
    nonempty = sum(1 for r in range(C) if min(KS, r * KSP) < min(KS, r * KSP + KSP))
    ring = {(1, b): -1 for b in range(nblk)}  # h0 in slot 1
    expect = [1] * nblk                       # expect-tx arrivals (step 0's before the start)
    landed = [[0] * T for _ in range(nblk)]
    reading = [False] * nblk
    waited = [0] * nblk  # full-barrier phases a block has waited out
    arrived, pending, live = {}, [], [True] * nblk

    def block(b):
        r, g0 = b % C, b - b % C
        p0, p1 = min(KS, r * KSP), min(KS, r * KSP + KSP)
        yield from _grid_barrier(arrived, -1, nblk)
        for t in range(T):
            if p0 < p1:
                def land(t=t):
                    assert all(ring.get(((t + 1) & 1, p)) == t - 1 for p in range(nblk)
                               if p * J < H), "the copy read a stale slot"
                    for d in range(g0, g0 + C):
                        assert not reading[d], "a piece landed on a tile in use"
                        assert waited[d] >= t, "a piece landed in the barrier's phase before"
                        landed[d][t] += 1
                pending.append(land)
                yield True
            while not (expect[b] >= t + 1 and landed[b][t] == nonempty):  # the full barrier
                yield False
            waited[b] = t + 1
            reading[b] = True
            yield True
            reading[b] = False  # the product has read the tile (the __syncthreads)
            if t + 1 < T:
                expect[b] += 1
            yield True
            if b * J < H:  # the cell writes h_t into slot t % 2
                ring[t & 1, b] = t
            yield True
            if t + 1 < T:
                yield from _grid_barrier(arrived, t, nblk)
        live[b] = False

    actors = [block(b) for b in range(nblk)]
    actors.append(_copy_engine(pending, live, rng))
    _run_actors(actors, rng, "forward")
    assert not pending


def _simulate_narrow_bwd(T, H, J, C, KS, seed):
    rng = np.random.RandomState(seed)
    nblk = -(-(-(-H // J)) // C) * C
    KSC = -(-KS // C)
    ring = {((T - 1) & 1, b): T - 1 for b in range(nblk)}  # step T-1's cell
    landed = [[False] * T for _ in range(nblk)]
    recv = {}  # (owner, source) -> step of the partial in it
    arrived, cluster_arrived, pending, live = {}, {}, [], [True] * nblk

    def block(b):
        r, g0 = b % C, b - b % C
        k0, k1 = min(KS, r * KSC), min(KS, r * KSC + KSC)
        yield from _grid_barrier(arrived, T, nblk)
        for t in range(T - 1, -1, -1):
            s = T - 1 - t
            if k0 < k1:
                def land(t=t, s=s):
                    assert all(ring.get((t & 1, p)) == t for p in range(nblk) if p * J < H), \
                        "the copy read a stale slot"
                    landed[b][s] = True
                pending.append(land)
                yield True
                while not landed[b][s]:
                    yield False
            yield True  # the block's own partial tiles, summed after a block barrier
            for o in range(g0, g0 + C):  # the block's sums, to every owner
                key = (o, r)
                assert recv.get(key) in (None, "read"), "a receive slot written before it was read"
                recv[key] = s
                yield True
            cluster_arrived[g0, s] = cluster_arrived.get((g0, s), 0) + 1
            while cluster_arrived[g0, s] < C:  # the cluster barrier
                yield False
            for src in range(C):
                assert recv[b, src] == s
                recv[b, src] = "read"
            yield True
            if t > 0:
                if b * J < H:  # the cell writes da_{t-1}
                    ring[(t - 1) & 1, b] = t - 1
                yield True
                yield from _grid_barrier(arrived, t, nblk)
        live[b] = False

    actors = [block(b) for b in range(nblk)]
    actors.append(_copy_engine(pending, live, rng))
    _run_actors(actors, rng, "backward")
    assert not pending


# (T, H, J, C): 8-unit blocks in pairs; a last cluster with a padding block
# (H 200, H 40), fewer k-steps than ranks (H 8: an empty piece)
NARROW_PROTOCOL_SHAPES = [(4, 64, 8, 2), (4, 200, 8, 2), (3, 8, 8, 2), (4, 40, 8, 2)]


@pytest.mark.parametrize("T,H,J,C", NARROW_PROTOCOL_SHAPES)
def test_lstm_narrow_forward_protocol(T, H, J, C):
    for seed in range(6):
        _simulate_narrow_fwd(T, H, J, C, -(-H // 16), seed)


@pytest.mark.parametrize("T,H,J,C", NARROW_PROTOCOL_SHAPES)
def test_lstm_narrow_backward_protocol(T, H, J, C):
    for seed in range(6):
        _simulate_narrow_bwd(T, H, J, C, -(-4 * H // 16), seed)
