"""The f32-wh LSTM kernels' launch plan and step protocol, on the CPU.

``csrc/lstm_f32.cu`` runs the f32 route (wh in f32: H <= 512 with f32
compute on the kernel route) only on the card; here:

- ``F32Plan`` (``ops/lstm_cuda.py::f32_plan``) at H 50-1024 and 1-2112
  rows, on 132 and 114 SMs: shared memory within the opt-in limit, the grid
  within the blocks the card holds in pairs, every (row, unit) pair owned
  once (``plan_owners``), the operand-byte figures, and ValueError where no
  plan fits (H 1024 on 114 SMs: 8 units a block make 128 blocks). The
  kernel's constants are read back from its source.
- numpy models of the kernels' step: TMA's 64-byte swizzle against the
  lanes' reads (with an odd count of 16-k blocks a chunk, a warp's 8 row
  groups read 8 bank groups), the chunks through the ring (two boxes of
  half the rows, the operand's padded ring, the rows and blocks past it
  read as zeros), the K slices' partial tiles summed in slice order, the
  backward's two K halves added in rank order; held against
  ``lstm_seq_plain`` and ``lstm_bwd_plain`` in f32.
- the ring's protocol run as actors (producers, consumer warps, the
  cluster and grid barriers) until every step is done: no deadlock, and
  every parity wait unambiguous (every warp reads every chunk in order);
  without the backward producer's cluster barriers inside a step, it
  deadlocks.
- a whole training step of a text VAE built from the Yahoo config narrowed
  to enc_nh = dec_nh = 128 (on the TPU tile, so the JAX package takes its
  f32 Pallas kernels, run in interpret mode) on the kernel route, against
  the JAX package on its own noise.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vae_lagging_encoder_tpu.config import get_config as jax_get_config
from vae_lagging_encoder_tpu.models import build_text_vae as jax_build
from vae_lagging_encoder_tpu.train.aggressive import make_grad_on as jax_make_grad_on
from vae_lagging_encoder_tpu.train.epoch import make_loss_fn as jax_make_loss_fn
from vae_lagging_encoder_tpu_torch.config import get_config
from vae_lagging_encoder_tpu_torch.models import build_text_vae
from vae_lagging_encoder_tpu_torch.ops import lstm_cuda as L
from vae_lagging_encoder_tpu_torch.train.aggressive import grads_of, make_grad_on
from vae_lagging_encoder_tpu_torch.train.epoch import make_loss_fn
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

SRC = Path(L.__file__).resolve().parent.parent / "csrc" / "lstm_f32.cu"
HS = (50, 128, 256, 384, 512, 1024)
ROWS = (1, 8, 20, 32, 33, 64, 96, 128, 600, 640, 2112)


def _const(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SRC.read_text())
    return m.group(1).split("//")[0].strip()


def test_f32_constants_match_the_kernel_source():
    src = SRC.read_text()
    assert int(_const("kKC")) == L.F32_KC
    assert int(_const("kTileRows")) == L.F32_TILE_ROWS
    assert int(_const("kMaxWarps")) == L.F32_MAX_WARPS
    assert int(_const("kPad")) == L.F32_PAD
    assert int(_const("kCluster")) == L.F32_CLUSTER
    cases = sorted({int(j) for j in re.findall(r"LSTM_F32_CASE\((\d+), (?:true|false)\)\n", src)})
    assert tuple(cases) == L.F32_UNITS
    assert "launch_bwd<4>" in src and "launch_bwd<8>" in src
    # the plan's fields in the order of the C entry points' arguments
    start = src.index("int lstm_fwd_f32(")
    sig = src[start:src.index("void* stream) {", start)]
    assert re.findall(r"int (units|cluster|row_groups|rows_per_group|row_tile|k_slices|k_blocks|"
                      r"stages|smem_bytes)\b", sig) == list(L.F32_PLAN_ARGS)


@pytest.mark.parametrize("nsm", [132, 114])
@pytest.mark.parametrize("H", HS)
@pytest.mark.parametrize("kind", ["infer", "bwd"])
def test_f32_plan_covers_rows_and_fits_the_card(kind, H, nsm):
    max_blocks = nsm // 2 * 2
    for rows in ROWS:
        if L.F32Plan(kind, rows, H, 8, 1, 32, 32, 1, 1, 1).unit_blocks > max_blocks:
            with pytest.raises(ValueError, match="no f32 plan"):
                L.f32_plan(kind, rows, H, nsm)
            continue
        p = L.f32_plan(kind, rows, H, nsm)
        assert (p.kind, p.rows, p.H, p.cluster) == (kind, rows, H, L.F32_CLUSTER)
        assert p.units in L.F32_UNITS and p.smem_bytes <= L.SMEM_MAX
        assert p.blocks <= max_blocks and p.blocks % p.cluster == 0
        assert p.row_tile % L.F32_TILE_ROWS == 0 and p.rows_per_group % p.row_tile == 0
        assert 1 <= p.warps <= L.F32_MAX_WARPS and p.threads == 32 * (p.warps + 1)
        assert p.k_slices <= p.k16_blocks
        assert (p.row_groups - 1) * p.rows_per_group < rows <= p.row_groups * p.rows_per_group
        per_step = p.passes * p.chunks
        assert min(L.F32_MIN_STAGES, per_step) <= p.stages <= per_step
        assert p.k_blocks % 2 == 1 and p.k_blocks <= p.k16_blocks
        # the kernel's TMA box is half a row tile (at most 256 rows)
        assert p.row_tile // 2 <= 256
        # 8 units a block where 4 do not fit the card, or do more work a
        # block or bring more rows into it (the plan's order)
        if p.units == 8:
            q = L._f32_plan_units(kind, rows, H, 4, max_blocks)
            assert q is None or (q.rows_per_group * 4, q.rows_per_group) >= \
                (p.rows_per_group * 8, p.rows_per_group)
        owners = L.plan_owners(p)
        assert (owners[:, 2] == 1).all(), (rows, p)
        assert owners[:, 0].max() < p.blocks and owners[:, 1].max() < p.warps
        K = H if kind == "infer" else 2 * H
        assert p.chunks * p.k_blocks * 16 >= K > (p.chunks - 1) * p.k_blocks * 16
        assert p.sm_bytes_per_step == p.rows_per_group * p.chunks * p.k_blocks * 16 * 4
        assert p.l2_bytes_per_step * (2 if kind == "infer" else 1) == \
            p.blocks * p.sm_bytes_per_step


def test_f32_plan_at_the_h512_path_shapes():
    """The narrowed Yahoo model's shapes on an H100 SXM (132 SMs): at 32
    rows 4 units a block, 128 blocks, one 32-row tile over 16 K slices with
    every chunk of a step (4 wide chunks) in the ring; at 640 rows 8 units a
    block in two row groups of 320 (the same products a block as 4 units
    over 640 rows, half the operand into each SM), 16 warps in passes."""
    for kind in ("infer", "bwd"):
        p = L.f32_plan(kind, 32, 512, 132)
        assert (p.units, p.blocks, p.row_groups, p.row_tile, p.k_slices, p.passes) == \
            (4, 128, 1, 32, 16, 1)
        assert p.chunks == 4 and p.stages == p.chunks  # every chunk of a step in the ring
        q = L.f32_plan(kind, 640, 512, 132)
        assert (q.units, q.blocks, q.row_groups, q.rows_per_group, q.warps) == (8, 128, 2, 320, 16)
    # the forward's multicast halves the L2 reads: every pair shares its chunk
    p = L.f32_plan("infer", 640, 512, 132)
    assert p.l2_bytes_per_step == 64 * 320 * p.chunks * p.k_blocks * 16 * 4


def test_f32_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="no f32 plan"):
        L.f32_plan("bwd", 32, 1024, 132, max_blocks=126)
    with pytest.raises(ValueError, match="no f32 plan"):
        L.f32_plan("infer", 32, 4096, 132)


# ------------------------------------------------------------- kernel models
KC, TR = L.F32_KC, L.F32_TILE_ROWS


def tma_swizzle64(o):
    """The byte offset TMA's 64-byte swizzle writes byte ``o`` of a box to:
    address bits 4-5 XOR bits 7-8."""
    return o ^ (((o >> 7) & 3) << 4)


def lane_read(line, j):
    """The kernel's read of float4 j of 64-byte line ``line`` of a slot."""
    return line * KC * 4 + ((j ^ ((line >> 1) & 3)) << 4)


def slot_line(r, kb, RT, KB):
    """The kernel's line of row r (of the pass's tile), 16-k block kb, in a
    slot [2 halves][RT / 2 rows][KB blocks]."""
    half = RT // 2
    return (r // half) * half * KB + (r % half) * KB + kb


def test_swizzle_reads_what_tma_wrote_and_row_groups_hit_distinct_banks():
    for line in range(1024):
        for j in range(4):
            assert lane_read(line, j) == tma_swizzle64(line * 64 + 16 * j)
    # odd blocks a chunk: a warp's 8 row groups read 8 distinct bank groups
    for KB in (1, 3, 5, 9, 17):
        for RT in (32, 64, 128, 160):
            for trow in range(0, RT, 32):
                for i in range(4):
                    for kb in range(KB):
                        for j in range(4):
                            groups = {(lane_read(slot_line(trow + rg + 8 * i, kb, RT, KB), j)
                                       // 16) % 8 for rg in range(8)}
                            assert len(groups) == 8, (KB, RT, trow, i, kb, j)
    # an even count would not
    groups = {(lane_read(slot_line(rg, 0, 32, 2), 0) // 16) % 8 for rg in range(8)}
    assert len(groups) < 8


def _tma_box(src, r0, b0, nrows, KB):
    """A box of ``nrows`` rows x KB 16-k blocks of ``src`` [R, NC * 16] at
    (row r0, block b0) through TMA: zeros past the tensor, written
    swizzled as [rows][blocks][16] into a byte buffer."""
    R, K = src.shape
    box = np.zeros((nrows, KB, KC), np.float32)
    for rr in range(nrows):
        for kb in range(KB):
            r, b = r0 + rr, b0 + kb
            if 0 <= r < R and b * KC < K:
                box[rr, kb] = src[r, b * KC:(b + 1) * KC]
    buf = np.zeros(box.size * 4, np.uint8)
    raw = box.view(np.uint8).reshape(-1)
    buf[tma_swizzle64(np.arange(raw.size))] = raw
    return buf


def _lane_block(slot, trow, RT, KB, kb):
    """Block kb of a 32-row tile's rows as the lanes read them: rows trow +
    rg + 8 i, float4 j -> [32, 16]."""
    out = np.zeros((TR, KC), np.float32)
    for rg in range(8):
        for i in range(4):
            line = slot_line(trow + rg + 8 * i, kb, RT, KB)
            for j in range(4):
                o = lane_read(line, j)
                out[rg + 8 * i, 4 * j:4 * j + 4] = slot[o:o + 16].view(np.float32)
    return out


def _block_products(plan, wsl, row0, src):
    """One block's products of a step, pass by pass: each chunk (KB 16-k
    blocks) in ring slot g % S, filled by two boxes of half the rows from
    the padded operand ``src`` [rows, NC * 16] (the forward's from each rank
    of the cluster, the backward's both from its own block), read by every
    warp (mw, ks) for the blocks b = ks mod KS; the warps' partial tiles
    summed in slice order -> [passes][RT, ncol]."""
    RT, KS, NC, KB, S = (plan.row_tile, plan.k_slices, plan.k16_blocks, plan.k_blocks,
                         plan.stages)
    half, ring, sums = RT // 2, {}, []
    for p in range(plan.passes):
        part = np.zeros((KS, RT, wsl.shape[1]), np.float32)
        for c in range(plan.chunks):
            g = p * plan.chunks + c
            slot = np.zeros(RT * KB * KC * 4, np.uint8)
            for h in range(2):
                box = _tma_box(src, row0 + p * RT + h * half, c * KB, half, KB)
                slot[h * box.size:(h + 1) * box.size] = box
            ring[g % S] = slot
            for kb in range(KB):
                b = c * KB + kb
                if b >= NC:
                    break
                ks = b % KS
                w = wsl[b * KC:(b + 1) * KC]
                for mw in range(RT // TR):
                    a = _lane_block(ring[g % S], mw * TR, RT, KB, kb)
                    acc = part[ks, mw * TR:(mw + 1) * TR]
                    for k in range(KC):  # the lanes' FMAs in k order
                        acc += a[:, k:k + 1] * w[k][None, :]
        tot = np.zeros((RT, wsl.shape[1]), np.float32)
        for ks in range(KS):  # slice order
            tot += part[ks]
        sums.append(tot)
    return sums


def _sig(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def model_fwd(plan, xw, mask, wh, h0, c0):
    """The forward kernel's arithmetic under ``plan``: the f32 ring of h,
    each block's chunks (half the rows from each rank of its cluster), the
    slice sums, the cell -> (hs, cs, gates, hT, cT)."""
    T, rows, H4 = xw.shape
    H, J = H4 // 4, plan.units
    NC = plan.k16_blocks
    ringh = np.zeros((2, rows, H), np.float32)
    ringh[1] = h0
    c = c0.copy()
    hs = np.zeros((T, rows, H), np.float32)
    cs, gates = np.zeros_like(hs), np.zeros((T, rows, H4), np.float32)
    for t in range(T):
        new_h = ringh[(t + 1) & 1].copy()
        for rg in range(plan.row_groups):
            for ub in range(plan.unit_blocks):
                u0, row0 = ub * J, rg * plan.rows_per_group
                # ws[k][4 j + q] = wh[k, q H + u0 + j], zero past H
                wsl = np.zeros((NC * KC, 4 * J), np.float32)
                for j in range(J):
                    for q in range(4):
                        if u0 + j < H:
                            wsl[:H, 4 * j + q] = wh[:, q * H + u0 + j]
                src = np.zeros((rows, NC * KC), np.float32)  # the ring slot, zeros past H
                src[:, :H] = ringh[(t + 1) & 1]
                sums = _block_products(plan, wsl, row0, src)
                for p, tot in enumerate(sums):
                    for rl in range(plan.row_tile):
                        row = row0 + p * plan.row_tile + rl
                        for j in range(J):
                            unit = u0 + j
                            if row >= rows or unit >= H:
                                continue
                            a = xw[t, row, unit::H][:4] + tot[rl, 4 * j:4 * j + 4]
                            ig, fg, og = _sig(a[0]), _sig(a[1]), _sig(a[3])
                            gg = np.tanh(a[2])
                            m = mask[t, row]
                            c_raw = fg * c[row, unit] + ig * gg
                            h_raw = og * np.tanh(c_raw)
                            hp = ringh[(t + 1) & 1][row, unit]
                            new_h[row, unit] = m * h_raw + (1 - m) * hp
                            c[row, unit] = m * c_raw + (1 - m) * c[row, unit]
                            cs[t, row, unit] = c[row, unit]
                            gates[t, row, unit::H][:4] = (ig, fg, gg, og)
        ringh[t & 1] = new_h
        hs[t] = new_h
    return hs, cs, gates, hs[-1], c


def model_bwd(plan, gates, mask, wh, c_prev, dhs, dhT, dcT):
    """The backward kernel's arithmetic under ``plan``: da read back
    through TMA boxes of its K half, each block's slice sums of the
    cluster's 2J units, the halves added in rank order, the cell."""
    T, B, H4 = gates.shape
    H, J = H4 // 4, plan.units
    NC = plan.k16_blocks
    da = np.zeros((T, B, H4), np.float32)
    dh, dc = np.zeros((B, H), np.float32), np.zeros((B, H), np.float32)

    def cell(t, row, unit, dh_in, dc_in):
        ig, fg, gg, og = gates[t, row, unit::H][:4]
        cp = c_prev[t, row, unit]
        tanh_c = np.tanh(fg * cp + ig * gg)
        dhk = dh_in + dhs[t, row, unit]
        m = mask[t, row]
        dh_raw, dc_raw = m * dhk, m * dc_in
        dc_tot = dc_raw + dh_raw * og * (1 - tanh_c * tanh_c)
        da[t, row, unit::H][:4] = (dc_tot * gg * ig * (1 - ig), dc_tot * cp * fg * (1 - fg),
                                   dc_tot * ig * (1 - gg * gg), dh_raw * tanh_c * og * (1 - og))
        dh[row, unit] = (1 - m) * dhk
        dc[row, unit] = dc_tot * fg + (1 - m) * dc_in

    for row in range(B):
        for unit in range(H):
            cell(T - 1, row, unit, dhT[row, unit], dcT[row, unit])
    for t in range(T - 1, -1, -1):
        dh_sum = np.zeros((B, H), np.float32)
        for rg in range(plan.row_groups):
            row0 = rg * plan.rows_per_group
            for pr in range(plan.unit_blocks // 2):
                uc = 2 * J * pr
                sums = []
                for r in range(2):  # each rank's K half: ws[k][n] = wh[uc + n, 2H r + k]
                    wsl = np.zeros((NC * KC, 2 * J), np.float32)
                    for n in range(2 * J):
                        if uc + n < H:
                            wsl[:2 * H, n] = wh[uc + n, 2 * H * r:2 * H * (r + 1)]
                    src = np.zeros((B, NC * KC), np.float32)  # the ring's K half r
                    src[:, :2 * H] = da[t][:, 2 * H * r:2 * H * (r + 1)]
                    sums.append(_block_products(plan, wsl, row0, src))
                for p in range(plan.passes):
                    for rl in range(plan.row_tile):
                        row = row0 + p * plan.row_tile + rl
                        for n in range(2 * J):
                            if row < B and uc + n < H:  # rank 0's half + rank 1's
                                dh_sum[row, uc + n] = sums[0][p][rl, n] + sums[1][p][rl, n]
        dh_in = dh_sum + dh
        if t == 0:
            dh = dh_in
            break
        dc_in = dc.copy()
        for row in range(B):
            for unit in range(H):
                cell(t - 1, row, unit, dh_in[row, unit], dc_in[row, unit])
    return da, dh, dc


def _f32_inputs(seed, T, B, H):
    rng = np.random.RandomState(seed)
    xw = (0.5 * rng.randn(T, B, 4 * H)).astype(np.float32)
    mask = (rng.rand(T, B) > 0.2).astype(np.float32)
    wh = ((rng.rand(H, 4 * H) * 2 - 1) / np.sqrt(H)).astype(np.float32)
    h0, c0 = ((0.1 * rng.randn(B, H)).astype(np.float32) for _ in range(2))
    dhs = (0.1 * rng.randn(T, B, H)).astype(np.float32)
    dhT, dcT = ((0.1 * rng.randn(B, H)).astype(np.float32) for _ in range(2))
    return xw, mask, wh, h0, c0, dhs, dhT, dcT


# (T, rows, H, plan overrides): the chosen plans at small H, and plans with
# passes, K slices that split the chunks unevenly, a ring shorter than a
# step's chunks, row groups with a ragged last one, an off-tile H
MODEL_CASES = [
    (3, 20, 50, {}),
    (3, 37, 24, {}),
    (2, 70, 40, dict(row_groups=2, rows_per_group=64, row_tile=32, k_slices=2, k_blocks=1,
                     stages=2)),
    (2, 45, 72, dict(row_groups=1, rows_per_group=64, row_tile=32, k_slices=4, k_blocks=3,
                     stages=2)),
    (2, 40, 40, dict(units=8, row_groups=1, rows_per_group=64, row_tile=32, k_slices=2,
                     k_blocks=3, stages=1)),
]


@pytest.mark.parametrize("T,rows,H,over", MODEL_CASES)
def test_forward_model_matches_plain(T, rows, H, over):
    xw, mask, wh, h0, c0, *_ = _f32_inputs(rows + H, T, rows, H)
    plan = dataclasses.replace(L.f32_plan("infer", rows, H, 32), **over)
    assert (plan.row_groups - 1) * plan.rows_per_group < rows
    got = model_fwd(plan, xw, mask, wh, h0, c0)
    ref = L.lstm_seq_plain(*(torch.from_numpy(a) for a in (xw, mask, wh, h0, c0)), True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("T,rows,H,over", MODEL_CASES)
def test_backward_model_matches_plain(T, rows, H, over):
    xw, mask, wh, h0, c0, dhs, dhT, dcT = _f32_inputs(rows + H + 1, T, rows, H)
    t = {k: torch.from_numpy(v) for k, v in dict(xw=xw, mask=mask, wh=wh, h0=h0, c0=c0).items()}
    _, cs, gates, _, _ = L.lstm_seq_plain(t["xw"], t["mask"], t["wh"], t["h0"], t["c0"], True)
    c_prev = torch.cat([t["c0"][None], cs[:-1]])
    plan = dataclasses.replace(L.f32_plan("bwd", rows, H, 32), **over)
    got = model_bwd(plan, gates.numpy(), mask, wh, c_prev.numpy(), dhs, dhT, dcT)
    ref = L.lstm_bwd_plain(gates, t["mask"], t["wh"], c_prev, *(torch.from_numpy(a)
                                                                  for a in (dhs, dhT, dcT)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), atol=1e-5, rtol=0)


# ------------------------------------------------------------ ring protocol
class _Bar:
    """An mbarrier: ``count`` arrivals (and the expected bytes landed)
    complete a phase; ``done`` counts the completed phases."""

    def __init__(self, count):
        self.count, self.arrived, self.tx, self.done = count, 0, 0, 0

    def arrive(self, tx=0):
        self.arrived += 1
        self.tx += tx
        self._check()

    def land(self, nbytes):
        self.tx -= nbytes
        self._check()

    def _check(self):
        if self.arrived == self.count and self.tx == 0:
            self.done, self.arrived = self.done + 1, 0

    def parity_done(self, parity):
        """try_wait.parity: the phase of this parity has completed, i.e.
        the current phase's parity differs."""
        return (self.done & 1) != parity


def run_protocol(bwd, T, P, NCH, S, W, producer_syncs=True):
    """Both blocks of a cluster as actors, step by step: a producer (the
    chunk loop of ``produce``: P passes x NCH chunks into S ring slots), W
    consumer warps (every chunk of each pass in order, then, in the
    backward, the pass's cluster barrier), the grid barrier between steps.
    Returns True when every actor finished, False on a deadlock; asserts
    each parity wait is the use it means (its barrier's completed phases
    are exactly that use + 1)."""
    half = 32 * 64  # bytes of half a chunk
    full = [[_Bar(1) for _ in range(S)] for _ in range(2)]
    empty = [[_Bar(W if bwd else 2 * W) for _ in range(S)] for _ in range(2)]
    n_actors = 2 * (1 + W)
    cluster_bar = {"arrived": 0, "gen": 0}
    grid_bar = {"arrived": 0, "gen": 0}

    def barrier(bar, n):
        gen = bar["gen"]
        bar["arrived"] += 1
        if bar["arrived"] == n:
            bar["arrived"], bar["gen"] = 0, gen + 1
        while bar["gen"] == gen:
            yield

    def producer(b):
        for t in range(T):
            g0, synced = t * P * NCH, 0
            for i in range(P * NCH):
                q, g = i // NCH, g0 + i
                slot, use = g % S, g // S
                if bwd and producer_syncs:
                    while synced < q and use > 0 and g - S >= g0 + q * NCH:
                        yield from barrier(cluster_bar, n_actors)
                        synced += 1
                if use > 0:
                    while not empty[b][slot].parity_done((use - 1) & 1):
                        yield
                    assert empty[b][slot].done == use
                full[b][slot].arrive(tx=2 * half)
                for dst in ((b,) if bwd else (0, 1)):  # the forward's multicast half
                    full[dst][slot].land(2 * half if bwd else half)
                yield
            if bwd:
                while synced < P:
                    yield from barrier(cluster_bar, n_actors)
                    synced += 1
            yield from barrier(grid_bar, n_actors)

    def consumer(b):
        for t in range(T):
            for p in range(P):
                for c in range(NCH):
                    g = (t * P + p) * NCH + c
                    slot, use = g % S, g // S
                    while not full[b][slot].parity_done(use & 1):
                        yield
                    assert full[b][slot].done == use + 1
                    empty[b][slot].arrive()
                    if not bwd:
                        empty[1 - b][slot].arrive()
                    yield
                if bwd:
                    yield from barrier(cluster_bar, n_actors)
            yield from barrier(grid_bar, n_actors)

    live = [producer(b) for b in range(2)] + [consumer(b) for b in range(2) for _ in range(W)]
    last, idle = None, 0
    while live:
        for a in list(live):
            try:
                next(a)
            except StopIteration:
                live.remove(a)
        # a waiting actor yields once a round: a round that changes no
        # barrier, no count and no actor's life is a deadlock
        state = (len(live), cluster_bar["gen"], grid_bar["gen"], cluster_bar["arrived"],
                 grid_bar["arrived"], tuple((x.done, x.arrived, x.tx) for r in full + empty
                                            for x in r))
        idle = idle + 1 if state == last else 0
        last = state
        if idle > 2:
            return False
    return True


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("P,NCH,S,W", [
    (1, 4, 4, 16),    # the 32-row plans: every chunk of a step in the ring
    (1, 13, 2, 16),   # a ring shorter than a step
    (5, 4, 2, 16),    # 640 rows: passes, the ring wrapping inside passes
    (5, 8, 3, 16),    # a ring that wraps off the passes' boundaries
    (2, 3, 9, 12),    # a ring deeper than a step
])
def test_ring_protocol_runs_to_the_end(bwd, P, NCH, S, W):
    assert run_protocol(bwd, 3, P, NCH, S, W)


def test_backward_producer_needs_its_cluster_barriers():
    """Without the cluster barriers inside a step the backward's producer
    waits for a slot that consumers release only after the barrier it has
    not reached: the protocol deadlocks."""
    assert run_protocol(True, 2, 3, 4, 2, 4)
    assert not run_protocol(True, 2, 3, 4, 2, 4, producer_syncs=False)


# ---------------------------------------------------- a whole training step
TRAIN_V, TRAIN_B, TRAIN_T = 300, 8, 9
# f32 on both sides (H 128: wh stays f32, the CE's operands f32): sums in
# another order through the LSTM recurrences and the 300-word logsumexp;
# the gradients of a step (loss ~1e2) agree to ~1e-6 relative here
TRAIN_ATOL, TRAIN_RTOL = 3e-4, 1e-3


def _loss_draw(k_loss):
    k_enc, k_dec = jax.random.split(k_loss)
    k_in, k_out = jax.random.split(k_dec)

    def draw(site, shape):
        if site == "eps":
            return torch.from_numpy(np.array(jax.random.normal(k_enc, shape, jnp.float32)))
        k = k_in if site == "keep_in" else k_out
        return torch.from_numpy(np.array(jax.random.uniform(k, shape, jnp.float32)))

    return draw


@pytest.mark.parametrize("nsamples", [1, 3])
def test_h128_training_step_on_the_kernel_route_matches_jax(nsamples):
    over = dict(ni=16, enc_nh=128, dec_nh=128, nz=4, use_pallas=True)
    cfg_j, cfg = jax_get_config("yahoo", **over), get_config("yahoo", **over)
    assert cfg.compute_dtype == "float32" and cfg.use_pallas
    rng = np.random.RandomState(11)
    tokens = rng.randint(4, TRAIN_V, (TRAIN_B, TRAIN_T)).astype(np.int32)
    lens = rng.randint(3, TRAIN_T + 1, size=TRAIN_B)
    lens[0] = TRAIN_T
    mask = (np.arange(TRAIN_T)[None, :] < lens[:, None]).astype(np.float32)
    tokens = np.where(mask > 0, tokens, 0).astype(np.int32)
    rw = np.ones(TRAIN_B, np.float32)
    key, kl_weight = jax.random.PRNGKey(7), 0.6
    with pltpu.force_tpu_interpret_mode():
        vae_j = jax_build(cfg_j, TRAIN_V)
        params = jax.device_get(vae_j.init(jax.random.PRNGKey(8)))
        pj = jax.tree.map(jnp.asarray, params)
        grad_on = jax.jit(jax_make_grad_on(jax_make_loss_fn(vae_j, nsamples=nsamples,
                                                            train=True)))
        grads_j, aux_j = jax.device_get(grad_on(
            pj, key, (jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(rw)),
            jnp.float32(kl_weight)))
    vae = build_text_vae(cfg, TRAIN_V, device="cpu")
    vae.load_state_dict(from_jax_params(params))
    aux = make_grad_on(vae, make_loss_fn(vae, nsamples=nsamples, train=True))(
        (torch.from_numpy(tokens).long(), torch.from_numpy(mask), torch.from_numpy(rw)),
        _loss_draw(key), kl_weight)
    for got, want in zip(aux, aux_j):
        np.testing.assert_allclose(float(got.detach()), float(want), atol=TRAIN_ATOL,
                                   rtol=TRAIN_RTOL)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {prefix + k: np.asarray(v)})
        return out

    grads, want = grads_of(dict(vae.named_parameters())), flat(grads_j)
    assert want.keys() == grads.keys()
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k], atol=TRAIN_ATOL, rtol=TRAIN_RTOL,
                                   err_msg=k)
