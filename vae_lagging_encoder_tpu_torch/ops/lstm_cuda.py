"""Whole-sequence masked-carry LSTM, forward and backward: CUDA kernels +
plain versions + the autograd Function.

- ``lstm_seq`` is the port's counterpart of the JAX package's Pallas kernels
  ``ops/lstm_pallas.py::_fwd_kernel`` (``save_residuals=True``: also the
  cell states and gate activations a backward pass needs) and
  ``_infer_kernel`` (``save_residuals=False``); it launches
  ``csrc/lstm_infer.cu`` (tensor cores) for bf16 ``wh``, with or without
  residuals, and ``csrc/lstm_f32.cu`` (FMA pipes) for f32 ``wh``.
- ``lstm_bwd`` is the counterpart of ``_bwd_kernel`` (the reverse-time
  sweep); it launches ``csrc/lstm_bwd.cu`` (tensor cores) with bf16 ``wh``,
  ``csrc/lstm_f32.cu`` with f32.
- ``infer_plan`` / ``bwd_plan`` compute the launch plans of the two
  tensor-core kernels, which the kernels check: below ``WIDE_MIN_ROWS`` a
  ``NarrowPlan`` (``narrow_plan``: ``mma.sync`` on an operand brought by
  ``cp.async.bulk``, in clusters: the forward's multicast to the cluster,
  the backward's K split between a cluster's two blocks; units per block,
  cluster, warps, K slices, shared memory) where one fits, else an
  ``MMAPlan`` (``mma_infer_plan`` / ``mma_bwd_plan``: ``mma.sync`` with
  ``cp.async``; blocks, units per block, warps, m-tiles per pass, pipeline
  stages, shared memory); from there a ``WidePlan`` (``wide_plan``)
  (``wgmma`` with TMA in clusters of two blocks; row groups, units per
  block, K slices, cluster, warpgroups, stages, the backward's receive
  slots, shared memory), or ValueError where no wide plan fits. Each plan
  gives its operand bytes a step per SM and from L2; ``plan_owners`` lists
  which (block, warp) owns each (row, unit) pair.
- ``f32_plan`` computes the f32 kernels' ``F32Plan`` (both directions, any
  row count: units per block, cluster, row groups, row tile, K slices, 16-k
  blocks a chunk, ring stages, shared memory, operand bytes a step), or
  raises ValueError where none fits.
- ``lstm_infer`` / ``lstm_bwd_bf16`` launch the bf16 kernels under a given
  plan, ``lstm_fwd_f32`` / ``lstm_bwd_f32`` the f32 ones (``lstm_seq`` /
  ``lstm_bwd`` call them with the plans above).
- ``LSTMSeqFn`` is the counterpart of ``lstm_seq_fused`` with its
  ``_fused_fwd``/``_fused_bwd``: the residual-saving forward, then the
  backward sweep and dWh = h_prev^T da as one matrix product.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs its plain PyTorch version (``lstm_seq_plain``,
``lstm_bwd_plain``), which is also what the kernel is checked against.

Numerics (both versions, as in the TPU kernels): ``h_{t-1}`` (forward) and
``da`` (backward) are rounded to ``wh``'s dtype before the product, products
accumulate in f32, the state and the grads are f32, and ``hs``/``cs`` hold
the KEPT state at masked steps.
"""
from __future__ import annotations

import ctypes
import functools
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import build

# --------------------------------------------------------------- launch plans
# Constants the tensor-core kernels are written for (csrc/lstm_mma.cuh,
# csrc/lstm_infer.cu, csrc/lstm_bwd.cu); tests/test_torch_port_lstm_plan.py
# reads them back from the sources.
MMA_STAGES = 4          # kStages: cp.async ring depth per warp
MAX_WARPS = 16          # kMaxWarps
SMEM_MAX = 232448       # dynamic shared memory one H100 block may opt into
# (n_sub, m_group) instantiations of each kernel. The forward keeps
# m_group x 4 n_sub accumulator tiles per lane (<= 64 f32 registers); n_sub 2
# (16 units per block) serves H > 8 x the SM count (H 1024 on a 114-SM
# H100 PCIe). The residual-saving forward runs at the training batch (up to
# 16 m-tiles, one m-tile a warp per pass); more rows take more passes.
INFER_VARIANTS = ((1, 1), (1, 2), (1, 3), (1, 4), (2, 1), (2, 2))
RESID_VARIANTS = ((1, 1), (2, 1))
BWD_VARIANTS = tuple((nt, mg) for nt in (1, 2) for mg in (1, 2, 3, 4))
# ctypes order of the plan fields after (T, rows, H), as the C entry points
# name them
INFER_PLAN_ARGS = ("n_sub", "warps", "k_split", "m_group", "k_chunk", "stages", "smem_bytes")
BWD_PLAN_ARGS = ("n_sub", "warps", "m_group", "k_chunk", "stages", "smem_bytes")
# The wide-row kernels (csrc/lstm_wgmma.cuh; lstm_infer.cu's and
# lstm_bwd.cu's namespace wide): kStages, warpgroups, units per block, and
# the cluster of two blocks: the forward's share h tiles by TMA multicast,
# the backward's split K and sum their partial dh tiles through distributed
# shared memory.
WIDE_STAGES = 4
WIDE_WARPGROUPS = 2
WIDE_UNITS = {"infer": 16, "bwd": 32}
WIDE_CLUSTER = 2
WIDE_TILE_ROWS = 64     # rows of a wgmma m-tile
WIDE_RECV_BYTES = 128 * 8 * 4  # kRecvBytes: a backward receive slot (128 threads x 8 f32)
# From this many rows the wide plan (measured faster on the H100 from there,
# lstm_ablation.py's sweep; PERF.md) and below it the narrow plan, or the
# mma.sync plan where no narrow plan fits: the two forwards (with and
# without residuals), the backward.
WIDE_MIN_ROWS = {"infer": 128, "bwd": 96}
WIDE_PLAN_ARGS = ("row_groups", "rows_per_group", "units", "k_slices", "cluster",
                  "warpgroups", "stages", "smem_bytes")
# The narrow-row kernels (lstm_infer.cu's and lstm_bwd.cu's namespace
# narrow): at most kMaxPairs (row, unit) pairs a thread; 8 units a block
# (n_sub 1) in clusters of 2 (128 blocks at H 1024; 16-unit blocks in
# larger clusters measured slower on an H100, and in the backward wh's
# fragments would spill).
NARROW_PLAN_ARGS = ("n_sub", "cluster", "warps", "k_split", "smem_bytes")
NARROW_MAX_PAIRS = 2
NARROW_N_SUB = 1
NARROW_CLUSTER = 2
NARROW_MAX_M = 2        # kMaxM: m-tiles the backward takes
NARROW_MAX_KPW = 8      # kMaxKPW: k-steps of a backward warp's K part (its wh in registers)
WIDE_BWD_PLAN_ARGS = WIDE_PLAN_ARGS + ("recv_slots",)
# lstm_infer: pointers, (T, rows, H, save_residuals), the plan, the stream;
# lstm_bwd_bf16: pointers, (T, rows, H), the plan, the stream; the same for
# lstm_infer_wide and lstm_bwd_wide
INFER_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (4 + len(INFER_PLAN_ARGS))
                  + [ctypes.c_void_p])
BWD_BF16_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (3 + len(BWD_PLAN_ARGS))
                     + [ctypes.c_void_p])
INFER_WIDE_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (4 + len(WIDE_PLAN_ARGS))
                       + [ctypes.c_void_p])
BWD_WIDE_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (3 + len(WIDE_BWD_PLAN_ARGS))
                     + [ctypes.c_void_p])
# lstm_infer_narrow / lstm_bwd_narrow: the same with the narrow plan
INFER_NARROW_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (4 + len(NARROW_PLAN_ARGS))
                         + [ctypes.c_void_p])
BWD_NARROW_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (3 + len(NARROW_PLAN_ARGS))
                       + [ctypes.c_void_p])


# The f32-wh kernels (csrc/lstm_f32.cu): kKC, kTileRows, kMaxWarps, kPad,
# the instantiated units a block, and the cluster of two blocks (the
# forward's share each chunk of h by TMA multicast, the backward's split K).
F32_KC = 16             # k of a block of the operand: 64-byte lines of f32
F32_TILE_ROWS = 32      # rows of a consumer warp's tile
F32_MAX_WARPS = 16      # consumer warps (+ a producer warp)
F32_PAD = 4             # floats after each row of the partial tiles
F32_UNITS = (4, 8)
F32_CLUSTER = 2
F32_MIN_STAGES = 2      # ring slots a plan keeps at least (or every chunk of a step)
F32_CHUNKS = (4, 8, 16, 32, 64, 128)  # chunks a pass the plan tries, fewest first
F32_SLICES = (16, 8, 4, 2, 1)  # K slices the plan tries, most first
F32_PLAN_ARGS = ("units", "cluster", "row_groups", "rows_per_group", "row_tile", "k_slices",
                 "k_blocks", "stages", "smem_bytes")
# lstm_fwd_f32: pointers, (T, rows, H, save_residuals), the plan, the stream;
# lstm_bwd_f32: pointers, (T, rows, H), the plan, the stream
F32_FWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (4 + len(F32_PLAN_ARGS))
                    + [ctypes.c_void_p])
F32_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (3 + len(F32_PLAN_ARGS))
                    + [ctypes.c_void_p])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class MMAPlan:
    """Launch plan of a tensor-core LSTM kernel.

    ``kind`` "infer" (``csrc/lstm_infer.cu``: the product is rows x H times
    H x 4J; ``warps`` = m-tile columns x ``k_split`` K slices, the slices
    summed through shared memory) or "bwd" (``csrc/lstm_bwd.cu``: rows x 4H
    times 4H x J; every warp takes a K slice of all rows). Block u owns
    units [u J, u J + J), J = 8 n_sub, for every row. Each warp keeps ``m_group`` m-tiles of accumulators per pass and stages
    ``k_chunk`` k-steps per cp.async stage, ``stages`` deep."""
    kind: str
    rows: int
    H: int
    n_sub: int
    warps: int
    m_group: int
    k_chunk: int
    k_split: int = 1
    stages: int = MMA_STAGES

    @property
    def units_per_block(self) -> int:
        return 8 * self.n_sub

    @property
    def blocks(self) -> int:
        return _cdiv(self.H, self.units_per_block)

    @property
    def m_tiles(self) -> int:
        return _cdiv(self.rows, 16)

    @property
    def k_steps(self) -> int:
        return _cdiv(self.H if self.kind == "infer" else 4 * self.H, 16)

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def m_columns(self) -> int:
        """Warps that own m-tiles (the forward's K slice 0)."""
        return self.warps // self.k_split

    @property
    def smem_bytes(self) -> int:
        """wh's B fragments + each warp's cp.async ring (+ the backward's
        K-split partial tiles); the kernels compute the same."""
        ring = self.warps * self.stages * self.k_chunk * self.m_group * 512
        if self.kind == "infer":
            return (self.k_steps * 4 * self.n_sub * 256 + ring
                    + (self.k_split - 1) * self.m_columns * self.m_group * 4 * self.n_sub * 512)
        return (self.k_steps * self.n_sub * 256 + ring
                + self.warps * self.m_group * self.n_sub * 512)

    @property
    def ring_elems(self) -> int:
        """bf16 elements of the two-slot operand ring in mma fragment order."""
        return 2 * self.m_tiles * self.k_steps * 256

    @property
    def sm_bytes_per_step(self) -> int:
        """Bytes of the product's bf16 operand (h_{t-1} or da_t) one block
        takes into its SM a step: every block reads all rows and all of K."""
        return self.m_tiles * 16 * self.k_steps * 16 * 2

    @property
    def l2_bytes_per_step(self) -> int:
        """Bytes of that operand read from L2 a step over the grid."""
        return self.blocks * self.sm_bytes_per_step

    def args(self) -> Tuple[int, ...]:
        names = INFER_PLAN_ARGS if self.kind == "infer" else BWD_PLAN_ARGS
        return tuple(getattr(self, n) for n in names)


@dataclass(frozen=True)
class WidePlan:
    """Launch plan of a wide-row kernel (``lstm_infer_wide``,
    ``lstm_bwd_wide``): the rows split into ``row_groups`` groups of
    ``rows_per_group`` (a multiple of 64), the units into groups of
    ``units``, K into ``k_slices``; clusters of ``cluster`` blocks;
    ``warpgroups`` warpgroups a block, each taking every other 64-row m-tile
    of its group through a TMA ring ``stages`` deep.

    Forward ("infer"): block rg * UG + ug takes rows of group rg x units
    [16 ug, 16 ug + 16) (N = 64 gate columns) over all of K = H; the two
    blocks of a cluster (ug even and odd) share each h tile, each loading
    half its rows for both (TMA multicast). Backward ("bwd"): block
    2 (rg UG + ug) + kc takes rows of group rg x units [32 ug, 32 ug + 32)
    (N = 32) over K half kc of 4H; the two K halves of a cluster swap their
    partial dh tiles through distributed shared memory, and block kc owns
    units [32 ug + 16 kc, + 16). The backward receives the other half's
    tile of m-tile mt in slot mt % ``recv_slots``; with fewer slots than
    m-tiles a slot is refilled once its epilogue has read it."""
    kind: str
    rows: int
    H: int
    row_groups: int
    rows_per_group: int
    units: int
    k_slices: int
    cluster: int = WIDE_CLUSTER
    warpgroups: int = WIDE_WARPGROUPS
    stages: int = WIDE_STAGES
    recv_slots: int = 0

    @property
    def k_pad(self) -> int:
        """K padded: the forward's H to 64, the backward's 4H to 128 (two
        halves of 64-wide slabs)."""
        return _cdiv(self.H, 64) * 64 if self.kind == "infer" else _cdiv(4 * self.H, 128) * 128

    @property
    def unit_groups(self) -> int:
        ug = _cdiv(self.H, self.units)
        return _cdiv(ug, self.cluster) * self.cluster if self.kind == "infer" else ug

    @property
    def blocks(self) -> int:
        return self.row_groups * self.unit_groups * self.k_slices

    @property
    def warps(self) -> int:
        """Consumer warpgroups, a producer warp for each, and (the
        backward) an epilogue warpgroup."""
        return 5 * self.warpgroups + (4 if self.kind == "bwd" else 0)

    @property
    def m_tiles(self) -> int:
        """64-row m-tiles of a (full) row group."""
        return self.rows_per_group // WIDE_TILE_ROWS

    @property
    def multicast(self) -> int:
        """Blocks each A tile lands in (the forward's cluster; 1 in the backward)."""
        return self.cluster // self.k_slices

    @property
    def smem_bytes(self) -> int:
        """The kernels' layout: 1024 bytes of alignment slack, wh's B slabs,
        the warpgroups' A rings, then the forward's xw tiles or the
        backward's receive slots (the partial halves received, then the
        sums handed to its epilogue warpgroup), then the mbarriers (the
        backward's: full and empty a ring slot; received, summed and freed a
        receive slot)."""
        ring = self.warpgroups * self.stages * WIDE_TILE_ROWS * 128
        if self.kind == "infer":
            return (1024 + self.k_pad // 64 * 4 * self.units * 128 + ring
                    + self.warpgroups * 4 * WIDE_TILE_ROWS * self.units * 4
                    + 8 * self.warpgroups * (2 * self.stages + 1))
        return (1024 + self.k_pad // self.k_slices // 64 * self.units * 128 + ring
                + self.recv_slots * WIDE_RECV_BYTES
                + 8 * (2 * self.warpgroups * self.stages + 3 * self.recv_slots))

    @property
    def ring_rows(self) -> int:
        return self.row_groups * self.rows_per_group

    @property
    def ring_elems(self) -> int:
        """bf16 elements of the two-slot row-major operand ring [2, ring_rows, k_pad]."""
        return 2 * self.ring_rows * self.k_pad

    @property
    def sm_bytes_per_step(self) -> int:
        """Bytes of the product's bf16 operand one block takes into its SM a
        step: its rows x its K slice."""
        return self.rows_per_group * (self.k_pad // self.k_slices) * 2

    @property
    def l2_bytes_per_step(self) -> int:
        """Bytes of that operand read from L2 a step over the grid (a
        multicast tile is read once for its cluster)."""
        return self.blocks * self.sm_bytes_per_step // self.multicast

    def args(self) -> Tuple[int, ...]:
        names = WIDE_PLAN_ARGS if self.kind == "infer" else WIDE_BWD_PLAN_ARGS
        return tuple(getattr(self, n) for n in names)


@dataclass(frozen=True)
class NarrowPlan:
    """Launch plan of a narrow-row kernel (``lstm_infer_narrow``,
    ``lstm_bwd_narrow``): block b owns units [b J, b J + J), J = 8
    ``n_sub``, for every row, in clusters of ``cluster`` consecutive blocks
    (the grid padded to whole clusters); ``warps`` warps a block.

    Forward ("infer"): each block keeps its units' 4J gate columns of wh;
    cluster rank r copies k-steps [r P, r P + P) of h_{t-1} (P =
    ``piece_k_steps``) into every block of its cluster (bulk-copy multicast);
    warp w takes m-tile w % MT over K slice w / MT of ``k_split``.
    Backward ("bwd"): the cluster's C J units take the product over the C
    slices of K = 4H, rank r slice r (``piece_k_steps`` k-steps); warp w
    takes K part w of the slice (``k_split`` = ``warps`` parts) for every
    m-tile and every n-tile of the cluster's units, its wh fragments held in
    registers; the block sums its warps' partial tiles and stores each sum
    into the receive slot of the block that owns its units (distributed
    shared memory). Both read the
    two-slot bf16 ring of the mma.sync path, one grid barrier a step."""
    kind: str
    rows: int
    H: int
    n_sub: int
    cluster: int
    warps: int
    k_split: int

    @property
    def units_per_block(self) -> int:
        return 8 * self.n_sub

    @property
    def blocks(self) -> int:
        return _cdiv(_cdiv(self.H, self.units_per_block), self.cluster) * self.cluster

    @property
    def m_tiles(self) -> int:
        return _cdiv(self.rows, 16)

    @property
    def k_steps(self) -> int:
        return _cdiv(self.H if self.kind == "infer" else 4 * self.H, 16)

    @property
    def piece_k_steps(self) -> int:
        """k-steps of the piece a cluster rank copies (the forward) or of
        the K slice it multiplies (the backward); the last may be shorter."""
        return _cdiv(self.k_steps, self.cluster)

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def smem_bytes(self) -> int:
        """The kernels' layout: the forward's wh B fragments, the operand
        tile (in the forward also the sums of the partial tiles, once read),
        the warps' partial tiles, the backward's receive slots, the full
        mbarrier."""
        mt, nt = self.m_tiles, self.n_sub
        if self.kind == "infer":
            return (self.k_steps * 4 * nt * 256 + mt * max(self.k_steps, 4 * nt) * 512
                    + self.warps * 4 * nt * 512 + 8)
        ksc, c = self.piece_k_steps, self.cluster
        return mt * ksc * 512 + self.warps * mt * c * nt * 512 + c * mt * nt * 512 + 8

    @property
    def ring_elems(self) -> int:
        """bf16 elements of the two-slot operand ring in mma fragment order."""
        return 2 * self.m_tiles * self.k_steps * 256

    @property
    def sm_bytes_per_step(self) -> int:
        """Bytes of the product's bf16 operand one block takes into its SM
        a step: the whole h tile (the forward), its K slice of da_t (the
        backward)."""
        ks = self.k_steps if self.kind == "infer" else self.piece_k_steps
        return self.m_tiles * ks * 512

    @property
    def l2_bytes_per_step(self) -> int:
        """Bytes of that operand read from L2 a step over the grid: once a
        cluster (the forward's multicast pieces, the backward's slices)."""
        return self.blocks // self.cluster * self.m_tiles * self.k_steps * 512

    def args(self) -> Tuple[int, ...]:
        return tuple(getattr(self, n) for n in NARROW_PLAN_ARGS)


@dataclass(frozen=True)
class F32Plan:
    """Launch plan of an f32-wh kernel (``lstm_fwd_f32``, ``lstm_bwd_f32``):
    the rows split into ``row_groups`` groups of ``rows_per_group``, each
    taken in passes of ``row_tile`` rows (32-row tiles, one a consumer warp,
    times ``k_slices`` K slices, slice ks taking the 16-k blocks b = ks mod
    ``k_slices`` of K); ``units`` units a block, in clusters of ``cluster``
    blocks; the operand's rows come in chunks of ``k_blocks`` 16-k blocks
    (odd: conflict-free reads) through a TMA ring of ``stages`` slots that
    every consumer warp reads in order.

    Forward ("infer"): block rg UB + ub takes rows of group rg x units
    [J ub, J ub + J) over all of K = H; the two blocks of a cluster (ub even
    and odd) share each chunk, each loading half its rows for both (TMA
    multicast). Backward ("bwd"): block rg UB + 2 c + r takes rows of group
    rg x the cluster's units [2J c, 2J c + 2J) over K half r of 4H, and owns
    units [2J c + J r, + J); the two blocks swap their sums for each other's
    units through distributed shared memory. Consumer warp w takes tile w %
    (row_tile / 32) of a pass over K slice w / (row_tile / 32); the block
    sums the slices' partial tiles in slice order."""
    kind: str
    rows: int
    H: int
    units: int
    row_groups: int
    rows_per_group: int
    row_tile: int
    k_slices: int
    k_blocks: int
    stages: int
    cluster: int = F32_CLUSTER

    @property
    def unit_blocks(self) -> int:
        """Blocks of a row group (whole clusters)."""
        J, C = self.units, self.cluster
        if self.kind == "bwd":
            return C * _cdiv(self.H, C * J)
        return C * _cdiv(_cdiv(self.H, J), C)

    @property
    def blocks(self) -> int:
        return self.row_groups * self.unit_blocks

    @property
    def passes(self) -> int:
        return self.rows_per_group // self.row_tile

    @property
    def warps(self) -> int:
        """Consumer warps (the producer warp besides)."""
        return self.row_tile // F32_TILE_ROWS * self.k_slices

    @property
    def threads(self) -> int:
        return 32 * (self.warps + 1)

    @property
    def k16_blocks(self) -> int:
        """16-k blocks of a block's K: H (forward), its half 2H (backward)."""
        return _cdiv(self.H if self.kind == "infer" else 2 * self.H, F32_KC)

    @property
    def chunks(self) -> int:
        """Ring chunks of a pass: ``k_blocks`` 16-k blocks each."""
        return _cdiv(self.k16_blocks, self.k_blocks)

    @property
    def columns(self) -> int:
        """Columns of the block's product: 4J gate columns, the cluster's 2J units."""
        return 4 * self.units if self.kind == "infer" else 2 * self.units

    @property
    def smem_bytes(self) -> int:
        """The kernels' layout: 1024 bytes of alignment slack, the ring, wh's
        slice, the partial tiles, the backward's two receive buffers, the
        full and empty mbarriers."""
        RT, ncol = self.row_tile, self.columns
        return (1024 + self.stages * RT * self.k_blocks * F32_KC * 4
                + self.k16_blocks * F32_KC * ncol * 4 + self.k_slices * RT * (ncol + F32_PAD) * 4
                + (2 * RT * self.units * 4 if self.kind == "bwd" else 0) + 16 * self.stages)

    @property
    def sm_bytes_per_step(self) -> int:
        """Bytes of the product's f32 operand one block takes into its SM a
        step: its row group x its K (all of h_{t-1}'s H, or its half of da_t's
        4H), in whole chunks."""
        return self.rows_per_group * self.chunks * self.k_blocks * F32_KC * 4

    @property
    def l2_bytes_per_step(self) -> int:
        """Bytes of that operand read from L2 a step over the grid: the
        forward's chunk once a cluster (multicast), the backward's K halves
        once each."""
        share = self.cluster if self.kind == "infer" else 1
        return self.blocks * self.sm_bytes_per_step // share

    def args(self) -> Tuple[int, ...]:
        return tuple(getattr(self, n) for n in F32_PLAN_ARGS)


def f32_plan(kind: str, rows: int, H: int, nsm: int,
             max_blocks: Optional[int] = None) -> F32Plan:
    """The f32 kernels' plan of ``kind`` ("infer" or "bwd"): of the best
    plans with 4 and with 8 units a block (``_f32_plan_units``) whose unit
    blocks fit ``max_blocks`` (the blocks the card holds at once in pairs,
    ``f32_blocks``; by default ``nsm`` in whole pairs), the one with the
    least FMA work a block, then the fewest operand rows into a block a
    step (at 640 rows 8 units a block make two row groups: half the rows
    into each SM for the same products). Raises ValueError where none fits
    (H past 8 units a block on the card's blocks, or wh's slice past shared
    memory)."""
    if max_blocks is None:
        max_blocks = nsm // F32_CLUSTER * F32_CLUSTER
    plans = [p for p in (_f32_plan_units(kind, rows, H, J, max_blocks) for J in F32_UNITS) if p]
    if not plans:
        raise ValueError(f"lstm_{'seq' if kind == 'infer' else 'bwd'}: no f32 plan for rows "
                         f"{rows}, H {H} within {max_blocks} blocks (more than 8 units a block, "
                         "or wh's slice too large for one block's shared memory)")
    return min(plans, key=lambda p: (p.rows_per_group * p.units, p.rows_per_group))


def _f32_plan_units(kind: str, rows: int, H: int, J: int,
                    max_blocks: int) -> Optional[F32Plan]:
    """The best plan with ``J`` units a block, or None where its unit
    blocks pass ``max_blocks`` or no layout fits: as many row groups as fit
    beside the unit blocks, each a multiple of 32 rows (or up to an eighth
    more, where that divides into better passes). Of the layouts whose ring
    keeps ``F32_MIN_STAGES`` slots (or every chunk of a step) in shared
    memory: the most consumer warps (32 rows x ``F32_SLICES`` K slices
    within the 16-k blocks of K, at most 16 warps), then the fewest passes
    a step, then the fewest rows, then the fewest chunks a pass
    (``F32_CHUNKS``; a chunk the fewest odd 16-k blocks that make that
    many), each with the deepest ring that fits."""
    probe = F32Plan(kind, rows, H, J, 1, F32_TILE_ROWS, F32_TILE_ROWS, 1, 1, 1)
    if probe.unit_blocks > max_blocks:
        return None
    NC = probe.k16_blocks
    rg = min(max_blocks // probe.unit_blocks, _cdiv(rows, F32_TILE_ROWS))
    mt0 = _cdiv(_cdiv(rows, rg), F32_TILE_ROWS)
    best = None
    for mt in range(mt0, mt0 + mt0 // 8 + 1):
        mp = mt * F32_TILE_ROWS
        for passes in (p for p in range(1, mt + 1) if mt % p == 0 and mt // p <= F32_MAX_WARPS):
            for ks in F32_SLICES:
                if mt // passes * ks > F32_MAX_WARPS or ks > NC:
                    continue
                for nch in F32_CHUNKS:
                    kb = _cdiv(NC, nch) | 1  # odd
                    plan = F32Plan(kind, rows, H, J, _cdiv(rows, mp), mp, mp // passes, ks, kb, 1)
                    per_step = passes * plan.chunks
                    most = min((SMEM_MAX - plan.smem_bytes)
                               // (plan.row_tile * kb * F32_KC * 4 + 16) + 1, per_step)
                    if most < min(F32_MIN_STAGES, per_step):
                        continue
                    # more warps hide more latency: at 640 rows 16 warps whose
                    # chunks split unevenly over 4 K slices beat 12 that split
                    # them evenly over 3 (PERF.md)
                    score = (plan.warps, -passes, -mp, -plan.chunks)
                    if best is None or score > best[0]:
                        best = (score, dataclasses.replace(plan, stages=most))
                    break  # the fewest chunks that fit
    return best[1] if best is not None else None


def narrow_plan(kind: str, rows: int, H: int, nsm: int,
                max_blocks: Optional[int] = None) -> Optional[NarrowPlan]:
    """The narrow-row plan of ``kind`` ("infer" or "bwd"), if its grid of
    8-unit blocks in pairs fits ``max_blocks`` (the blocks the card holds at
    once in pairs, ``narrow_blocks``; by default ``nsm`` in whole pairs) and
    its layout fits shared memory with at most ``NARROW_MAX_PAIRS`` pairs a
    thread; the forward with 16 warps where they fit, else 8. None where
    none fits (too many rows for one block's shared memory, or too large a
    grid for the card)."""
    mt = _cdiv(rows, 16)
    if mt > (16 if kind == "infer" else NARROW_MAX_M):
        return None
    if max_blocks is None:
        max_blocks = nsm // NARROW_CLUSTER * NARROW_CLUSTER
    if kind == "infer":
        cands = [NarrowPlan(kind, rows, H, NARROW_N_SUB, NARROW_CLUSTER, mt * (w // mt), w // mt)
                 for w in (16, 8) if w >= mt]
    else:  # 16 warps, one K part each
        cands = [NarrowPlan(kind, rows, H, NARROW_N_SUB, NARROW_CLUSTER, MAX_WARPS, MAX_WARPS)]
    for p in cands:
        if (p.blocks <= max_blocks and p.smem_bytes <= SMEM_MAX
                and rows * p.units_per_block <= NARROW_MAX_PAIRS * p.threads
                and (kind == "infer" or _cdiv(p.piece_k_steps, p.warps) <= NARROW_MAX_KPW)):
            return p
    return None


def wide_plan(kind: str, rows: int, H: int, nsm: int) -> Optional[WidePlan]:
    """The wide-row plan of ``kind`` ("infer" or "bwd"): as many row groups
    as the SMs hold beside the unit groups (and K slices), each a multiple of
    64 rows, then the deepest ring that fits shared memory; the backward's
    with a receive slot for every m-tile where that fits, else with as many
    as fit beside the deepest ring (at least two). None where none fits (odd
    H, fewer SMs than one row group's blocks, or wh's slice beyond shared
    memory)."""
    if H % 2:
        return None
    units, k_slices = WIDE_UNITS[kind], (1 if kind == "infer" else WIDE_CLUSTER)
    probe = WidePlan(kind, rows, H, 1, WIDE_TILE_ROWS, units, k_slices)
    rg = min(nsm // (probe.unit_groups * k_slices), _cdiv(rows, WIDE_TILE_ROWS))
    if rg < 1:
        return None
    mp = _cdiv(_cdiv(rows, rg), WIDE_TILE_ROWS) * WIDE_TILE_ROWS
    plans = [WidePlan(kind, rows, H, _cdiv(rows, mp), mp, units, k_slices, stages=stages)
             for stages in range(WIDE_STAGES, 1, -1)]
    if kind == "bwd":
        mt = mp // WIDE_TILE_ROWS
        slots = lambda p: min(mt, (SMEM_MAX - p.smem_bytes) // (WIDE_RECV_BYTES + 24))
        plans = ([dataclasses.replace(p, recv_slots=mt) for p in plans]
                 + [dataclasses.replace(p, recv_slots=slots(p)) for p in plans
                    if slots(p) >= WIDE_WARPGROUPS])
    return next((p for p in plans if p.smem_bytes <= SMEM_MAX), None)


def _n_sub(H: int, nsm: int) -> int:
    """Fewest 8-unit n-tiles per gate so that the grid has <= nsm blocks."""
    nt = 1
    while _cdiv(H, 8 * nt) > nsm:
        nt += 1
    return nt


def _wide_or_raise(kind: str, rows: int, H: int, nsm: int) -> WidePlan:
    plan = wide_plan(kind, rows, H, nsm)
    if plan is None:
        raise ValueError(f"lstm_{'seq' if kind == 'infer' else 'bwd'}: no wide-row plan for "
                         f"rows {rows}, H {H} on {nsm} SMs (H odd, too few SMs for a row "
                         "group, or wh's slice too large for one block's shared memory)")
    return plan


def infer_plan(rows: int, H: int, nsm: int, save_residuals: bool = False,
               narrow_max_blocks: Optional[int] = None):
    """The forward's plan: from ``WIDE_MIN_ROWS`` rows the ``WidePlan``
    (raises where none fits), below it ``narrow_plan``'s (within
    ``narrow_max_blocks``), and where no narrow plan fits
    ``mma_infer_plan``'s."""
    if rows >= WIDE_MIN_ROWS["infer"]:
        return _wide_or_raise("infer", rows, H, nsm)
    return (narrow_plan("infer", rows, H, nsm, narrow_max_blocks)
            or mma_infer_plan(rows, H, nsm, save_residuals))


def mma_infer_plan(rows: int, H: int, nsm: int, save_residuals: bool = False) -> MMAPlan:
    """The forward's mma.sync plan: every block takes all rows. Up to 16 m-tile
    columns, each warp owning every WM-th m-tile; when there are fewer than
    16 m-tiles, the spare warps split K instead. The most m-tiles a pass
    that the kernel was built for (``INFER_VARIANTS``, or
    ``RESID_VARIANTS`` with ``save_residuals``), then the deepest pipeline
    stage (k_chunk <= 4) that fits. Raises when no instantiated plan fits."""
    nt = _n_sub(H, nsm)
    mt = _cdiv(rows, 16)
    wm = min(MAX_WARPS, mt)
    wk = min(MAX_WARPS // wm, _cdiv(H, 16))
    variants = RESID_VARIANTS if save_residuals else INFER_VARIANTS
    for mg in range(min(4 // nt, _cdiv(mt, wm)), 0, -1):
        for ck in range(4, 0, -1):
            plan = MMAPlan("infer", rows, H, nt, wm * wk, mg, ck, wk)
            if (nt, mg) in variants and plan.smem_bytes <= SMEM_MAX:
                return plan
    raise ValueError(f"lstm_seq: no tensor-core plan for rows {rows}, H {H} on {nsm} SMs "
                     "(H too large for one block's shared memory)")


def bwd_plan(B: int, H: int, nsm: int, narrow_max_blocks: Optional[int] = None):
    """The backward's plan: from ``WIDE_MIN_ROWS`` rows the ``WidePlan``
    (raises where none fits), below it ``narrow_plan``'s (within
    ``narrow_max_blocks``), and where no narrow plan fits
    ``mma_bwd_plan``'s."""
    if B >= WIDE_MIN_ROWS["bwd"]:
        return _wide_or_raise("bwd", B, H, nsm)
    return narrow_plan("bwd", B, H, nsm, narrow_max_blocks) or mma_bwd_plan(B, H, nsm)


def mma_bwd_plan(B: int, H: int, nsm: int) -> MMAPlan:
    """The backward's mma.sync plan: all rows in every block, warps split
    the 4H reduction (up to 16), the largest m-tile pass (<= 4) and then the
    deepest pipeline stage (k_chunk <= 4 / m_group) that fit."""
    nt = _n_sub(H, nsm)
    W = min(MAX_WARPS, _cdiv(4 * H, 16))
    for mg in range(min(4, _cdiv(B, 16)), 0, -1):
        for ck in range(4 // mg, 0, -1):
            plan = MMAPlan("bwd", B, H, nt, W, mg, ck)
            if (nt, mg) in BWD_VARIANTS and plan.smem_bytes <= SMEM_MAX:
                return plan
    raise ValueError(f"lstm_bwd: no tensor-core plan for B {B}, H {H} on {nsm} SMs "
                     "(H too large for one block's shared memory)")


def plan_owners(plan) -> np.ndarray:
    """[rows * H, 3] int array: for each (row, unit) pair of the plan's
    problem (row-major), the (block, warp, count) that the kernel assigns
    it, where count is how many (block, warp) own it (1 when the plan is a
    partition). Mirrors the kernels' index arithmetic."""
    rows, H = plan.rows, plan.H
    owner = np.full((rows, H, 2), -1, np.int64)
    count = np.zeros((rows, H), np.int64)

    def own(r, u, b, w):
        ok = (r < rows) & (u < H)
        r, u = r[ok], u[ok]
        np.add.at(count, (r, u), 1)
        owner[r, u, 0], owner[r, u, 1] = b, (w[ok] if np.ndim(w) else w)

    if isinstance(plan, F32Plan):
        # block (rg, ub); the pass's pair pp = (row pp / J, unit pp % J) goes
        # to consumer thread pp % (32 warps), warp (pp % (32 warps)) / 32
        J, ub_n, nthr = plan.units, plan.unit_blocks, 32 * plan.warps
        pp = np.arange(plan.row_tile * J)
        for rg in range(plan.row_groups):
            for ub in range(ub_n):
                b = rg * ub_n + ub
                for p in range(plan.passes):
                    r = rg * plan.rows_per_group + p * plan.row_tile + pp // J
                    own(r, ub * J + pp % J, b, (pp % nthr) // 32)
        return np.concatenate([owner.reshape(-1, 2), count.reshape(-1, 1)], axis=1)
    if isinstance(plan, NarrowPlan):
        # block b's pairs p = tid + i threads: row p / J, unit b J + p % J;
        # the warp is tid / 32
        J = plan.units_per_block
        p = np.arange(rows * J)
        for b in range(plan.blocks):
            own(p // J, b * J + p % J, b, (p % plan.threads) // 32)
        return np.concatenate([owner.reshape(-1, 2), count.reshape(-1, 1)], axis=1)
    if isinstance(plan, WidePlan):
        # block (rg, ug[, kc]); the forward's pair: warp (row % 64) / 16 of the
        # consumer warpgroup mt % 2 of its m-tile mt; the backward's: that warp
        # of the epilogue warpgroup (after the consumer and producer warps)
        owned = plan.units // plan.k_slices
        for rg in range(plan.row_groups):
            r = np.arange(rg * plan.rows_per_group, (rg + 1) * plan.rows_per_group)
            mt = (r % plan.rows_per_group) // WIDE_TILE_ROWS
            first = (mt % plan.warpgroups) * 4 if plan.kind == "infer" else 5 * plan.warpgroups
            warp = first + (r % WIDE_TILE_ROWS) // 16
            for ug in range(plan.unit_groups):
                for kc in range(plan.k_slices):
                    b = (rg * plan.unit_groups + ug) * plan.k_slices + kc
                    first_unit = ug * plan.units + kc * owned
                    units = np.arange(first_unit, first_unit + owned)
                    rr, uu = np.meshgrid(r, units, indexing="ij")
                    ww = np.broadcast_to(warp[:, None], rr.shape)
                    own(rr.ravel(), uu.ravel(), b, ww.ravel())
        return np.concatenate([owner.reshape(-1, 2), count.reshape(-1, 1)], axis=1)
    J = plan.units_per_block
    if plan.kind == "infer":
        for b in range(plan.blocks):
            units = np.arange(b * J, b * J + J)
            for w in range(plan.m_columns):  # K slice 0 owns the pairs
                for mt in range(w, plan.m_tiles, plan.m_columns):
                    r, u = np.meshgrid(np.arange(mt * 16, mt * 16 + 16), units, indexing="ij")
                    own(r.ravel(), u.ravel(), b, w)
    else:
        s = np.arange(plan.m_group * plan.n_sub * 128)
        c, lane, nt, m = s & 3, (s >> 2) & 31, (s >> 7) % plan.n_sub, (s >> 7) // plan.n_sub
        for b in range(plan.blocks):
            for mt0 in range(0, plan.m_tiles, plan.m_group):
                r = (mt0 + m) * 16 + (lane >> 2) + 8 * (c >> 1)
                u = b * J + nt * 8 + 2 * (lane & 3) + (c & 1)
                own(r, u, b, (s % plan.threads) // 32)
    return np.concatenate([owner.reshape(-1, 2), count.reshape(-1, 1)], axis=1)


def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def narrow_blocks(device: torch.device, kind: str, save_residuals: bool = False) -> int:
    """Blocks of the narrow-row kernel of ``kind`` ("infer" with or without
    residuals, or "bwd") that the card holds at once in pairs, at the most
    shared memory a block may take (``cudaOccupancyMaxActiveClusters``;
    ``narrow_plan``'s ``max_blocks``). One query a device and kernel."""
    fn = "lstm_infer_narrow_blocks" if kind == "infer" else "lstm_bwd_narrow_blocks"
    lib = build.library("lstm_infer" if kind == "infer" else "lstm_bwd")
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = (getattr(lib, fn)(int(save_residuals), ctypes.byref(blocks)) if kind == "infer"
               else getattr(lib, fn)(ctypes.byref(blocks)))
    build.check(lib, err, fn)
    return blocks.value


@functools.lru_cache(maxsize=None)
def f32_blocks(device: torch.device, kind: str) -> int:
    """Blocks of the f32 kernel of ``kind`` ("infer" or "bwd") that the card
    holds at once in pairs, at the most shared memory and threads a block
    may take (``cudaOccupancyMaxActiveClusters``; ``f32_plan``'s
    ``max_blocks``), the least over the instantiated units a block. One
    query a device and kind."""
    lib = build.library("lstm_f32")
    blocks, least = ctypes.c_int(0), None
    with torch.cuda.device(device):
        for J in F32_UNITS:
            err = lib.lstm_f32_blocks(int(kind == "bwd"), J, ctypes.byref(blocks))
            build.check(lib, err, "lstm_f32_blocks")
            least = blocks.value if least is None else min(least, blocks.value)
    return least


def f32_device_plan(kind: str, rows: int, H: int, device: torch.device) -> F32Plan:
    """The plan the f32 wrappers launch for ``kind`` ("infer" or "bwd") on
    ``device``: ``f32_plan`` within the blocks the card holds in pairs
    (``f32_blocks``)."""
    return f32_plan(kind, rows, H, _num_sms(device), f32_blocks(device, kind))


def lstm_seq_plain(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor,
                   save_residuals: bool = False) -> Tuple[torch.Tensor, ...]:
    """xw [T, B, 4H] f32 (input projection incl. biases), mask [T, B] f32,
    wh [H, 4H] f32 or bf16, h0/c0 [B, H] f32.

    Returns ``(hs [T, B, H], hT, cT)``, or with ``save_residuals``
    ``(hs, cs [T, B, H], gates [T, B, 4H], hT, cT)`` where ``gates`` are
    the activations (i, f, g, o)."""
    T, B, H4 = xw.shape
    H = H4 // 4
    whf = wh.float()
    h, c = h0, c0
    hs, cs, gates = [], [], []
    for t in range(T):
        a = xw[t] + h.to(wh.dtype).float() @ whf
        i, f, g, o = a.split(H, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c_raw = f * c + i * g
        h_raw = o * torch.tanh(c_raw)
        m = mask[t, :, None]
        h = m * h_raw + (1.0 - m) * h
        c = m * c_raw + (1.0 - m) * c
        hs.append(h)
        if save_residuals:
            cs.append(c)
            gates.append(torch.cat([i, f, g, o], dim=-1))
    empty = xw.new_zeros((0, B, H))
    hs_t = torch.stack(hs) if hs else empty
    if save_residuals:
        return (hs_t, torch.stack(cs) if cs else empty,
                torch.stack(gates) if gates else xw.new_zeros((0, B, H4)), h, c)
    return hs_t, h, c


def lstm_bwd_plain(gates: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                   c_prev: torch.Tensor, dhs: torch.Tensor, dhT: torch.Tensor,
                   dcT: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse sweep of ``_bwd_kernel``, step by step.

    gates [T, B, 4H] (activations i, f, g, o), mask [T, B], wh [H, 4H],
    c_prev [T, B, H] (the kept c_{t-1}, c0 first), dhs [T, B, H] (grads of
    hs), dhT/dcT [B, H]. Returns ``(da [T, B, 4H], dh0, dc0)``: the grads of
    the gate pre-activations and of the initial state."""
    T, B, H4 = gates.shape
    H = H4 // 4
    whf = wh.float()
    dh, dc = dhT, dcT
    da = gates.new_zeros((T, B, H4))
    for t in reversed(range(T)):
        i, f, g, o = gates[t].split(H, dim=-1)
        cp = c_prev[t]
        tanh_c = torch.tanh(f * cp + i * g)
        dhk = dh + dhs[t]
        dck = dc
        m = mask[t, :, None]
        dh_raw = m * dhk
        dc_raw = m * dck
        do = dh_raw * tanh_c
        dc_tot = dc_raw + dh_raw * o * (1.0 - tanh_c * tanh_c)
        di = dc_tot * g
        df = dc_tot * cp
        dg = dc_tot * i
        a = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g),
                       do * o * (1.0 - o)], dim=-1)
        da[t] = a
        # grads flowing to the previous step's kept state
        dh = a.to(wh.dtype).float() @ whf.T + (1.0 - m) * dhk
        dc = dc_tot * f + (1.0 - m) * dck
    return da, dh, dc


def _lib(name: str, argtypes, source: Optional[str] = None) -> ctypes.CDLL:
    """The library of ``csrc/<source or name>.cu`` with the C function
    ``name`` typed."""
    lib = build.library(source or name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(what: str, seq: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
           state: Tuple[torch.Tensor, ...], f32: Tuple[torch.Tensor, ...]) -> None:
    """Device, shape and dtype checks shared by the CUDA wrappers: ``seq``
    is [T, B, 4H], ``state`` are [B, H] and ``f32`` must be float32."""
    T, B, H4 = seq.shape
    H = H4 // 4
    if H4 != 4 * H or tuple(wh.shape) != (H, H4) or tuple(mask.shape) != (T, B) \
            or any(tuple(a.shape) != (B, H) for a in state):
        raise ValueError(f"{what}: bad shapes {tuple(seq.shape)} mask {tuple(mask.shape)} "
                         f"wh {tuple(wh.shape)} state {[tuple(a.shape) for a in state]}")
    if any(a.dtype != torch.float32 for a in f32) or wh.dtype not in (torch.float32,
                                                                        torch.bfloat16):
        raise TypeError(f"{what}: activations and state must be float32, wh float32 "
                        "or bfloat16")
    if any(a.device != seq.device for a in (mask, wh, *f32)):
        raise ValueError(f"{what}: all inputs must be on one device")


def lstm_seq(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
             h0: torch.Tensor, c0: torch.Tensor,
             save_residuals: bool = False) -> Tuple[torch.Tensor, ...]:
    """Same contract as ``lstm_seq_plain``; launches the CUDA kernel for
    CUDA tensors. Takes no gradient itself (``LSTMSeqFn`` does)."""
    if xw.device.type == "cpu":
        return lstm_seq_plain(xw, mask, wh, h0, c0, save_residuals)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_seq: unsupported device {xw.device}")
    _check("lstm_seq", xw, mask, wh, (h0, c0), (xw, mask, h0, c0))
    T, B, H4 = xw.shape
    H = H4 // 4
    if T == 0:
        return lstm_seq_plain(xw, mask, wh, h0, c0, save_residuals)
    xw, mask, wh, h0, c0 = (a.contiguous() for a in (xw, mask, wh, h0, c0))
    if wh.dtype == torch.bfloat16:
        plan = infer_plan(B, H, _num_sms(xw.device), save_residuals,
                          narrow_blocks(xw.device, "infer", save_residuals))
        return lstm_infer(xw, mask, wh, h0, c0, plan, save_residuals)
    return lstm_fwd_f32(xw, mask, wh, h0, c0, f32_device_plan("infer", B, H, xw.device),
                        save_residuals)


def lstm_fwd_f32(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
                 c0: torch.Tensor, plan: F32Plan,
                 save_residuals: bool = False) -> Tuple[torch.Tensor, ...]:
    """The f32 forward on ``csrc/lstm_f32.cu`` with ``plan`` (``f32_plan``):
    ``(hs, hT, cT)``, or with ``save_residuals`` ``(hs, cs, gates, hT,
    cT)``. Takes contiguous CUDA tensors that passed ``lstm_seq``'s checks;
    ``lstm_seq`` calls it."""
    T, B, H4 = xw.shape
    H = H4 // 4
    if (plan.kind, plan.rows, plan.H) != ("infer", B, H) or wh.dtype != torch.float32:
        raise ValueError(f"lstm_fwd_f32: plan {plan} does not fit rows {B}, H {H}, wh {wh.dtype}")
    hs = torch.empty((T, B, H), device=xw.device)
    hT = torch.empty((B, H), device=xw.device)
    cT = torch.empty((B, H), device=xw.device)
    cs = torch.empty((T, B, H), device=xw.device) if save_residuals else None
    gates = torch.empty((T, B, H4), device=xw.device) if save_residuals else None
    ring = torch.zeros((2, B, plan.k16_blocks * F32_KC), device=xw.device)
    lib = _lib("lstm_fwd_f32", F32_FWD_ARGTYPES, source="lstm_f32")
    with torch.cuda.device(xw.device):
        err = lib.lstm_fwd_f32(
            xw.data_ptr(), mask.data_ptr(), wh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), cs.data_ptr() if save_residuals else None,
            gates.data_ptr() if save_residuals else None, hT.data_ptr(), cT.data_ptr(),
            ring.data_ptr(), T, B, H, int(save_residuals), *plan.args(),
            torch.cuda.current_stream(xw.device).cuda_stream)
    build.check(lib, err, "lstm_fwd_f32")
    build.LAUNCHES["lstm_fwd_residuals_f32" if save_residuals else "lstm_fwd_infer_f32"] += 1
    if save_residuals:
        return hs, cs, gates, hT, cT
    return hs, hT, cT


def lstm_infer(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, plan, save_residuals: bool = False) -> Tuple[torch.Tensor, ...]:
    """The bf16 forward on ``csrc/lstm_infer.cu`` with ``plan``
    (``infer_plan``: an ``MMAPlan`` launches ``lstm_infer``, a ``WidePlan``
    ``lstm_infer_wide``): ``(hs, hT, cT)``, or with ``save_residuals``
    ``(hs, cs, gates, hT, cT)``. Takes contiguous CUDA tensors that passed
    ``lstm_seq``'s checks; ``lstm_seq`` calls it."""
    T, B, H4 = xw.shape
    H = H4 // 4
    if (plan.kind, plan.rows, plan.H) != ("infer", B, H) or wh.dtype != torch.bfloat16:
        raise ValueError(f"lstm_infer: plan {plan} does not fit rows {B}, H {H}, wh {wh.dtype}")
    hs = torch.empty((T, B, H), device=xw.device)
    hT = torch.empty((B, H), device=xw.device)
    cT = torch.empty((B, H), device=xw.device)
    cs = torch.empty((T, B, H), device=xw.device) if save_residuals else None
    gates = torch.empty((T, B, H4), device=xw.device) if save_residuals else None
    ring = torch.zeros(plan.ring_elems, device=xw.device, dtype=torch.bfloat16)
    fn, argtypes = {WidePlan: ("lstm_infer_wide", INFER_WIDE_ARGTYPES),
                    NarrowPlan: ("lstm_infer_narrow", INFER_NARROW_ARGTYPES),
                    MMAPlan: ("lstm_infer", INFER_ARGTYPES)}[type(plan)]
    lib = _lib(fn, argtypes, source="lstm_infer")
    with torch.cuda.device(xw.device):
        err = getattr(lib, fn)(
            xw.data_ptr(), mask.data_ptr(), wh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), cs.data_ptr() if save_residuals else None,
            gates.data_ptr() if save_residuals else None, hT.data_ptr(), cT.data_ptr(),
            ring.data_ptr(), T, B, H, int(save_residuals), *plan.args(),
            torch.cuda.current_stream(xw.device).cuda_stream)
    build.check(lib, err, fn)
    build.LAUNCHES["lstm_fwd_residuals" if save_residuals else "lstm_fwd_infer"] += 1
    if save_residuals:
        return hs, cs, gates, hT, cT
    return hs, hT, cT


def lstm_bwd(gates: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
             c_prev: torch.Tensor, dhs: torch.Tensor, dhT: torch.Tensor,
             dcT: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as ``lstm_bwd_plain``; launches the CUDA kernel for
    CUDA tensors: with bf16 ``wh`` ``lstm_bwd_bf16`` under ``bwd_plan``'s
    plan, with f32 ``wh`` ``lstm_bwd_f32`` under ``f32_plan``'s."""
    if gates.device.type == "cpu":
        return lstm_bwd_plain(gates, mask, wh, c_prev, dhs, dhT, dcT)
    if gates.device.type != "cuda":
        raise ValueError(f"lstm_bwd: unsupported device {gates.device}")
    _check("lstm_bwd", gates, mask, wh, (dhT, dcT), (gates, mask, dhT, dcT, c_prev, dhs))
    T, B, H4 = gates.shape
    H = H4 // 4
    if tuple(c_prev.shape) != (T, B, H) or tuple(dhs.shape) != (T, B, H):
        raise ValueError(f"lstm_bwd: bad shapes c_prev {tuple(c_prev.shape)} dhs "
                         f"{tuple(dhs.shape)}")
    if T == 0:
        return lstm_bwd_plain(gates, mask, wh, c_prev, dhs, dhT, dcT)
    args = tuple(a.contiguous() for a in (gates, mask, wh, c_prev, dhs, dhT, dcT))
    if wh.dtype == torch.bfloat16:
        return lstm_bwd_bf16(*args, bwd_plan(B, H, _num_sms(gates.device),
                                             narrow_blocks(gates.device, "bwd")))
    return lstm_bwd_f32(*args, f32_device_plan("bwd", B, H, gates.device))


def lstm_bwd_f32(gates: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                 c_prev: torch.Tensor, dhs: torch.Tensor, dhT: torch.Tensor,
                 dcT: torch.Tensor,
                 plan: F32Plan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The f32 backward on ``csrc/lstm_f32.cu`` with ``plan`` (``f32_plan``):
    ``(da, dh0, dc0)``. Takes contiguous CUDA tensors that passed
    ``lstm_bwd``'s checks; ``lstm_bwd`` calls it."""
    T, B, H4 = gates.shape
    H = H4 // 4
    if (plan.kind, plan.rows, plan.H) != ("bwd", B, H) or wh.dtype != torch.float32:
        raise ValueError(f"lstm_bwd_f32: plan {plan} does not fit B {B}, H {H}, wh {wh.dtype}")
    da, dh0, dc0 = _bwd_outputs(T, B, H, gates.device)
    ring = torch.zeros((2, 2, B, plan.k16_blocks * F32_KC), device=gates.device)
    lib = _lib("lstm_bwd_f32", F32_BWD_ARGTYPES, source="lstm_f32")
    with torch.cuda.device(gates.device):
        err = lib.lstm_bwd_f32(
            *(a.data_ptr() for a in (gates, mask, wh, c_prev, dhs, dhT, dcT, da, ring, dh0, dc0)),
            T, B, H, *plan.args(), torch.cuda.current_stream(gates.device).cuda_stream)
    build.check(lib, err, "lstm_bwd_f32")
    build.LAUNCHES["lstm_bwd_f32"] += 1
    return da, dh0, dc0


def _bwd_outputs(T: int, B: int, H: int, device) -> Tuple[torch.Tensor, ...]:
    return (torch.empty((T, B, 4 * H), device=device), torch.empty((B, H), device=device),
            torch.empty((B, H), device=device))


def lstm_bwd_bf16(gates: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                  c_prev: torch.Tensor, dhs: torch.Tensor, dhT: torch.Tensor,
                  dcT: torch.Tensor, plan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 backward on ``csrc/lstm_bwd.cu`` with ``plan``
    (``bwd_plan``: an ``MMAPlan`` launches ``lstm_bwd_bf16``, a ``WidePlan``
    ``lstm_bwd_wide``): ``(da, dh0, dc0)``. Takes contiguous CUDA tensors
    that passed ``lstm_bwd``'s checks; ``lstm_bwd`` calls it."""
    T, B, H4 = gates.shape
    H = H4 // 4
    if (plan.kind, plan.rows, plan.H) != ("bwd", B, H) or wh.dtype != torch.bfloat16:
        raise ValueError(f"lstm_bwd: plan {plan} does not fit B {B}, H {H}, wh {wh.dtype}")
    da, dh0, dc0 = _bwd_outputs(T, B, H, gates.device)
    ring = torch.zeros(plan.ring_elems, device=gates.device, dtype=torch.bfloat16)
    fn, argtypes = {WidePlan: ("lstm_bwd_wide", BWD_WIDE_ARGTYPES),
                    NarrowPlan: ("lstm_bwd_narrow", BWD_NARROW_ARGTYPES),
                    MMAPlan: ("lstm_bwd_bf16", BWD_BF16_ARGTYPES)}[type(plan)]
    lib = _lib(fn, argtypes, source="lstm_bwd")
    with torch.cuda.device(gates.device):
        err = getattr(lib, fn)(
            *(a.data_ptr() for a in (gates, mask, wh, c_prev, dhs, dhT, dcT, da)),
            ring.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), T, B, H, *plan.args(),
            torch.cuda.current_stream(gates.device).cuda_stream)
    build.check(lib, err, "lstm_bwd")
    build.LAUNCHES["lstm_bwd"] += 1
    return da, dh0, dc0


class LSTMSeqFn(torch.autograd.Function):
    """``(hs, hT, cT) = LSTMSeqFn.apply(xw, mask, wh, h0, c0)`` with the
    gradient of ``_fused_bwd``: dxw = da, dwh = (h_prev^T da) in wh's dtype
    (f32 accumulation), dh0, dc0; mask takes none. The residual-saving
    forward and the backward sweep go through ``lstm_seq`` and ``lstm_bwd``,
    so a CUDA input launches both kernels and a CPU input runs both plain
    versions."""

    @staticmethod
    def forward(ctx, xw, mask, wh, h0, c0):
        hs, cs, gates, hT, cT = lstm_seq(xw, mask, wh, h0, c0, save_residuals=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(mask, wh, h0, c0, hs, cs, gates)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        mask, wh, h0, c0, hs, cs, gates = ctx.saved_tensors
        h_prev = torch.cat([h0[None], hs[:-1]], dim=0)
        c_prev = torch.cat([c0[None], cs[:-1]], dim=0)
        da, dh0, dc0 = lstm_bwd(gates, mask, wh, c_prev,
                                torch.zeros_like(hs) if dhs is None else dhs,
                                torch.zeros_like(h0) if dhT is None else dhT,
                                torch.zeros_like(c0) if dcT is None else dcT)
        H = wh.shape[0]
        dwh = (h_prev.reshape(-1, H).T @ da.reshape(-1, 4 * H)).to(wh.dtype)
        return da, None, dwh, dh0, dc0
