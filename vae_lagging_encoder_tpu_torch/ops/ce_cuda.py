"""Fused vocab projection + cross-entropy: CUDA kernel + plain version +
the autograd Function.

``ce_forward`` is the port's counterpart of the JAX package's Pallas kernel
``ops/ce_pallas.py::_ce_kernel``: per row
``logp[n] = (h W)[n, tgt[n]] - logsumexp_v (h W)[n, v]`` without an
``[N, V]`` logits array. With ``save_logits`` it is the kernel's grad mode
(``save_logits=True``): it also returns the logits rounded to the operand
type as the backward's residual, and as ``lse`` the logsumexp of those
rounded logits (``s2``), so each backward softmax row sums to exactly 1.
On a CUDA tensor it launches ``csrc/ce_fwd.cu`` (counted as ``ce_fwd`` or
``ce_fwd_train``; raises on what the kernel does not take); on a CPU
tensor it runs ``ce_logp_plain``. With bf16 operands (the main paths) the
kernel runs on the tensor cores (wgmma, TMA, clusters of two blocks that
share W^T by multicast, persistent over the card's clusters) under the
launch plan ``ce_plan``, which the kernel checks; it reads h in bf16 as it
is (a copy only where a row is not 16-byte aligned), packs W (f32 or bf16)
into a zero-padded K-major bf16 copy W^T [Vp, Kp] itself, and spills into
[N, Vp], returned as the [:, :V] view. A card without a plan (no cluster
of two blocks resident) raises.

``ce_backward`` is the counterpart of ``_fused_ce_bwd`` (which the JAX
package leaves to XLA as two dots): from the grad-mode residuals,
d = bf16((onehot - exp(spill - lse)) * g), dh = d W^T and dW = h^T d with
bf16 operands, f32 accumulation and f32 output. On a CUDA tensor with bf16
operands it launches ``csrc/ce_bwd.cu`` (counted as ``ce_bwd``; raises on
what the kernel does not take) under the launch plan ``ce_bwd_plan``: one
elementwise pass writes d [N, Vp] in bf16, then both products run on the
tensor cores (wgmma, TMA), dh's K split over blocks at small N and merged
in a fixed order; no f32 [N, V] tensor is made. It reads the forward's own
bf16 operands (h [N, ldh] and the packed W^T [Vp, Kp]), which
``_ce_forward`` returns beside its outputs and ``FusedCEFn`` keeps. On a
CPU tensor, and for f32 operands on either device, it runs
``ce_backward_plain``.

``FusedCEFn`` is the counterpart of ``_fused_ce`` with its
``_fused_ce_fwd``/``_fused_ce_bwd``: ``ce_forward`` in grad mode, then
``ce_backward`` on what it saved.

``operand_dtype`` rounds h and W before the product, with f32 accumulation:
``torch.bfloat16`` is the JAX package's default ``mxu_dtype``
(``fused_ce_logp``), ``None`` keeps f32 operands (the f32 checks).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from fractions import Fraction
from typing import List, Optional, Tuple

import torch

from . import build

PLAIN_ROW_CHUNK = 8192  # rows of [rows, V] logits the plain version holds at once

# --------------------------------------------------------------- launch plan
# Constants the bf16 kernel is built for (csrc/ce_fwd.cu: kWarpgroups, kBN,
# kBK, kStages, kCluster, kAlign); tests/test_torch_port_ce_plan.py reads
# them back.
CE_WARPGROUPS = 2       # consumer warpgroups of 64 rows a block
CE_BLOCK_N = 256        # vocab columns of a tile (wgmma n); ce_bwd's too
CE_BLOCK_K = 64         # K slab: 128 bytes of bf16, the 128-byte swizzle
CE_STAGES = 4           # ring depth
CE_CLUSTER = 2          # blocks of a cluster: the two row tiles of a row group
CE_ALIGN = 1024         # alignment of the swizzled tiles
# ctypes order of the plan fields after the layout, as the C entry point names them
CE_PLAN_ARGS = ("block_m", "block_n", "block_k", "stages", "cluster", "clusters", "slots",
                "smem_bytes")
_BF16_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * (8 + len(CE_PLAN_ARGS))
                  + [ctypes.c_void_p])
_F32_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# Constants the backward kernel is built for (csrc/ce_bwd.cu: kWarpgroups,
# kBN, kBK, kStages; the ring aligned like the forward's, CE_ALIGN);
# tests/test_torch_port_ce_bwd.py reads them back.
CE_BWD_WARPGROUPS = 2     # consumer warpgroups of 64 rows (and one producer warp)
CE_BWD_BLOCK_N = 256      # output columns a tile (wgmma n)
CE_BWD_BLOCK_K = 64       # K slab: 128 bytes of bf16, one TMA box row
CE_BWD_STAGES = 4         # TMA ring depth
CE_BWD_SPLIT_MAX = 8      # most blocks one dh tile's K is split over
CE_BWD_PLAN_ARGS = ("block_m", "block_n", "block_k", "stages", "splits", "dh_blocks",
                    "dw_blocks", "smem_bytes")
_BWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9
                 + [ctypes.c_int] * (6 + len(CE_BWD_PLAN_ARGS)) + [ctypes.c_void_p])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


@dataclass(frozen=True)
class CEPlan:
    """Launch plan of the bf16 CE kernel for h [N, nh], W [nh, V].

    A block's tile is ``block_m`` rows (two warpgroups of 64) x ``block_n``
    vocab columns; a unit is a row group (``group_rows``: the row tiles of a
    cluster's two blocks) x one vocab tile, and the ``units`` are numbered
    row group major. The grid is ``clusters`` persistent clusters (at most
    what the card holds at once), and cluster c walks the contiguous units
    ``unit_range(c)``, so a row group's vocab tiles may be split between
    clusters at any tile (``segments``). Within a row group the vocab tiles
    are visited from ``origin``: the clusters resident together walk the
    same W^T columns at about the same time. Each (cluster c, row group rg)
    segment writes its partials at slot ``c + rg`` of part [4, ``slots``,
    ``group_rows``]; the merge sums a row's partials in cluster order
    (``merge_order``). Operands: h read in place with row stride ``ldh`` (a
    zero-padded copy when nh is not a multiple of 8), W as W^T ``[Vp, Kp]``
    zero-padded to whole tiles and K slabs (ce_bwd reads it too); the
    grad-mode spill is ``[N, Vp]``. Shared memory: a ring of
    ``stages`` slabs, each the block's rows of h and the W^T slab."""
    N: int
    nh: int
    V: int
    clusters: int
    block_m: int = 64 * CE_WARPGROUPS
    block_n: int = CE_BLOCK_N
    block_k: int = CE_BLOCK_K
    stages: int = CE_STAGES
    cluster: int = CE_CLUSTER

    @property
    def group_rows(self) -> int:
        return self.block_m * self.cluster

    @property
    def row_groups(self) -> int:
        return _cdiv(self.N, self.group_rows)

    @property
    def vocab_tiles(self) -> int:
        return _cdiv(self.V, self.block_n)

    @property
    def units(self) -> int:
        return self.row_groups * self.vocab_tiles

    @property
    def Vp(self) -> int:
        return self.vocab_tiles * self.block_n

    @property
    def Kp(self) -> int:
        return _round_up(self.nh, self.block_k)

    @property
    def ldh(self) -> int:
        return _round_up(self.nh, 8)

    @property
    def blocks(self) -> int:
        return self.clusters * self.cluster

    @property
    def slots(self) -> int:
        return self.clusters + self.row_groups - 1

    @property
    def box_bytes(self) -> int:
        """One TMA box: 64 rows (of h, or of W^T) x one K slab."""
        return 64 * self.block_k * 2

    @property
    def a_bytes(self) -> int:
        """A slab's rows of h: the block's ``block_m`` rows, two boxes."""
        return self.block_m * self.block_k * 2

    @property
    def b_bytes(self) -> int:
        """A slab's W^T: ``block_n`` vocab rows, two boxes from each block."""
        return self.block_n * self.block_k * 2

    @property
    def stage_bytes(self) -> int:
        return self.a_bytes + self.b_bytes

    @property
    def smem_bytes(self) -> int:
        """Slack to align the ring to 1024 bytes, the ring, and a full and an
        empty mbarrier (8 bytes) per stage."""
        return CE_ALIGN + self.stages * self.stage_bytes + 8 * 2 * self.stages

    @property
    def part_shape(self) -> Tuple[int, int, int]:
        return (4, self.slots, self.group_rows)

    def unit_range(self, c: int) -> Tuple[int, int]:
        """Units [u0, u1) of cluster ``c``, as the kernel computes them."""
        return c * self.units // self.clusters, (c + 1) * self.units // self.clusters

    def cluster_of(self, u: int) -> int:
        """The cluster whose range holds unit ``u``."""
        return ((u + 1) * self.clusters - 1) // self.units

    def origin(self, rg: int) -> int:
        """The unit from which row group ``rg``'s vocab tiles are counted: the
        first of the cluster holding the group's last unit."""
        return self.unit_range(self.cluster_of((rg + 1) * self.vocab_tiles - 1))[0]

    def vocab_tile(self, u: int) -> int:
        return (u - self.origin(u // self.vocab_tiles)) % self.vocab_tiles

    def segments(self, c: int) -> List[Tuple[int, int, int]]:
        """Cluster ``c``'s (row group, first unit, end unit), in order."""
        u0, u1 = self.unit_range(c)
        nv = self.vocab_tiles
        return [(rg, max(u0, rg * nv), min(u1, (rg + 1) * nv))
                for rg in range(u0 // nv, (u1 - 1) // nv + 1)]

    def merge_order(self, rg: int) -> List[int]:
        """The slots of row group ``rg``'s partials in the merge's order."""
        nv = self.vocab_tiles
        return [c + rg for c in range(self.cluster_of(rg * nv),
                                      self.cluster_of((rg + 1) * nv - 1) + 1)]

    @property
    def l2_bytes(self) -> int:
        """Bytes a call brings from L2 into shared memory: each block's rows
        of h for every slab, and each W^T slab once for both blocks of the
        cluster (multicast)."""
        return self.units * (self.Kp // self.block_k) * (self.cluster * self.a_bytes
                                                         + self.b_bytes)

    def args(self) -> Tuple[int, ...]:
        return tuple(getattr(self, n) for n in CE_PLAN_ARGS)


def ce_plan(N: int, nh: int, V: int, clusters: int) -> CEPlan:
    """The bf16 kernel's plan on a card that holds ``clusters`` clusters of
    two blocks at once (``ce_clusters``): that many persistent clusters, or
    one a unit where there are fewer units. Raises where the card holds no
    cluster."""
    one = CEPlan(N, nh, V, 1)
    if clusters < 1:
        raise ValueError(f"ce_plan: the card holds no cluster of {one.cluster} blocks with "
                         f"{one.smem_bytes} bytes of shared memory each")
    return CEPlan(N, nh, V, min(clusters, one.units))


@functools.lru_cache(maxsize=None)
def ce_clusters(device: torch.device, smem_bytes: int) -> int:
    """Clusters of two blocks of the bf16 kernel that the card holds at
    once with ``smem_bytes`` of shared memory a block
    (``cudaOccupancyMaxActiveClusters``). One query a device and size."""
    lib = _lib("ce_fwd_clusters", [ctypes.c_int, ctypes.c_void_p])
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.ce_fwd_clusters(smem_bytes, ctypes.byref(n))
    build.check(lib, err, "ce_fwd_clusters")
    return n.value


@dataclass(frozen=True)
class CEBwdPlan:
    """Launch plan of the backward kernel for h [N, nh], W [nh, V].

    Both products take ``block_m`` x ``block_n`` f32 tiles over K slabs of
    ``block_k``. dh = d W^T [N, nh] has ``dh_tiles`` tiles over K = Vp
    (``dh_slabs`` slabs), each tile's K split over ``splits`` blocks
    (``k_range``) whose f32 partials [splits, N, nh] (``part_bytes``) a
    merge sums in split order; dW = h^T d [nh, V] has ``dw_tiles`` tiles
    over K = N (``dw_slabs`` slabs), no split. The operands are the
    forward's (``CEPlan``'s Vp, Kp, ldh) and d [N, Vp] bf16 (``d_bytes``)."""
    N: int
    nh: int
    V: int
    splits: int
    block_m: int = 64 * CE_BWD_WARPGROUPS
    block_n: int = CE_BWD_BLOCK_N
    block_k: int = CE_BWD_BLOCK_K
    stages: int = CE_BWD_STAGES

    @property
    def Vp(self) -> int:
        return _cdiv(self.V, self.block_n) * self.block_n

    @property
    def Kp(self) -> int:
        return _round_up(self.nh, self.block_k)

    @property
    def ldh(self) -> int:
        return _round_up(self.nh, 8)

    @property
    def dh_tiles(self) -> int:
        return _cdiv(self.N, self.block_m) * _cdiv(self.nh, self.block_n)

    @property
    def dh_slabs(self) -> int:
        return self.Vp // self.block_k

    @property
    def dh_blocks(self) -> int:
        return self.dh_tiles * self.splits

    @property
    def dw_tiles(self) -> int:
        return _cdiv(self.nh, self.block_m) * (self.Vp // self.block_n)

    @property
    def dw_slabs(self) -> int:
        return _cdiv(self.N, self.block_k)

    @property
    def dw_blocks(self) -> int:
        return self.dw_tiles

    @property
    def stage_bytes(self) -> int:
        return (self.block_m + self.block_n) * self.block_k * 2

    @property
    def smem_bytes(self) -> int:
        """The ring, slack to align it to the swizzle's 1024 bytes, and a
        full and an empty mbarrier (8 bytes) per stage."""
        return CE_ALIGN + self.stages * self.stage_bytes + 2 * self.stages * 8

    @property
    def part_bytes(self) -> int:
        return 4 * self.splits * self.N * self.nh if self.splits > 1 else 0

    @property
    def d_bytes(self) -> int:
        return 2 * self.N * self.Vp

    def k_range(self, split: int) -> Tuple[int, int]:
        """dh's K slabs [k0, k1) of ``split``, as the kernel computes them."""
        return (split * self.dh_slabs // self.splits,
                (split + 1) * self.dh_slabs // self.splits)

    def args(self) -> Tuple[int, ...]:
        return tuple(getattr(self, n) for n in CE_BWD_PLAN_ARGS)


def ce_bwd_plan(N: int, nh: int, V: int, nsm: int) -> CEBwdPlan:
    """The backward kernel's plan. One block fits an SM (its ring takes
    193 KB), so with fewer dh tiles than SMs dh's K is split over the
    ``splits`` in 1..``CE_BWD_SPLIT_MAX`` (at most one slab each) that give
    the fewest waves of blocks per split, the smallest on a tie: at N 3040
    on 132 SMs, 96 tiles x 4 = 384 blocks in 3 waves, each a quarter of K.
    With as many tiles as SMs or more, and for dW, no split."""
    one = CEBwdPlan(N, nh, V, 1)
    if one.dh_tiles >= nsm:
        return one
    splits = min(range(1, min(CE_BWD_SPLIT_MAX, one.dh_slabs) + 1),
                 key=lambda s: (Fraction(_cdiv(one.dh_tiles * s, nsm), s), s))
    return CEBwdPlan(N, nh, V, splits)


def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ce_logp_plain(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor,
                  operand_dtype: Optional[torch.dtype] = torch.bfloat16,
                  save_logits: bool = False) -> Tuple[torch.Tensor, ...]:
    """h [N, nh], w [nh, V], tgt [N] -> (logp [N], lse [N]) in f32, or with
    ``save_logits`` (logp, lse of the rounded logits, logits [N, V] in the
    operand type). Rows go in chunks of ``PLAIN_ROW_CHUNK`` to bound the
    f32 logits memory."""
    dt = operand_dtype or torch.float32
    wq = w.to(dt).float()
    logp, lse = [], []
    spill = h.new_empty((h.shape[0], w.shape[1]), dtype=dt) if save_logits else None
    for s in range(0, h.shape[0], PLAIN_ROW_CHUNK):
        logits = h[s:s + PLAIN_ROW_CHUNK].to(dt).float() @ wq
        l = torch.logsumexp(logits, dim=-1)
        t = tgt[s:s + PLAIN_ROW_CHUNK].long()
        logp.append(logits.gather(1, t[:, None])[:, 0] - l)
        if save_logits:
            rounded = logits.to(dt)
            spill[s:s + PLAIN_ROW_CHUNK] = rounded
            l = torch.logsumexp(rounded.float(), dim=-1)
        lse.append(l)
    if not logp:
        empty = h.new_zeros((0,), dtype=torch.float32)
        return (empty, empty.clone()) + ((spill,) if save_logits else ())
    return (torch.cat(logp), torch.cat(lse)) + ((spill,) if save_logits else ())


def _lib(name: str, argtypes, source: str = "ce_fwd") -> ctypes.CDLL:
    """``csrc/<source>.cu``'s library with the C function ``name`` typed."""
    lib = build.library(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _bf16_h(h: torch.Tensor, ldh: int) -> torch.Tensor:
    """h in bf16 as the kernels read it: [N, ldh] rows, 16-byte aligned."""
    h = h.to(torch.bfloat16).contiguous()
    if ldh != h.shape[1]:
        return torch.nn.functional.pad(h, (0, ldh - h.shape[1]))
    return h.clone() if h.data_ptr() % 16 else h


def ce_forward(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor,
               operand_dtype: Optional[torch.dtype] = torch.bfloat16,
               save_logits: bool = False) -> Tuple[torch.Tensor, ...]:
    """Same contract as ``ce_logp_plain``; launches the CUDA kernel for
    CUDA tensors. Takes no gradient itself (``FusedCEFn`` does)."""
    return _ce_forward(h, w, tgt, operand_dtype, save_logits)[0]


def _ce_forward(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor,
                operand_dtype: Optional[torch.dtype], save_logits: bool
                ) -> Tuple[Tuple[torch.Tensor, ...], Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """``ce_forward``'s outputs, and where the bf16 kernel ran the bf16
    operands it read, h [N, ldh] and W^T [Vp, Kp] (``ce_backward``'s
    ``operands``), else None."""
    if h.device.type == "cpu":
        return ce_logp_plain(h, w, tgt, operand_dtype, save_logits), None
    if h.device.type != "cuda":
        raise ValueError(f"ce_forward: unsupported device {h.device}")
    N, nh = h.shape
    if w.dim() != 2 or w.shape[0] != nh or tuple(tgt.shape) != (N,):
        raise ValueError(f"ce_forward: bad shapes h {tuple(h.shape)} w "
                         f"{tuple(w.shape)} tgt {tuple(tgt.shape)}")
    if operand_dtype not in (None, torch.bfloat16):
        raise TypeError(f"ce_forward: operand_dtype {operand_dtype} not supported")
    if w.device != h.device or tgt.device != h.device:
        raise ValueError("ce_forward: all inputs must be on one device")
    V = w.shape[1]
    dt = operand_dtype or torch.float32
    dev = h.device
    tgt = tgt.to(torch.int32).contiguous()
    logp = torch.empty((N,), device=dev)
    lse = torch.empty((N,), device=dev)
    if N == 0:
        spill = torch.empty((0, V), device=dev, dtype=dt) if save_logits else None
        return (logp, lse) + ((spill,) if save_logits else ()), None
    name = "ce_fwd_train" if save_logits else "ce_fwd"
    stream = torch.cuda.current_stream(dev).cuda_stream
    operands = None
    if dt == torch.bfloat16:
        plan = ce_plan(N, nh, V, ce_clusters(dev, CEPlan(N, nh, V, 1).smem_bytes))
        h = _bf16_h(h, plan.ldh)
        if w.dtype not in (torch.float32, torch.bfloat16):
            w = w.float()
        w = w.contiguous()
        wt = torch.empty((plan.Vp, plan.Kp), device=dev, dtype=dt)  # the kernel fills it
        spill = torch.empty((N, plan.Vp), device=dev, dtype=dt) if save_logits else None
        part = torch.empty(plan.part_shape, device=dev)
        lib = _lib("ce_fwd_bf16", _BF16_ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.ce_fwd_bf16(
                h.data_ptr(), w.data_ptr(), wt.data_ptr(), tgt.data_ptr(), logp.data_ptr(),
                lse.data_ptr(), spill.data_ptr() if save_logits else None,
                part.data_ptr(), N, nh, V, plan.ldh, plan.Vp,
                plan.Kp, int(w.dtype == torch.float32), int(save_logits), *plan.args(), stream)
        build.check(lib, err, name)
        spill = spill[:, :V] if save_logits else None
        operands = h, wt
    else:
        h = h.float().contiguous()
        w = w.float().contiguous()
        spill = torch.empty((N, V), device=dev) if save_logits else None
        lib = _lib("ce_fwd_f32", _F32_ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.ce_fwd_f32(h.data_ptr(), w.data_ptr(), tgt.data_ptr(), logp.data_ptr(),
                                 lse.data_ptr(), spill.data_ptr() if save_logits else None,
                                 N, nh, V, int(save_logits), stream)
        build.check(lib, err, name)
    build.LAUNCHES[name] += 1
    return (logp, lse) + ((spill,) if save_logits else ()), operands


def ce_backward_plain(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor,
                      lse: torch.Tensor, logits: torch.Tensor, g: torch.Tensor,
                      operand_dtype: Optional[torch.dtype] = torch.bfloat16
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_fused_ce_bwd``: the log_softmax-gather VJP at the saved logits.

    p = exp(logits - lse) (``lse`` of the saved logits, so rows sum to 1),
    d = (onehot - p) * g, rounded to the operand type; dh = d W^T and
    dW = h^T d from the operands in that type with f32 accumulation (the
    products are taken in f32 on values the type represents exactly, as
    JAX's ``preferred_element_type=float32`` does). Returns (dh, dW) in the
    dtypes of h and w."""
    p = torch.exp(logits.float() - lse[:, None])
    t = tgt.long()[:, None]
    d = -(p * g[:, None])
    d.scatter_(1, t, (1.0 - p.gather(1, t)) * g[:, None])
    dt = operand_dtype or torch.float32
    d = d.to(dt).float()
    dh = d @ w.to(dt).float().T
    dw = h.to(dt).float().T @ d
    return dh.to(h.dtype), dw.to(w.dtype)


def ce_backward(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor, lse: torch.Tensor,
                logits: torch.Tensor, g: torch.Tensor,
                operand_dtype: Optional[torch.dtype] = torch.bfloat16,
                operands: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``ce_backward_plain``; launches ``csrc/ce_bwd.cu``
    for CUDA tensors with bf16 operands. ``logits`` is the grad-mode spill
    [N, V] (bf16, unit column stride, 16-byte-aligned rows; the kernel
    reads it with its row stride: the forward's [:, :V] view of [N, Vp] as
    it is); ``operands`` are the forward's bf16 h [N, ldh] and W^T
    [Vp, Kp] (returned by ``_ce_forward``), which the kernel needs: without
    them a CUDA tensor raises. With f32
    operands (no main-path caller: the decoder passes bf16) a CUDA tensor
    keeps the plain f32 products, as the JAX package's f32 mode is two XLA
    dots as well."""
    if h.device.type == "cpu" or (h.device.type == "cuda" and operand_dtype is None):
        return ce_backward_plain(h, w, tgt, lse, logits, g, operand_dtype)
    if h.device.type != "cuda":
        raise ValueError(f"ce_backward: unsupported device {h.device}")
    if operand_dtype != torch.bfloat16:
        raise TypeError(f"ce_backward: operand_dtype {operand_dtype} not supported")
    N, nh = h.shape
    V = w.shape[1] if w.dim() == 2 else -1
    if (w.dim() != 2 or w.shape[0] != nh or tuple(tgt.shape) != (N,)
            or tuple(lse.shape) != (N,) or tuple(g.shape) != (N,)
            or tuple(logits.shape) != (N, V)):
        raise ValueError(f"ce_backward: bad shapes h {tuple(h.shape)} w {tuple(w.shape)} tgt "
                         f"{tuple(tgt.shape)} lse {tuple(lse.shape)} logits "
                         f"{tuple(logits.shape)} g {tuple(g.shape)}")
    dev = h.device
    if any(a.device != dev for a in (w, tgt, lse, logits, g)):
        raise ValueError("ce_backward: all inputs must be on one device")
    if logits.dtype != torch.bfloat16 or (N > 0 and (
            logits.stride(1) != 1 or logits.stride(0) < V or logits.stride(0) % 8
            or logits.data_ptr() % 16)):
        raise ValueError(f"ce_backward: the spill must be bf16 rows of unit stride, 16-byte "
                         f"aligned (the forward's [N, Vp] buffer), got {logits.dtype} strides "
                         f"{logits.stride()}")
    if N == 0:
        return torch.zeros_like(h), torch.zeros_like(w)
    if operands is None:
        raise ValueError("ce_backward: the kernel reads the grad-mode forward's bf16 operands "
                         "(h [N, ldh], W^T [Vp, Kp]); pass them as operands")
    plan = ce_bwd_plan(N, nh, V, _num_sms(dev))
    hb, wt = operands
    for a, shape in ((hb, (N, plan.ldh)), (wt, (plan.Vp, plan.Kp))):
        if (tuple(a.shape) != shape or a.dtype != torch.bfloat16 or not a.is_contiguous()
                or a.device != dev):
            raise ValueError(f"ce_backward: operand {tuple(a.shape)} {a.dtype} on {a.device}, "
                             f"expected a contiguous bf16 {shape} on {dev}")
    tgt = tgt.to(torch.int32).contiguous()
    lse, g = lse.float().contiguous(), g.float().contiguous()
    d = torch.empty((N, plan.Vp), device=dev, dtype=torch.bfloat16)  # the kernel fills it
    part = torch.empty((plan.splits, N, nh), device=dev) if plan.splits > 1 else None
    dh = torch.empty((N, nh), device=dev)
    dw = torch.empty((nh, V), device=dev)
    lib = _lib("ce_bwd_bf16", _BWD_ARGTYPES, "ce_bwd")
    with torch.cuda.device(dev):
        err = lib.ce_bwd_bf16(
            logits.data_ptr(), logits.stride(0), lse.data_ptr(), tgt.data_ptr(), g.data_ptr(),
            hb.data_ptr(), wt.data_ptr(), d.data_ptr(),
            part.data_ptr() if part is not None else None, dh.data_ptr(), dw.data_ptr(), N, nh,
            V, plan.ldh, plan.Vp, plan.Kp, *plan.args(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ce_bwd")
    build.LAUNCHES["ce_bwd"] += 1
    return dh.to(h.dtype), dw.to(w.dtype)


class FusedCEFn(torch.autograd.Function):
    """``logp = FusedCEFn.apply(h, w, tgt, operand_dtype)``: the per-row
    target log-probability with the gradient of ``_fused_ce_bwd`` for h and
    w (tgt and operand_dtype take none). The forward goes through
    ``ce_forward(..., save_logits=True)`` and the backward through
    ``ce_backward``, so a CUDA input launches the grad-mode kernel and the
    backward kernel (bf16 operands; the forward's bf16 h and packed W^T are
    kept for it, 41 MB of W^T at the Yahoo width) and a CPU input runs the
    plain versions."""

    @staticmethod
    def forward(ctx, h, w, tgt, operand_dtype):
        (logp, lse, logits), operands = _ce_forward(h, w, tgt, operand_dtype, True)
        ctx.operand_dtype = operand_dtype
        ctx.save_for_backward(h, w, tgt, lse, logits, *(operands or ()))
        return logp

    @staticmethod
    def backward(ctx, g):
        h, w, tgt, lse, logits, *operands = ctx.saved_tensors
        dh, dw = ce_backward(h, w, tgt, lse, logits, g, ctx.operand_dtype,
                             operands=tuple(operands) or None)
        return dh, dw, None, None
