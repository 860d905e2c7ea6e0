"""The CE backward of the port on the CPU, with the JAX package beside it.

(a) ``ops/ce_cuda.py::ce_backward_plain`` (the plain version of
    ``csrc/ce_bwd.cu``) against the JAX package's ``_fused_ce_bwd``
    (``ops/ce_pallas.py:217``), reached directly on the residuals of
    ``_ce_forward(..., save_logits=True)`` with the Pallas kernel in
    interpret mode: bf16 and f32 operands, the spill handed over as a
    strided [:, :V] view of the kernel's padded [N, Vp] buffer, zeros in g
    (masked tokens), targets at 0 and V - 1, a row count that is not a
    multiple of the CUDA kernel's 128-row tile. Tolerances: ``CE_DH`` /
    ``CE_DW`` of tests/test_torch_port_grads.py (tests/test_pallas.py's
    CE-gradient bounds). ``ce_backward`` on CPU tensors is the plain version.
(b) ``ce_bwd_plan`` on an H100 SXM's 132 SMs and an H100 PCIe's 114 at the
    main paths' N (3040 in training, 60800 in a ``--nsamples 40`` chunk), a
    ragged N and small ones: tile counts, dh's K splits (one wave count per
    split no worse than any other), the partials' bytes, the operand layout
    the forward's plan makes, and the constants and plan arguments read back
    from ``csrc/ce_bwd.cu``.
(c) A numpy model of the kernel: the d pass (zeros past V), TMA boxes
    written with the 128-byte swizzle, the wgmma descriptors reading them
    (K-major and MN-major, the latter with its leading byte offset between
    64-wide atoms), each block's K slabs under the plan (split-K partials
    merged in split order) and the accumulator layout's masked stores; its
    dh and dW against ``ce_backward_plain``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_lagging_encoder_tpu.ops.ce_pallas import _ce_forward, _fused_ce_bwd
from vae_lagging_encoder_tpu_torch.ops import build, ce_cuda

# CE grads: tests/test_pallas.py:158-161 (as tests/test_torch_port_grads.py:35-36)
CE_DH = dict(atol=1e-5, rtol=1e-4)
CE_DW = dict(atol=1e-4, rtol=1e-4)
NSM, NSM_PCIE = 132, 114
SRC = (build.CSRC_DIR / "ce_bwd.cu").read_text()


# ------------------------------------------------------- (a) against JAX
def _inputs(n, nh, vocab, seed):
    rng = np.random.RandomState(seed)
    h = (rng.randn(n, nh) * 0.4).astype(np.float32)
    w = (rng.randn(nh, vocab) * 0.05).astype(np.float32)
    tgt = rng.randint(0, vocab, n).astype(np.int32)
    tgt[0], tgt[1] = 0, vocab - 1
    g = rng.randn(n).astype(np.float32)
    g[rng.rand(n) < 0.3] = 0.0  # masked tokens
    return h, w, tgt, g


@pytest.mark.parametrize("n,block_n", [(96, 32), (136, 8)])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_backward_matches_jax_fused_ce_bwd(bf16, n, block_n):
    """136 rows: not a multiple of the CUDA kernel's 128-row tile (the JAX
    kernel takes whole row blocks of 8)."""
    nh, vocab = 128, 1100
    h, w, tgt, g = _inputs(n, nh, vocab, seed=n + bf16)
    mxu = jnp.bfloat16 if bf16 else None
    res = _ce_forward(jnp.asarray(h), jnp.asarray(w), jnp.asarray(tgt), block_n=block_n,
                      block_v=1024, mxu_dtype=mxu, interpret=True, save_logits=True)
    logits = res[2]
    assert logits.shape == (n, 2048)  # padded to the JAX kernel's vocab tile
    dh_j, dw_j, _ = jax.device_get(_fused_ce_bwd(
        block_n, 1024, mxu, True, (jnp.asarray(h), jnp.asarray(w), jnp.asarray(tgt), res[1],
                                   logits), jnp.asarray(g)))
    dt = torch.bfloat16 if bf16 else None
    spill = torch.from_numpy(np.array(logits, np.float32)).to(dt or torch.float32)
    view = spill[:, :vocab]  # the forward's [:, :V] view of its padded buffer
    assert view.stride() == (2048, 1) and not view.is_contiguous()
    args = (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(tgt),
            torch.from_numpy(np.array(res[1])), view, torch.from_numpy(g), dt)
    dh, dw = ce_cuda.ce_backward_plain(*args)
    assert dh.dtype == dw.dtype == torch.float32
    np.testing.assert_allclose(dh.numpy(), dh_j, err_msg="dh", **CE_DH)
    np.testing.assert_allclose(dw.numpy(), dw_j, err_msg="dw", **CE_DW)
    # masked rows take no gradient
    assert not dh[torch.from_numpy(g) == 0].any()
    # the wrapper on CPU tensors is the plain version
    routed = ce_cuda.ce_backward(*args)
    assert torch.equal(routed[0], dh) and torch.equal(routed[1], dw)


# ------------------------------------------------------------- (b) the plan
def _int_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+)", SRC).group(1))


def test_ce_bwd_constants_and_arguments_match_the_kernel():
    assert _int_const("kWarpgroups") == ce_cuda.CE_BWD_WARPGROUPS
    assert re.search(r"kBN = (\d+)", SRC).group(1) == str(ce_cuda.CE_BWD_BLOCK_N)
    assert re.search(r"kBK = (\d+)", SRC).group(1) == str(ce_cuda.CE_BWD_BLOCK_K)
    assert _int_const("kStages") == ce_cuda.CE_BWD_STAGES
    assert _int_const("kAlign") == ce_cuda.CE_ALIGN
    assert "kSmemBytes = kAlign + kStages * kStageBytes + 2 * kStages * 8" in SRC
    sig = re.search(r"int ce_bwd_bf16\(([^)]*)\)", SRC).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    names = list(ce_cuda.CE_BWD_PLAN_ARGS)
    assert params[-len(names) - 1:-1] == names and params[-1] == "stream"
    assert len(params) == len(ce_cuda._BWD_ARGTYPES)
    ints = {i for i, p in enumerate(sig.split(",")) if p.split()[0] == "int"}
    void_p = ce_cuda.ctypes.c_void_p
    assert ints == {i for i, t in enumerate(ce_cuda._BWD_ARGTYPES) if t is not void_p}


SHAPES = [(1, 1024, 20004), (70, 1024, 20004), (1000, 1024, 20004), (3040, 1024, 20004),
          (60800, 1024, 20004), (70, 40, 1100), (300, 36, 1300)]


def _waves(tiles, s, nsm):
    return -(-tiles * s // nsm) / s


@pytest.mark.parametrize("nsm", [NSM, NSM_PCIE])
@pytest.mark.parametrize("N,nh,V", SHAPES)
def test_ce_bwd_plan(N, nh, V, nsm):
    plan = ce_cuda.ce_bwd_plan(N, nh, V, nsm)
    fwd = ce_cuda.ce_plan(N, nh, V, nsm)
    assert (plan.N, plan.nh, plan.V) == (N, nh, V)
    # the forward's operands as they are: bf16 h [N, ldh], W^T [Vp, Kp]
    assert (plan.Vp, plan.Kp, plan.ldh) == (fwd.Vp, fwd.Kp, fwd.ldh)
    assert plan.block_m == 128 and plan.block_n == 256 and plan.block_k == 64
    assert plan.dh_tiles == -(-N // 128) * -(-nh // 256)
    assert plan.dw_tiles == plan.dw_blocks == -(-nh // 128) * (plan.Vp // 256)
    assert plan.dh_slabs == plan.Vp // 64 and plan.dw_slabs == -(-N // 64)
    assert plan.dh_blocks == plan.dh_tiles * plan.splits
    # one block an SM: the ring and its barriers in one block's shared memory
    assert plan.smem_bytes == 1024 + 4 * 48 * 1024 + 64 <= 232448
    if plan.dh_tiles >= nsm:
        assert plan.splits == 1
    else:
        cands = range(1, min(ce_cuda.CE_BWD_SPLIT_MAX, plan.dh_slabs) + 1)
        best = min(_waves(plan.dh_tiles, s, nsm) for s in cands)
        assert _waves(plan.dh_tiles, plan.splits, nsm) == best
        assert all(_waves(plan.dh_tiles, s, nsm) > best for s in cands if s < plan.splits)
    # the splits' K ranges partition dh's slabs, none empty
    ranges = [plan.k_range(s) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.dh_slabs
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    assert plan.part_bytes == (4 * plan.splits * N * nh if plan.splits > 1 else 0)
    assert plan.d_bytes == 2 * N * plan.Vp
    # TMA: 16-byte row strides of d, W^T and h; 128-byte box rows (the swizzle)
    assert (2 * plan.Vp) % 16 == 0 and (2 * plan.Kp) % 16 == 0 and (2 * plan.ldh) % 16 == 0
    assert plan.block_k * 2 == 128
    assert len(plan.args()) == len(ce_cuda.CE_BWD_PLAN_ARGS)
    assert all(isinstance(a, int) for a in plan.args())


def test_ce_bwd_plan_main_paths():
    """Training (N 3040): 96 dh tiles, K split 4 ways (384 blocks, 3 waves
    of 132), 49.8 MB of partials; dW 8 x 79 = 632 tiles. A --nsamples 40
    chunk (N 60800): 1900 dh tiles, no split. On 114 SMs: 7 ways."""
    train = ce_cuda.ce_bwd_plan(3040, 1024, 20004, NSM)
    big = ce_cuda.ce_bwd_plan(60800, 1024, 20004, NSM)
    assert (train.dh_tiles, train.splits, train.dh_blocks, train.dw_blocks) == (96, 4, 384, 632)
    assert train.part_bytes == 49_807_360 and train.d_bytes == 122_961_920
    assert [train.k_range(s) for s in range(4)] == [(0, 79), (79, 158), (158, 237), (237, 316)]
    assert (big.dh_tiles, big.splits, big.part_bytes, big.dw_slabs) == (1900, 1, 0, 950)
    assert ce_cuda.ce_bwd_plan(3040, 1024, 20004, NSM_PCIE).splits == 7


# ----------------------------------------------------- (c) the kernel model
BM, BN, BK, BOX = 128, 256, 64, 8192


def _sw128(addr):
    """The 128-byte swizzle on a shared-memory byte address (PTX ISA):
    bits [4, 7) XOR bits [7, 10)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_box(smem, base, src, c0, c1, inner, outer):
    """A TMA tile load with SWIZZLE_128B: box (inner x outer) of the
    row-major 2-D ``src`` at coordinates (c0 inner, c1 outer), zeros outside
    it, element (o, i) written at base + o * 128 + (((i / 8) ^ (o % 8)) * 16)
    + (i % 8) * 2 (the box's base is 1024-byte aligned)."""
    o, i = np.meshgrid(np.arange(outer), np.arange(inner), indexing="ij")
    r, c = c1 + o, c0 + i
    ok = (r < src.shape[0]) & (c < src.shape[1])
    vals = np.where(ok, src[np.minimum(r, src.shape[0] - 1), np.minimum(c, src.shape[1] - 1)], 0)
    addr = base + o * 128 + (((i >> 3) ^ (o & 7)) << 4) + (i & 7) * 2
    smem[addr // 2] = vals


def _read_k_major(smem, start, rows):
    """A K-major SWIZZLE_128B operand of ``rows`` x 16 at descriptor start
    ``start``: element (r, k) at start + (r / 8) * 1024 + (r % 8) * 128 + 2 k,
    swizzled."""
    r, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    return smem[_sw128(start + (r >> 3) * 1024 + (r & 7) * 128 + 2 * k) // 2]


def _read_mn_major(smem, start, lbo, mn):
    """An MN-major SWIZZLE_128B operand of ``mn`` x 16 (indexed [mn, k]):
    element (m, k) at start + (m / 64) lbo + (k / 8) 1024 + (k % 8) 128 +
    2 (m % 64), swizzled."""
    m, k = np.meshgrid(np.arange(mn), np.arange(16), indexing="ij")
    return smem[_sw128(start + (m >> 6) * lbo + (k >> 3) * 1024 + (k & 7) * 128 + 2 * (m & 63))
                // 2]


def _gemm_model(a_src, b_src, a_mn, M, Nc, ldo, KS, tiles_m, tiles_n, splits, out, plane):
    """ce_bwd_gemm_kernel<a_mn>: per block its tile and K slabs, a ring stage
    filled as the producer's TMA loads fill it (a_src / b_src are the tensor
    maps' 2-D sources), the two warpgroups' k16 products read through the
    descriptors, then the masked stores of the accumulator layout."""
    tiles = tiles_m * tiles_n
    for blk in range(tiles * splits):
        b, split = blk % tiles, blk // tiles
        mt, nt = (b % tiles_m, b // tiles_m) if a_mn else (b // tiles_n, b % tiles_n)
        m0, n0 = mt * BM, nt * BN
        k0, k1 = split * KS // splits, (split + 1) * KS // splits
        acc = np.zeros((2, 64, BN))
        for ks in range(k0, k1):
            smem = np.zeros(3 * 1024 * 16)  # one 48 KB stage at a 1024-aligned base
            base, kc = 1024, ks * BK
            if a_mn:
                for w in range(2):
                    _tma_box(smem, base + w * BOX, a_src, m0 + 64 * w, kc, 64, BK)
            else:
                _tma_box(smem, base, a_src, kc, m0, BK, BM)
            for q in range(BN // 64):
                _tma_box(smem, base + 2 * BOX + q * BOX, b_src, n0 + 64 * q, kc, 64, BK)
            for w in range(2):
                sa = base + w * BOX
                for k16 in range(BK // 16):
                    A = (_read_mn_major(smem, sa + k16 * 2048, BOX, 64) if a_mn
                         else _read_k_major(smem, sa + k16 * 32, 64))
                    B = _read_mn_major(smem, base + 2 * BOX + k16 * 2048, BOX, BN)
                    acc[w] += A @ B.T
        # epilogue: warp wq, lane l, register 4 i + 2 hh + e of warpgroup w
        w, wq, lane, i, hh, e = np.meshgrid(*(np.arange(n) for n in (2, 4, 32, BN // 8, 2, 2)),
                                            indexing="ij")
        rl, col = 16 * wq + (lane >> 2) + 8 * hh, 8 * i + 2 * (lane & 3) + e
        row, col_g = m0 + 64 * w + rl, n0 + col
        ok = (row < M) & (col_g < Nc)
        out[split * plane + row[ok] * ldo + col_g[ok]] = acc[w[ok], rl[ok], col[ok]]


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _kernel_model(h, w, tgt, lse, spill, g, plan):
    """dh and dW as ce_bwd.cu computes them under ``plan``."""
    N, nh, V = plan.N, plan.nh, plan.V
    # the d pass, with the f32 operations of ce_backward_plain: zeros past V
    s = torch.from_numpy(spill).float()
    p = torch.exp(s - torch.from_numpy(lse)[:, None])
    gt = torch.from_numpy(g)[:, None]
    dv = torch.where(torch.arange(V)[None, :] == torch.from_numpy(tgt).long()[:, None],
                     (1.0 - p) * gt, -(p * gt))
    d = np.zeros((N, plan.Vp), np.float32)
    d[:, :V] = dv.bfloat16().float().numpy()
    hb = np.zeros((N, plan.ldh), np.float32)
    hb[:, :nh] = _bf16(h)
    wt = np.zeros((plan.Vp, plan.Kp), np.float32)  # the forward's packed W^T
    wt[:V, :nh] = _bf16(w).T
    # dh: A = d (K-major), B = W^T (MN-major); partials merged in split order
    plane = N * nh
    part = np.zeros(plan.splits * plane)
    _gemm_model(d, wt, False, N, nh, nh, plan.dh_slabs, -(-N // BM), -(-nh // BN),
                plan.splits, part, plane)
    dh = part.reshape(plan.splits, plane)[0].copy()
    for k in range(1, plan.splits):
        dh += part.reshape(plan.splits, plane)[k]
    # dW: A = h^T (MN-major, h's valid columns nh), B = d (MN-major)
    dw = np.zeros(nh * V)
    _gemm_model(hb[:, :nh], d, True, nh, V, V, plan.dw_slabs, -(-nh // BM), plan.Vp // BN, 1,
                dw, nh * V)
    return d, dh.reshape(N, nh), dw.reshape(nh, V)


@pytest.mark.parametrize("N,nh,V,nsm", [(70, 40, 1100, NSM), (130, 72, 300, NSM),
                                          (200, 40, 600, 4), (257, 136, 260, 3)])
def test_ce_bwd_kernel_model_matches_plain(N, nh, V, nsm):
    """Ragged N (a partial row tile; dW's ragged last K slab), nh below a
    box (40, 72: dh's fully zero-filled B boxes) and above one (136: dW's
    second warpgroup box partly past nh), a ragged last vocab tile (padded
    columns), dh's K split 8 ways (ranges of 2 and 3 slabs), 2 ways and not at
    all."""
    h, w, tgt, g = _inputs(N, nh, V, seed=N + V)
    plan = ce_cuda.ce_bwd_plan(N, nh, V, nsm)
    args = [torch.from_numpy(a) for a in (h, w, tgt)]
    _, lse, spill = ce_cuda.ce_logp_plain(*args, torch.bfloat16, save_logits=True)
    d, dh, dw = _kernel_model(h, w, tgt, lse.numpy(), spill.float().numpy(), g, plan)
    assert not d[:, V:].any()  # no exp(0 - lse) past V
    ref = ce_cuda.ce_backward_plain(*args, lse, spill, torch.from_numpy(g), torch.bfloat16)
    np.testing.assert_allclose(dh, ref[0].numpy(), atol=1e-6, rtol=1e-5, err_msg="dh")
    np.testing.assert_allclose(dw, ref[1].numpy(), atol=1e-6, rtol=1e-5, err_msg="dw")


def test_mn_major_descriptor_reads_what_tma_wrote():
    """Every element of an MN-major k16 step (B: 256 wide, four boxes
    ``lbo`` apart; A: one box) is read from where the TMA box put it, and
    the K-major A's (r, k) from where its 128-row box put it."""
    smem = np.full(3 * 16 * 1024, -1.0)
    src = np.arange(64 * 512, dtype=np.float64).reshape(64, 512)  # [k rows, mn columns]
    for q in range(4):
        _tma_box(smem, 1024 + q * BOX, src, 64 * q, 0, 64, BK)
    for k16 in range(4):
        B = _read_mn_major(smem, 1024 + k16 * 2048, BOX, 256)
        np.testing.assert_array_equal(B, src[16 * k16:16 * k16 + 16, :256].T)
    srck = np.arange(128 * 64, dtype=np.float64).reshape(128, 64)  # [rows, k]
    smem[:] = -1.0
    _tma_box(smem, 1024, srck, 0, 0, BK, BM)
    for w in range(2):
        for k16 in range(4):
            A = _read_k_major(smem, 1024 + w * BOX + 32 * k16, 64)
            np.testing.assert_array_equal(A, srck[64 * w:64 * w + 64, 16 * k16:16 * k16 + 16])
