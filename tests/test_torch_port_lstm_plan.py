"""Launch plans of the tensor-core LSTM kernels, held on the CPU.

``ops/lstm_cuda.py::infer_plan`` and ``bwd_plan`` compute the partition
that ``csrc/lstm_infer.cu`` and the bf16 path of ``csrc/lstm_bwd.cu`` run
with. At the main paths' shapes (32 and 640 rows, H 1024) and odd ones, on
an H100 SXM's 132 SMs and an H100 PCIe's 114 (where H 1024 needs 16 units
per block), each plan must

- give every (row, unit) pair to exactly one (block, warp), as the
  kernels' index arithmetic (mirrored by ``plan_owners``) assigns it;
- fit one block's shared memory (232,448 bytes on the H100);
- fit the grid one block per SM (a cooperative launch needs every block
  resident);
- be one the kernel was built for: the pipeline depth, the warp limit and
  the (n_sub, m_group) instantiations read from the CUDA sources, and the
  plan arguments in the order the C entry point names them.
"""
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
    plan = (lstm_cuda.infer_plan if kind == "infer" else lstm_cuda.bwd_plan)(rows, H, nsm)
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
    ``csrc/lstm_infer.cu`` too: its plan is a partition that fits, its
    (n_sub, m_group) is a built residual instantiation (LSTM_RESID_CASE),
    and up to 16 m-tiles (the training batch B 32, a short last batch of
    20) it is the plan of the forward without residuals."""
    plan = lstm_cuda.infer_plan(rows, H, nsm, save_residuals=True)
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
        assert plan == lstm_cuda.infer_plan(rows, H, nsm)
    assert _entry_params(src, "lstm_infer")[-len(lstm_cuda.INFER_PLAN_ARGS) - 2] == \
        "save_residuals"


def test_lstm_mma_plan_main_paths():
    """The plans the main paths run, 128 blocks of 16 warps and 8 units
    each: the IW decoder's 640 rows with one m-tile column per warp (three
    m-tiles per pass); the encoder's 32 rows, and the training forward's
    (with residuals), as two m-tile columns x 8 K slices; the training
    backward's 32 rows as one pass of two m-tiles, K split over the 16
    warps."""
    iw, enc, bwd = (lstm_cuda.infer_plan(640, 1024, NSM), lstm_cuda.infer_plan(32, 1024, NSM),
                    lstm_cuda.bwd_plan(32, 1024, NSM))
    train = lstm_cuda.infer_plan(32, 1024, NSM, save_residuals=True)
    assert (iw.units_per_block, iw.blocks, iw.warps, iw.k_split, iw.m_group) == (8, 128, 16, 1, 3)
    assert (enc.units_per_block, enc.blocks, enc.warps, enc.k_split) == (8, 128, 16, 8)
    assert train == enc and train.m_group == 1
    assert (bwd.units_per_block, bwd.blocks, bwd.warps, bwd.m_group) == (8, 128, 16, 2)
    assert np.all(lstm_cuda.plan_owners(bwd)[:, 2] == 1)
