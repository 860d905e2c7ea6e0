"""On the card, at each cell's own size: the control (the reference one
precision step below what the configuration states, in the program's
place) fails the cell's limits on three seeds, and the program on the same
seeds passes them. Skips without a CUDA device; on the chip:
``python -m pytest port_bench/tests -q -m cuda``."""
from __future__ import annotations

import gc

import pytest
import torch

from port_bench import compare, manifest

CELLS = [w["name"] for w in manifest.load_json(manifest.find_manifest())["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    from port_bench.run import entry_class
    from vae_lagging_encoder_tpu_torch.ops import build

    build.build()
    cell = manifest.load_cell(name, manifest.load_json(manifest.find_manifest()))
    dev = torch.device("cuda:0")
    for seed in SEEDS:
        c = entry_class(cell.traffic["entry"])(cell, seed, dev)
        c.calibration_run(2.0)
        c.free()
        gc.collect()
        torch.cuda.empty_cache()
        program, control = c.check(), c.control()
        assert compare.judge(program, cell.limits), (seed, program)
        assert not compare.judge(control, cell.limits), (seed, control)
        del c
