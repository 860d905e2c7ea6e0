"""The whole training step's share of the chip's dense bf16 peak: the model
FLOPs of the traced window's steps (real positions, 3 x forward;
``flops.py``) over the window's wall time x 989 TFLOP/s."""
from port_bench.flops import PEAK_BF16


def read(run):
    if run.kind != "train" or run.model_flops <= 0:
        return None
    return 100.0 * run.model_flops / (run.wall_s * PEAK_BF16)
