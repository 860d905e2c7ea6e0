"""The IW evaluator's share of the chip's dense bf16 peak: the forward FLOPs of
the traced window's batches (the encoder once per chunk, the decoder and the
CE once per sample, real positions) over wall time x 989 TFLOP/s."""
from port_bench.flops import PEAK_BF16


def read(run):
    if run.kind != "iwnll" or run.model_flops <= 0:
        return None
    return 100.0 * run.model_flops / (run.wall_s * PEAK_BF16)
