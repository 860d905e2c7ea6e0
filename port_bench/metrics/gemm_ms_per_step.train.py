"""Device milliseconds a training step spends in the library's products and
convolutions (cuBLAS, CUTLASS, cuDNN) outside the port's kernels: the text
model's f32 input projections, heads and dW_h."""


def read(run):
    if run.kind != "train" or run.steps <= 0:
        return None
    return 1e3 * run.gemm_s / run.steps
