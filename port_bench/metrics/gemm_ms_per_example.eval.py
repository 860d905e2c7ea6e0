"""Device milliseconds a scored sentence spends in the library's products
outside the port's kernels (the f32 input projections and heads)."""


def read(run):
    if run.kind != "iwnll" or run.examples <= 0:
        return None
    return 1e3 * run.gemm_s / run.examples
