"""Device milliseconds a training step spends outside the library's
products and convolutions (``gemm_s``: cuBLAS, CUTLASS, cuDNN, with
cuDNN's batch norm where it runs it) and the port's own kernels
(``family_s``): batch norm where PyTorch's own kernels run it, ELU, the
residual and direct adds, the loss, the clip, Adam, copies. None where
nothing is left."""


def read(run):
    if run.kind != "train" or run.steps <= 0:
        return None
    rest = run.busy_s - run.gemm_s - sum(run.family_s.values())
    return 1e3 * rest / run.steps if rest > 0 else None
