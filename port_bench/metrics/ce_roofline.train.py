"""The fused CE kernels' share of their roofline over a training window: the
bounds of the grad-mode forward and the VJP at each launch's rows, over the
device time of all their kernels (the W^T pack, the merge, the d pass and
both products)."""


def read(run):
    if run.kind != "train" or not run.bounds["ce"] or not run.family_s["ce"]:
        return None
    return 100.0 * run.bounds["ce"] / run.family_s["ce"]
