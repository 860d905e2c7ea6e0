"""The fused CE forward's share of its roofline over an IW window: the bound at
each launch's rows over the device time of its kernels (the W^T pack, the
products and epilogue, the merge)."""


def read(run):
    if run.kind != "iwnll" or not run.bounds["ce"] or not run.family_s["ce"]:
        return None
    return 100.0 * run.bounds["ce"] / run.family_s["ce"]
