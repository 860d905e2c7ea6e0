"""The LSTM kernels' share of their roofline over a training window: the sum of
each launch's bound (``flops.py``: its residual forward and reverse sweep at
the launch's shapes) over their device time in the trace."""


def read(run):
    if run.kind != "train" or not run.bounds["lstm"] or not run.family_s["lstm"]:
        return None
    return 100.0 * run.bounds["lstm"] / run.family_s["lstm"]
