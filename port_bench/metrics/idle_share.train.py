"""The share of the traced training window in which no operation ran on the
device: 1 - (union of the device events) / (window's wall time)."""


def read(run):
    if run.kind != "train":
        return None
    return 100.0 * (1.0 - run.busy_s / run.wall_s)
