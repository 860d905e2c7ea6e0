"""The share of the traced IW window in which no operation ran on the device: 1
- (union of the device events) / (window's wall time)."""


def read(run):
    if run.kind != "iwnll":
        return None
    return 100.0 * (1.0 - run.busy_s / run.wall_s)
