"""Host calls that put work on the device (kernel launches, graph launches,
copies, sets: ``tracing.LAUNCH_APIS``) per training step in the traced
window."""


def read(run):
    if run.kind != "train" or run.steps <= 0:
        return None
    return run.launch_calls / run.steps
