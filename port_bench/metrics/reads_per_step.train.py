"""The program's reads of the device (its counter ``device_reads``: the
plateau and segment reads) per training step in the traced window. None
where the program counts none."""


def read(run):
    if run.kind != "train" or run.steps <= 0:
        return None
    try:
        from vae_lagging_encoder_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    reads = recorded()["counters"].get("device_reads", 0)
    return reads / run.steps if reads else None
