"""The share of the traced training window from the end of each of the
program's device reads (its spans ``plateau_read`` and ``segment_read``)
to the start of the next ``replay`` span: the device idle that the reads
cause, the queue being empty when a read returns (an upper bound: the
step's fill runs its few small kernels inside it). None where the program
records no such spans (a program without the recorder)."""

import bisect

READS = ("plateau_read", "segment_read")


def read(run):
    if run.kind != "train" or run.wall_s <= 0:
        return None
    try:
        from vae_lagging_encoder_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = recorded()["spans"]
    replays = sorted(s["start_ns"] for s in spans if s["name"] == "replay")
    starved, pairs = 0, 0
    for s in spans:
        if s["name"] in READS and s["end_ns"] is not None:
            j = bisect.bisect_left(replays, s["end_ns"])
            if j < len(replays):
                starved += replays[j] - s["end_ns"]
                pairs += 1
    if not pairs:
        return None
    return 100.0 * starved * 1e-9 / run.wall_s
