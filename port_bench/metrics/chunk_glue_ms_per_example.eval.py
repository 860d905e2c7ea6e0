"""Device milliseconds a scored sentence spends in an IW chunk outside its
LSTM input products, recurrences and CE: each ``iw_chunk`` span's device
time less that of the ``lstm.input_proj``, ``lstm.recurrence`` and ``ce``
spans whose nearest ``iw_chunk`` above is it (the cat, bias add and
transposed copy, the density terms, the noise, the encoder's head). A
span's device time is the elapsed time between its two CUDA events, so
the glue holds the device's idle inside the chunk too, not only its
kernels. None where the program records no chunk with a device time."""

PARTS = ("lstm.input_proj", "lstm.recurrence", "ce")


def read(run):
    if run.kind != "iwnll" or run.examples <= 0:
        return None
    try:
        from vae_lagging_encoder_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = recorded()["spans"]
    chunks = {i: s["device_ms"] for i, s in enumerate(spans)
              if s["name"] == "iw_chunk" and s["device_ms"] is not None}
    if not chunks:
        return None
    for s in spans:
        if s["name"] not in PARTS or s["device_ms"] is None:
            continue
        i = s["parent"]
        while i is not None and spans[i]["name"] != "iw_chunk":
            i = spans[i]["parent"]
        if i in chunks:
            chunks[i] -= s["device_ms"]
    return sum(chunks.values()) / run.examples
