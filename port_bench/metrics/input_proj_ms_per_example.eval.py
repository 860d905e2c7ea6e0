"""Device milliseconds a scored sentence spends in the LSTM layers' input
products (the program's ``lstm.input_proj`` spans: the ``@`` alone, CUDA
events around it), encoder and decoder. None where the program records
no such span with a device time."""


def read(run):
    if run.kind != "iwnll" or run.examples <= 0:
        return None
    try:
        from vae_lagging_encoder_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    ms = [s["device_ms"] for s in recorded()["spans"]
          if s["name"] == "lstm.input_proj" and s["device_ms"] is not None]
    return sum(ms) / run.examples if ms else None
