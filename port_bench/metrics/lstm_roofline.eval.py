"""The LSTM forward kernel's share of its roofline over an IW window: the sum
of each launch's bound (the encoder's rows, the decoder's samples x rows)
over the kernel's device time in the trace."""


def read(run):
    if run.kind != "iwnll" or not run.bounds["lstm"] or not run.family_s["lstm"]:
        return None
    return 100.0 * run.bounds["lstm"] / run.family_s["lstm"]
