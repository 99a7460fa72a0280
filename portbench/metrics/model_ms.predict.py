"""Device milliseconds a predict call spends in the encoder and decoder
(forward), from the traced sub-window: the events under the
'encoder' and 'decoder' ranges (backward events by their forward
operator's sequence number)."""


def read(run):
    if run.kind != "predict" or run.trace is None:
        return None
    t = run.trace
    return 1e3 * t.seconds(lambda e: e.label in ("encoder", "decoder")) \
        / t.calls
