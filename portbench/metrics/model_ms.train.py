"""Device milliseconds a train call spends in the encoder and decoder
(forward and backward), from the traced sub-window: the events under the
'encoder' and 'decoder' ranges (backward events by their forward
operator's sequence number)."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    t = run.trace
    return 1e3 * t.seconds(lambda e: e.label in ("encoder", "decoder")) \
        / t.calls
