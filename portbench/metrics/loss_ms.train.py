"""Device milliseconds a train step spends in the loss: the events under
the 'loss' range (the hybrid loss and the area pooling, forward and
backward) and those of the loss kernels wherever launched
(``rangeclip::pixel_text_ce*``, ``tv_*``, ``l2_normalize*``)."""

KERNELS = ("rangeclip::pixel_text_ce", "rangeclip::tv_",
           "rangeclip::l2_normalize")


def read(run):
    if run.kind != "train" or run.trace is None:
        return None

    def keep(e):
        return e.label == "loss" or any(op.startswith(KERNELS)
                                        for op in e.ops)

    return 1e3 * run.trace.seconds(keep) / run.trace.calls
