"""Per cent of the traced sub-window in which the card runs no
operation: 1 - the union of its device events over the window's wall
time."""


def read(run):
    if run.kind != "predict" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
