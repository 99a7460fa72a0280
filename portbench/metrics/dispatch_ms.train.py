"""Host milliseconds of one train call in the measured window (its
dispatch: the call returns before the card has run it), the mean over the
window's calls."""


def read(run):
    if run.kind != "train" or not run.dispatch_s:
        return None
    return 1e3 * sum(run.dispatch_s) / len(run.dispatch_s)
