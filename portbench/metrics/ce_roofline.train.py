"""Per cent of its roofline that the pixel-text cross-entropy reaches in
the traced steps: the least time of each step's forward and backward
(``yardstick.ce_cost`` over the step's own rows, label slots, contrast
members and width, the same whichever kernel route runs) over the
device time of the events launched under ``rangeclip::pixel_text_ce*``."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    spent = run.trace.seconds(lambda e: any(
        op.startswith("rangeclip::pixel_text_ce") for op in e.ops))
    if spent <= 0:
        return None
    return 100.0 * run.bound_s / spent
