"""Per cent of its roofline that the folded head with its top-k
selection reaches in the traced calls: the least time of the 3x3
product over the live candidate slots (``yardstick.conv_score_topk_cost``)
over the device time of the events launched under
``rangeclip::conv_score_topk``.  Nothing is read where that kernel did not
run."""


def read(run):
    if run.kind != "predict" or run.trace is None:
        return None
    spent = run.trace.seconds(lambda e: any(
        op.startswith("rangeclip::conv_score_topk") for op in e.ops))
    if spent <= 0:
        return None
    return 100.0 * run.bound_s / spent
