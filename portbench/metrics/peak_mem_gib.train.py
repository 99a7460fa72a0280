"""GiB: the most device memory allocated at once, set-up and the
measured window included (``torch.cuda.max_memory_allocated``)."""


def read(run):
    if run.kind != "train" or run.peak_bytes <= 0:
        return None
    return run.peak_bytes / 2 ** 30
