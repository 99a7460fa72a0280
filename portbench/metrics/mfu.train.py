"""Per cent of the card's bf16 peak (989 TFLOP/s, at its full 700 W)
that the measured window's rate reaches: maps/s times the FLOPs of one
map as the reference counts them (forward, backward and the
cross-entropy over the contrast members)."""

from portbench.yardstick import PEAK_FLOPS


def read(run):
    if run.kind != "train" or run.rate <= 0:
        return None
    return 100.0 * run.rate * run.flops_per_map / PEAK_FLOPS["bf16"]
