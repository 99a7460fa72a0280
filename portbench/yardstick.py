"""The benchmark's arithmetic, frozen here so that no change to the program
moves the yardstick: the card's peaks, the least time of the kernels whose
rooflines are reported, the union of device intervals, the statistics of
a window, and the spread that sets a bound.

The peaks, the bound formulas and ``label_modules`` are copies of
``rangeclip_tpu_torch/utils/roofline.py`` (``PEAK_FLOPS``,
``PEAK_BYTES_PER_S``, the ``OP_COSTS`` entries of ``pixel_text_ce`` and
``conv_score_topk``, ``label_modules``); the union is
``rangeclip_tpu_torch/utils/profiling.busy_us``.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

# NVIDIA H100 SXM data sheet (dense, at the full 700 W): FLOP/s by input
# type (bf16 on the tensor cores, f32 on the CUDA cores) and HBM bytes/s.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, flops: float, dtype: str = "bf16"
                  ) -> float:
    """The roofline's least time: the larger of the bytes over the memory
    bandwidth and the operations over the input type's peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def ce_cost(rows: int, dim: int, slots: int, members: int,
            element_size: int = 2) -> Tuple[float, float]:
    """(bytes, FLOPs) of one pixel-text cross-entropy, forward and backward
    together, over ``members`` contrast classes: the forward reads the
    samples, the label slots and weights and the member rows, and makes
    ``2 rows members dim`` operations; the backward reads them again,
    writes the samples' gradient, and makes twice the operations."""
    fwd_bytes = (rows * dim * element_size + slots * rows * 8
                 + members * dim * element_size)
    fwd_flops = 2 * rows * members * dim
    bwd_bytes = fwd_bytes + rows * dim * element_size
    return fwd_bytes + bwd_bytes, 3 * fwd_flops


def conv_score_topk_cost(batch: int, h: int, w: int, c_in: int, live: int,
                         top_k: int, element_size: int = 2
                         ) -> Tuple[float, float]:
    """(bytes, FLOPs) of the folded head with its top-k selection: the
    features, the live slots' folded 3x3 weights and the ids out; the 3x3
    product over the live slots only."""
    n_pix = batch * h * w
    return (n_pix * c_in * element_size + live * 9 * c_in * element_size
            + n_pix * top_k * 4, 2 * n_pix * 9 * c_in * live)


def union_seconds(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100), linear between order statistics."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles over the median
    (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2)


class label_modules:
    """Opens a profiler range named ``name`` around every forward of each
    given module, so that the device events it launches, and through the
    autograd sequence numbers those of its backward, can be placed."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.modules = modules
        self.handles: List[object] = []

    def __enter__(self):
        for name, module in self.modules.items():
            stack: List[object] = []

            def enter(_module, _args, _name=name, _stack=stack):
                _stack.append(torch.profiler.record_function(_name))
                _stack[-1].__enter__()

            def leave(_module, _args, _out, _stack=stack):
                _stack.pop().__exit__(None, None, None)

            self.handles += [module.register_forward_pre_hook(enter),
                             module.register_forward_hook(leave)]
        return self

    def __exit__(self, *exc):
        for handle in self.handles:
            handle.remove()
        self.handles = []
