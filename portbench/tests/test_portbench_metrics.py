"""The benchmark's arithmetic: percentiles, spreads, the union of device
intervals, the kernels' least times, and the per-layer readers."""

import statistics

import pytest

from portbench import harness, yardstick
from portbench.trace import Event, TraceView


def test_percentile_matches_linear_interpolation():
    xs = list(range(1, 101))
    assert yardstick.percentile(xs, 95) == pytest.approx(95.05)
    assert yardstick.percentile([3.0], 95) == 3.0
    assert yardstick.percentile([5, 1, 3], 50) == 3


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert yardstick.spread(xs) == pytest.approx((q3 - q1) / q2)


@pytest.mark.parametrize("spans,expected", [
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(0, 5), (1, 2), (3, 4)], 5.0),
    ([(4, 6), (0, 1), (5, 7)], 4.0),
    ([], 0.0),
])
def test_union_of_intervals(spans, expected):
    assert yardstick.union_seconds(spans) == expected


def test_least_time_takes_the_larger_bound():
    assert yardstick.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 989e12) == pytest.approx(1.0)
    assert yardstick.least_seconds(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_ce_cost_counts_members_not_the_table():
    nbytes, flops = yardstick.ce_cost(rows=1000, dim=512, slots=4,
                                      members=300)
    assert flops == 3 * 2 * 1000 * 300 * 512
    fwd = 1000 * 512 * 2 + 4 * 1000 * 8 + 300 * 512 * 2
    assert nbytes == 2 * fwd + 1000 * 512 * 2


def test_conv_score_topk_cost_counts_live_slots():
    nbytes, flops = yardstick.conv_score_topk_cost(2, 4, 4, 32, 340, 5)
    assert flops == 2 * 32 * 9 * 32 * 340
    assert nbytes == 32 * 32 * 2 + 340 * 9 * 32 * 2 + 32 * 5 * 4


def _readings(kind, trace=None, bound_s=0.0):
    cell = harness.load_cell("r18-train-openvocab" if kind == "train"
                             else "r18-predict-bulk")
    return harness.Readings(kind, cell, rate=100.0, dispatch_s=[0.01, 0.03],
                            flops_per_map=1e12, peak_bytes=2 ** 31,
                            trace=trace, bound_s=bound_s)


def _trace():
    ev = [Event("conv", 0.0, 1000.0, "encoder", ("aten::conv2d",)),
          Event("ce", 1000.0, 3000.0, "loss",
                ("rangeclip::pixel_text_ce", "loss")),
          Event("bn", 4000.0, 5000.0, "decoder", ("aten::batch_norm",))]
    return TraceView(calls=2, window_s=0.01, events=ev, idle_gaps=[])


@pytest.mark.parametrize("name,kind,expected", [
    ("dispatch_ms.train", "train", 20.0),
    ("mfu.train", "train", 100.0 * 100.0 * 1e12 / 989e12),
    ("peak_mem_gib.train", "train", 2.0),
    ("model_ms.train", "train", 1.0),
    ("loss_ms.train", "train", 1.0),
    ("ce_roofline.train", "train", 50.0),
    ("idle_share.train", "train", 60.0),
    ("dispatch_ms.predict", "predict", 20.0),
    ("model_ms.predict", "predict", 1.0),
    ("idle_share.predict", "predict", 60.0),
])
def test_readers(name, kind, expected):
    read = harness.load_reader(name)
    run = _readings(kind, _trace(), bound_s=0.001)
    assert read(run) == pytest.approx(expected)


@pytest.mark.parametrize("name", ["ce_roofline.train", "model_ms.train",
                                  "head_roofline.predict",
                                  "idle_share.predict"])
def test_readers_without_a_trace_read_nothing(name):
    kind = name.split(".")[1]
    assert harness.load_reader(name)(_readings(kind)) is None


def test_head_roofline_reads_nothing_without_its_kernel():
    read = harness.load_reader("head_roofline.predict")
    assert read(_readings("predict", _trace(), bound_s=0.001)) is None


def test_every_manifest_metric_has_a_reader():
    cell = harness.load_cell("r18-train-openvocab")
    for m in cell.manifest["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
