"""``rangeclip_tpu_torch.cli.benchmark`` on the CPU at a tiny size: each
subcommand runs with ``--device cpu``; ``throughput`` prints the
documented keys and aborts on a rate above the card's peak; ``profile``'s
intervals add up to its window; ``robustness --subject depth`` gives the
same finite rows at every brightness (the depth model never sees the
RGB, and a batch's candidate draw is keyed by the seed and the batch);
``loader`` prints its native-c++ row, then its numpy row; ``throughput
--pixel_sampler auto multinomial`` times a train config with each
sampler."""

import json
import os

import numpy as np
import pytest
import torch

from rangeclip_tpu_torch.cli import benchmark
from rangeclip_tpu_torch.data import synthetic
from rangeclip_tpu_torch.models.depth_unet import DepthUNetConfig
from rangeclip_tpu_torch.training.checkpoint import CheckpointManager
from rangeclip_tpu_torch.training.state import create_train_state

INFERENCE_KEYS = {"mode", "precision", "predict_path", "batch", "resolution",
                  "maps_per_sec", "ms_per_batch", "gflop_per_map", "tflops",
                  "pct_peak", "device"}
TRAIN_KEYS = {"mode", "precision", "pixel_sampler", "image_tower", "accum",
              "microbatch", "resolution", "s_per_step", "maps_per_sec",
              "gflop_per_map", "tflops", "pct_peak", "device"}
TINY = ["--device", "cpu", "--resolution", "32", "--num_classes", "64"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's runs on one intra-op thread: at these sizes a single
    thread is the fastest, and a test worker beside others loses most of
    its time to thread contention otherwise.  Every run a test compares
    is made under it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    return synthetic.write_synthetic_dataset(str(root), n_samples=16,
                                             shape=(32, 32), num_classes=8)


def test_throughput_rows(capsys):
    rows = benchmark.main(["throughput", *TINY, "--batch_sizes", "2",
                           "--train_configs", "2x1", "--iters", "1",
                           "--rounds", "1", "--predict_path", "default"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == rows
    assert [r["mode"] for r in rows] == ["inference", "train_step"]
    assert set(rows[0]) == INFERENCE_KEYS and set(rows[1]) == TRAIN_KEYS
    assert rows[0]["predict_path"] == "default"
    for row in rows:
        assert row["device"] == "cpu" and row["pct_peak"] is None
        assert row["gflop_per_map"] > 0 and row["maps_per_sec"] > 0


def test_throughput_aborts_above_the_peak(monkeypatch):
    """A faked time that implies more than the card's peak aborts."""
    monkeypatch.setattr(benchmark, "best_of", lambda *a, **k: 1e-12)
    monkeypatch.setattr(benchmark, "device_peak", lambda *a: 989e12)
    with pytest.raises(SystemExit, match="integrity gate"):
        benchmark.main(["throughput", *TINY, "--batch_sizes", "1",
                        "--train_configs", "--iters", "1", "--rounds", "1"])


def test_throughput_runs_the_multinomial_sampler(capsys):
    """The train row with the multinomial sampler (``auto``'s is
    test_throughput_rows'); the flag takes both, a row each."""
    rows = benchmark.main(["throughput", *TINY, "--batch_sizes",
                           "--train_configs", "1x1", "--iters", "1",
                           "--rounds", "1", "--pixel_sampler",
                           "multinomial"])
    assert [(r["mode"], r["pixel_sampler"]) for r in rows] == [
        ("train_step", "multinomial")]
    assert set(rows[0]) == TRAIN_KEYS and rows[0]["s_per_step"] > 0
    assert rows[0]["gflop_per_map"] > 0 and rows[0]["pct_peak"] is None
    args = benchmark.build_parser().parse_args(
        ["throughput", "--pixel_sampler", "auto", "multinomial"])
    assert args.pixel_sampler == ["auto", "multinomial"]


@pytest.mark.parametrize("mode", ["predict", "train"])
def test_profile_intervals_add_up(mode, tmp_path, capsys):
    out = benchmark.main(["profile", *TINY, "--mode", mode, "--fp32",
                          "--batch_size", "1", "--steps", "1", "--top", "3",
                          "--trace_dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "| interval | ms/step |" in text and "# raw trace:" in text
    assert (tmp_path / f"{mode}.json").exists()
    names = {b["interval"] for b in out["buckets"]}
    assert {"encoder", "decoder"} <= names
    np.testing.assert_allclose(sum(b["ms"] for b in out["buckets"]),
                               out["total_ms"], rtol=1e-9)
    assert sum(b["gflop"] for b in out["buckets"]) > 0


def test_robustness_depth_rows(data, tmp_path, capsys):
    state = create_train_state(
        DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                        embedding_dim=32), torch.device("cpu"), seed=3)
    state.step = 2
    CheckpointManager(str(tmp_path / "ckpt")).save(state)
    argv = ["robustness", "--device", "cpu",
            "--labeled_metadata_path", data["metadata"],
            "--labels_path", data["labels"],
            "--equivalence_dict_path", data["similarity"],
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--batch_size", "2",
            "--n_height", "32", "--n_width", "32",
            "--brightness_levels", "1.0", "0.2"]
    rows = benchmark.main(argv)
    assert "brightness saturation" in capsys.readouterr().out
    assert len(rows) == 2
    for key in ("pixel_accuracy_t1", "pixel_accuracy_tk", "mIoU_t1",
                "mIoU_tk"):
        assert np.isfinite(rows[0][key]) and rows[0][key] == rows[1][key]
    with pytest.raises(SystemExit, match="--embedding_dim 64"):
        benchmark.main(argv + ["--embedding_dim", "64"])


def test_loader_row(data, capsys, monkeypatch):
    """The native-c++ row (no PNG of the synthetic set takes PIL), then the
    numpy row, which leaves RANGECLIP_NATIVE as it found it."""
    monkeypatch.delenv("RANGECLIP_NATIVE", raising=False)
    rows = benchmark.main(["loader", "--labeled_metadata_path",
                           data["metadata"], "--labels_path", data["labels"],
                           "--batch_size", "2", "--n_height", "32",
                           "--n_width", "32", "--num_workers", "2"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == rows
    assert [r["path"] for r in rows] == ["native-c++", "numpy"]
    assert rows[0]["pil_files"] == 0 and "pil_files" not in rows[1]
    assert all(r["maps_per_sec"] > 0 for r in rows)
    assert "RANGECLIP_NATIVE" not in os.environ
