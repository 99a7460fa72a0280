"""``cli.train --distributed`` on the CPU over gloo.  Two processes with the
coordinator flags (a file store), ``--ddp_parity``, 2 steps validating at
step 2: one checkpoint set and one ``results.txt`` (rank 0's), both ranks
with the same learning rates, the same best results and the same weights
after every step.  ``--distributed`` without ``--ddp_parity`` (the
global-batch step) over two ranks is ``test_torch_global_cli.py``'s.  The
world-1 runs
(``--ddp_parity``, ``--distributed`` and both, each bit-equal to the
single-device run) are in ``test_torch_trainer.py``."""

import json
import re
import os

import pytest

from rangeclip_tpu_torch.data import synthetic
from torch_dist_worker import join_ranks, start_ranks

FILTERS = ["8", "16", "16", "16", "32"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    return synthetic.write_synthetic_dataset(str(root), n_samples=16,
                                             shape=(32, 32), num_classes=8)


def _argv(paths, ckpt, *extra):
    return ["--labeled_metadata_path", paths["metadata"],
            "--labels_path", paths["labels"],
            "--equivalence_dict_path", paths["similarity"],
            "--checkpoint_path", str(ckpt), "--unet_architecture", "resnet",
            "--batch_size", "2", "--n_height", "32", "--n_width", "32",
            "--learning_rates", "1e-3", "--learning_schedule", "2",
            "--accumulation_steps", "2", "--embedding_dim", "32",
            "--encoder_filters", *FILTERS, "--n_step_per_summary", "1",
            "--n_step_per_checkpoint", "1", "--max_steps", "2",
            "--device", "cpu", *extra]


def _run_ranks(mode, paths, tmp_path, *extra):
    ckpt = tmp_path / "ckpt"
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(_argv(paths, ckpt, "--distributed", *extra), f)
    procs, outs = start_ranks(mode, 2, tmp_path, tmp_path / "argv.json")
    results = []
    for out in join_ranks(procs, outs):
        with open(out) as f:
            results.append(json.load(f))
    return ckpt, results


def test_two_ranks_write_once_and_agree(dataset, tmp_path):
    ckpt, (r0, r1) = _run_ranks(
        "cli", dataset, tmp_path, "--ddp_parity", "--validation_start_step",
        "2", "--n_step_per_validation", "2", "--scheduler_type",
        "reduce_on_plateau")
    assert r0["lrs"] == r1["lrs"] and len(r0["lrs"]) == 2
    assert r0["best"] == r1["best"] and r0["best"]["step"] == 2
    assert r0["weights"] == r1["weights"] and len(r0["weights"]) == 2
    assert sorted(os.listdir(ckpt / "checkpoints")) == [
        "depth_segmentation_model-1.pth", "depth_segmentation_model-2.pth",
        "optimizer-1.pt", "optimizer-2.pt"]
    log = (ckpt / "results.txt").read_text()
    assert log.count("Begin training...") == 1
    assert log.count("[Val] [Step 2] Top-k mIoU (equiv)") == 1
    assert re.search(r"ranks +: 2\n", log)
    assert log.count("Training finished.") == 1
    events = (ckpt / "tensorboard-train" / "events.csv").read_text()
    assert events.count("Loss/train_step") == 2
