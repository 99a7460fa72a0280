"""The global-batch step through ``cli.train --distributed`` (no
``--ddp_parity``) over two gloo ranks on the CPU: one checkpoint set and
one ``results.txt`` (rank 0's), a run header naming the global batch, both
ranks with the same learning rates, best results and weights after every
step, and one sharded validation.  A group of one rank is the
single-device step and the single-device validation, bit for bit; the MiT
encoder and validation run on a 'spatial' grid's cell (ROADMAP item 10c,
held against JAX by ``test_torch_spatial_mit.py`` and
``test_torch_spatial_validate.py``)."""

import json
import os
import re

import numpy as np
import pytest
import torch

from rangeclip_tpu_torch.data import synthetic
from rangeclip_tpu_torch.evals.validate import validate_model
from rangeclip_tpu_torch.losses.hybrid import HybridLossConfig
from rangeclip_tpu_torch.parallel import dryrun
from rangeclip_tpu_torch.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip_tpu_torch.parallel.halo import sharded_rows
from rangeclip_tpu_torch.parallel.mesh import (
    Grid,
    init_distributed,
    make_mesh,
    shard_class_tables,
    shutdown_distributed,
)
from rangeclip_tpu_torch.training.state import create_train_state
from rangeclip_tpu_torch.training.train_step import make_train_step
from torch_dist_worker import join_ranks, start_ranks

FILTERS = ["8", "16", "16", "16", "32"]
CPU = torch.device("cpu")


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
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    return synthetic.write_synthetic_dataset(str(root), n_samples=24,
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


def test_two_ranks_take_the_global_step_write_once_and_agree(dataset,
                                                             tmp_path):
    ckpt = tmp_path / "ckpt"
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(_argv(dataset, ckpt, "--distributed",
                        "--validation_start_step", "2",
                        "--n_step_per_validation", "2", "--scheduler_type",
                        "reduce_on_plateau"), f)
    procs, outs = start_ranks("cli", 2, tmp_path, tmp_path / "argv.json")
    r0, r1 = (json.load(open(out)) for out in join_ranks(procs, outs))
    assert r0["lrs"] == r1["lrs"] and len(r0["lrs"]) == 2
    assert r0["best"] == r1["best"] and r0["best"]["step"] == 2
    assert np.isfinite(r0["best"]["loss"])
    assert r0["weights"] == r1["weights"] and len(r0["weights"]) == 2
    assert sorted(os.listdir(ckpt / "checkpoints")) == [
        "depth_segmentation_model-1.pth", "depth_segmentation_model-2.pth",
        "optimizer-1.pt", "optimizer-2.pt"]
    log = (ckpt / "results.txt").read_text()
    assert log.count("Begin training...") == 1
    assert re.search(r"ranks +: 2\n", log)
    assert re.search(r"step +: global batch of 4 rows\n", log)
    assert log.count("[Val] [Step 2] Top-k mIoU (equiv)") == 1
    assert log.count("Training finished.") == 1


@pytest.fixture
def group_of_one(tmp_path):
    import torch.distributed as dist

    init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        yield dist.group.WORLD
    finally:
        shutdown_distributed()


def test_step_over_a_group_of_one_is_the_single_device_step(group_of_one):
    """make_train_step over a group of one rank: parameters, BatchNorm
    statistics, gradients and info bit-equal to the step without a
    group."""
    spec = dryrun.StepSpec(seed=4)
    runs = []
    for group in (None, group_of_one):
        state = create_train_state(spec.config, CPU, spec.weight_decay,
                                   spec.seed)
        batch, text, medium, hard = dryrun.step_inputs(spec, 1, CPU)
        step = make_train_step(HybridLossConfig(), spec.accum, group=group)
        state, info = step(state, batch, (spec.seed, 0), spec.lr, 0.3, 0.5,
                           text, medium, hard)
        runs.append(dryrun._snapshot(state, info))
    for part in ("params", "grads", "stats"):
        for name, v in runs[0][part].items():
            assert torch.equal(runs[1][part][name], v), (part, name)
    assert runs[0]["info"] == runs[1]["info"]


def test_validation_over_a_group_of_one_is_single_device(group_of_one):
    """validate_model over a group of one rank returns the single-device
    results, bit for bit."""
    spec = dryrun.StepSpec(seed=6)
    model = create_train_state(spec.config, CPU, spec.weight_decay,
                               spec.seed).model
    batch, text, medium, hard = dryrun.step_inputs(spec, 2, CPU)
    rng = np.random.default_rng(0)
    batches = [{**{k: v[i].numpy() for k, v in batch.items()},
                "image": rng.random((4, 32, 32, 3)).astype(np.float32),
                "object_bbox": np.tile(np.array([0, 0, 24, 24], np.int32),
                                       (4, 1))} for i in range(spec.accum)]
    eq = torch.eye(spec.classes, dtype=torch.bool)
    provider = lambda crops: crops.float().reshape(  # noqa: E731
        crops.shape[0], -1)[:, :spec.dim]
    results = [validate_model(
        model, batches, text, medium, hard, eq,
        torch.arange(spec.classes), {"pct_medium": 0.2, "pct_hard": 0.5},
        provider, 1, {"step": -1, "loss": float("inf"), "mIoU_tk": -1.0},
        group=group) for group in (None, group_of_one)]
    assert results[0] == results[1]
    assert results[0]["step"] == 1


def test_spatial_axis_and_model_sharded_tables_refuse():
    """ROADMAP item 10b's two parts are ported: make_mesh refuses a
    'spatial' axis, naming the process grid that carries it, and
    shard_class_tables keeps the tables whole without a 'model' axis.
    Item 10c is ported too: on a spatial grid's cell the MiT encoder runs
    on the cell's rows (its attention's K and V gathered over the axis)
    and validate_model runs over the grid."""
    with pytest.raises(ValueError, match="make_grid"):
        make_mesh(1, 1, [CPU] * 2, n_spatial=2)
    tables = (torch.zeros(4, 8), torch.zeros(4, 4, dtype=torch.bool),
              torch.zeros(4, 4, dtype=torch.bool))
    assert shard_class_tables(*tables) == tables
    assert shard_class_tables(*tables, shard_classes=True) == tables
    # a spatial grid's cell with no process group behind it: its
    # collectives leave every buffer as this cell wrote it
    grid = Grid(1, 2, 1, 0, 0, 0, {"data": None, "spatial": None,
                                   "model": None, "batch": None})
    mit = DepthUNet(DepthUNetConfig(unet_type="mit",
                                    encoder_filters=(8, 16, 16, 16, 32),
                                    embedding_dim=32)).eval()
    with sharded_rows(grid, (32, 32)):
        field = mit.native_field(torch.zeros(1, 16, 32, 1))
    # the cell's 16 of 32 rows: 4 of the H/4 field's 8
    assert field.shape == (1, 4, 8, 32) and torch.isfinite(field).all()
    results = validate_model(mit, [], *tables,
                             torch.eye(4, dtype=torch.bool), torch.arange(4),
                             {}, None, 1, {}, group=grid)
    assert results == {"latest_val_loss": 0.0}  # no batch: nothing best
