"""The port's training entry points on the CPU: its loader yields the JAX
loader's batches on the same files, ``cli/train --device cpu`` takes four
steps and writes reference ``.pth`` files that both packages read, a run
killed after step 1 and resumed is bitwise equal to the straight run, a run
that validates at steps 2 and 4 trains bitwise as the straight run does,
the multi-GPU flags run at world 1, the train CLI traces steps 2-4
under ``--profile_dir`` without moving training, and the host modules
copied from the JAX package are pinned to their originals."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.data import labels as jax_labels
from rangeclip_tpu.data import synthetic as jax_synthetic
from rangeclip_tpu.data.dataset import ImageDepthTextDataset as JaxDataset
from rangeclip_tpu.data.loader import ShardedBatchLoader as JaxLoader
from rangeclip_tpu.models.clip.crops import (
    prepare_image_crops as jax_crops,
)
from rangeclip_tpu.models.clip.provider import (
    HashImageEmbedder as JaxImageEmbedder,
)
from rangeclip_tpu.models.torch_interop import load_reference_checkpoint
from rangeclip_tpu.training import optim as jax_optim
from rangeclip_tpu.training.curriculum import (
    get_curriculum_schedule as jax_curriculum,
)
from rangeclip_tpu.utils import logging as jax_logging
from rangeclip_tpu_torch.cli import train
from rangeclip_tpu_torch.data import labels, synthetic
from rangeclip_tpu_torch.data.dataset import ImageDepthTextDataset
from rangeclip_tpu_torch.data.loader import (
    ShardedBatchLoader,
    deterministic_split,
    setup_dataloaders,
)
from rangeclip_tpu_torch.models.clip.crops import prepare_image_crops
from rangeclip_tpu_torch.models.clip.provider import HashImageEmbedder
from rangeclip_tpu_torch.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip_tpu_torch.models.interop import load_reference_pth
from rangeclip_tpu_torch.training import optim
from rangeclip_tpu_torch.training.curriculum import get_curriculum_schedule
from rangeclip_tpu_torch.utils import logging as port_logging

FILTERS = ["8", "16", "16", "16", "32"]


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
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    paths = synthetic.write_synthetic_dataset(str(root), n_samples=16,
                                              shape=(32, 32), num_classes=8)
    return root, paths


def _train_argv(paths, ckpt, *extra):
    return ["--labeled_metadata_path", paths["metadata"],
            "--labels_path", paths["labels"],
            "--equivalence_dict_path", paths["similarity"],
            "--checkpoint_path", str(ckpt), "--unet_architecture", "resnet",
            "--batch_size", "2", "--n_height", "32", "--n_width", "32",
            "--learning_rates", "1e-3", "--learning_schedule", "2",
            "--accumulation_steps", "2", "--embedding_dim", "32",
            "--encoder_filters", *FILTERS, "--n_step_per_summary", "1",
            "--n_step_per_checkpoint", "1", "--w_weight_decay", "1e-4",
            "--device", "cpu", *extra]


def _weights(ckpt_dir, step):
    return load_reference_pth(os.path.join(
        ckpt_dir, "checkpoints", f"depth_segmentation_model-{step}.pth"))


@pytest.fixture(scope="module")
def straight_run(dataset_dir, tmp_path_factory):
    _, paths = dataset_dir
    ckpt = tmp_path_factory.mktemp("straight")
    train.main(_train_argv(paths, ckpt, "--max_steps", "4"))
    return ckpt


def test_loader_batches_equal_jax(dataset_dir, monkeypatch):
    """Same split, per-epoch order, per-position object draws and decoded,
    transformed arrays (the JAX package's numpy transforms:
    RANGECLIP_NATIVE=off)."""
    monkeypatch.setenv("RANGECLIP_NATIVE", "off")
    _, paths = dataset_dir
    size = (24, 20)
    train_idx, _, _ = deterministic_split(16)
    ours = ShardedBatchLoader(
        ImageDepthTextDataset(paths["metadata"], paths["labels"], size),
        train_idx, 4, shuffle=True, drop_last=False, num_workers=3)
    theirs = JaxLoader(JaxDataset(paths["metadata"], paths["labels"], size),
                       train_idx, 4, shuffle=True, drop_last=False,
                       num_workers=1)
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours) == 3
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    loaders = setup_dataloaders(paths["metadata"], paths["labels"], size, 2,
                                3)
    assert loaders[3] == 5 * 3 and len(loaders[4]) == 8


def test_cli_train_writes_a_reference_checkpoint(straight_run):
    """Four steps on the CPU; the step-2 .pth loads strictly into the port's model
    and through the JAX package's reference-checkpoint loader; the
    optimizer state sits beside it; the summary CSV has every scalar."""
    sd = _weights(straight_run, 2)
    model = DepthUNet(DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                                      embedding_dim=32))
    model.load_state_dict(sd, strict=True)
    assert all(torch.isfinite(v.float()).all() for v in sd.values())
    params, _, step = load_reference_checkpoint(os.path.join(
        straight_run, "checkpoints", "depth_segmentation_model-2.pth"))
    assert step == 2 and "depth_encoder" in params
    assert os.path.exists(os.path.join(straight_run, "checkpoints",
                                       "optimizer-2.pt"))
    events = open(os.path.join(straight_run, "tensorboard-train",
                               "events.csv")).read()
    for tag in ("Loss/train_step", "Loss/smoothness",
                "Params/learning_rate", "train/curriculum/pct_hard"):
        assert tag in events


def test_kill_and_resume_is_bitwise_equal(dataset_dir, straight_run,
                                          tmp_path):
    """Stop after step 1 (inside the first epoch), resume with
    --auto_resume to step 2: the weights, BN statistics and temperatures
    equal the straight run's bit for bit (positional per-step draws, the
    consumed window skipped, the optimizer state restored)."""
    _, paths = dataset_dir
    train.main(_train_argv(paths, tmp_path, "--max_steps", "1"))
    first = _weights(tmp_path, 1)
    train.main(_train_argv(paths, tmp_path, "--max_steps", "2",
                           "--auto_resume"))
    log = open(os.path.join(tmp_path, "results.txt")).read()
    assert "Auto-resumed from step 1" in log and "skipping 1" in log
    got, want = _weights(tmp_path, 2), _weights(straight_run, 2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert any(not torch.equal(first[k], want[k]) for k in want)


def test_cli_train_validation_leaves_training_unchanged(dataset_dir,
                                                        straight_run,
                                                        tmp_path):
    """Validation at steps 2 and 4 (--validation_start_step 2
    --n_step_per_validation 2): the [Val] lines and the best results in
    results.txt and in the returned dict, the val scalars and grids under
    tensorboard-val, and the weights, BatchNorm statistics and temperatures
    at steps 2 and 4 bit-equal to the straight run's, whose validation
    never fires (eval mode and its own generators: no training draw, BN
    statistic or loader order moves)."""
    _, paths = dataset_dir
    best = train.main(_train_argv(paths, tmp_path, "--max_steps", "4",
                                  "--validation_start_step", "2",
                                  "--n_step_per_validation", "2"))
    log = open(os.path.join(tmp_path, "results.txt")).read()
    for step in (2, 4):
        assert f"[Val] [Step {step}] Top-k mIoU (equiv)" in log
    assert "Best validation loss" in log
    assert best["step"] in (2, 4) and "latest_val_loss" in best
    assert np.isfinite(best["mIoU_tk"]) and np.isfinite(best["loss"])
    events = open(os.path.join(tmp_path, "tensorboard-val",
                               "events.csv")).read()
    assert "val/mIoU_tk" in events and "val/avg_loss" in events
    assert os.listdir(os.path.join(tmp_path, "tensorboard-val", "images"))
    for step in (2, 4):
        got, want = _weights(tmp_path, step), _weights(straight_run, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (step, k)


@pytest.mark.parametrize("flags", [
    ["--ddp_parity"], ["--distributed"], ["--distributed", "--ddp_parity"]],
    ids=["ddp_parity", "distributed", "distributed_ddp_parity"])
def test_cli_train_multi_gpu_flags_at_world_one(dataset_dir, straight_run,
                                                tmp_path, flags):
    """The multi-GPU flags on one process, 2 steps, each bit-equal to the
    straight run at steps 1 and 2 (so the three are bit-equal to each
    other): --ddp_parity alone is the DDP step of one rank, whose draws
    are rank 0's, the single-device stream; --distributed at world 1
    (gloo, a file store), with or without --ddp_parity, is that step over
    a group of one, which is closed after the run."""
    _, paths = dataset_dir
    extra = list(flags)
    if "--distributed" in flags:
        extra += ["--coordinator_address", f"file://{tmp_path}/store",
                  "--num_processes", "1", "--process_id", "0"]
    train.main(_train_argv(paths, tmp_path, "--max_steps", "2", *extra))
    for step in (1, 2):
        got, want = _weights(tmp_path, step), _weights(straight_run, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (step, k)
    assert not torch.distributed.is_initialized()


def test_cli_train_profile_dir_traces_and_leaves_training_unchanged(
        dataset_dir, straight_run, tmp_path):
    """--profile_dir over 4 steps (validating at step 3, inside the traced
    steps 2-4): a Chrome trace is written and logged, and the step-4
    weights are bit-equal to the straight run's, without the flag; a
    3-step run closes its trace at its end."""
    _, paths = dataset_dir
    train.main(_train_argv(paths, tmp_path / "traced", "--max_steps", "4",
                           "--validation_start_step", "3",
                           "--n_step_per_validation", "3",
                           "--profile_dir", str(tmp_path / "trace")))
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
    trace = json.load(open(tmp_path / "trace" / traces[0]))
    assert trace["traceEvents"]
    log = open(tmp_path / "traced" / "results.txt").read()
    assert f"Profiler trace written to {tmp_path / 'trace'}" in log
    assert "[Val] [Step 3]" in log
    got, want = _weights(tmp_path / "traced", 4), _weights(straight_run, 4)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    train.main(_train_argv(paths, tmp_path / "short", "--max_steps", "3",
                           "--profile_dir", str(tmp_path / "short_trace")))
    assert len(os.listdir(tmp_path / "short_trace")) == 1
    assert not torch.autograd._profiler_enabled()
    log = open(tmp_path / "short" / "results.txt").read()
    assert "Profiler trace written to" in log


def test_host_copies_match_jax(dataset_dir, tmp_path, monkeypatch):
    """Curriculum, schedules, label structures, logging, the synthetic
    writer, crops and the hash image stub against their JAX originals."""
    monkeypatch.setenv("RANGECLIP_NATIVE", "off")
    root, paths = dataset_dir
    for total in (1, 7, 40):
        for epoch in range(0, total + 1):
            assert get_curriculum_schedule(epoch, total) == \
                jax_curriculum(epoch, total)
    for kind in ("multi_step", "cosine_annealing", "reduce_on_plateau"):
        ours = optim.make_lr_schedule(kind, [1e-3, 1e-4, 1e-5], [2, 4, 6])
        theirs = jax_optim.make_lr_schedule(kind, [1e-3, 1e-4, 1e-5],
                                            [2, 4, 6])
        for epoch, metric in enumerate([5, 4, 4, 4, 4, 4, 4, 4, 4, 3]):
            assert ours(epoch) == theirs(epoch)
            ours.step_metric(metric)
            theirs.step_metric(metric)

    C = len(labels.load_candidate_labels(paths["labels"]))
    eq, eq_j = (m.load_equivalence_dict(paths["similarity"])
                for m in (labels, jax_labels))
    assert eq == eq_j
    tensor = labels.build_equivalence_tensor(eq, C)
    np.testing.assert_array_equal(
        tensor, jax_labels.build_equivalence_tensor(eq_j, C))
    np.testing.assert_array_equal(
        labels.build_equivalence_class_map(tensor),
        jax_labels.build_equivalence_class_map(tensor))
    sets = labels.load_label_similarity_sets(paths["similarity"], C)
    assert sets == jax_labels.load_label_similarity_sets(
        paths["similarity"], C)
    for a, b in zip(labels.build_similarity_matrices(sets, C),
                    jax_labels.build_similarity_matrices(sets, C)):
        np.testing.assert_array_equal(a, b)

    theirs = jax_synthetic.write_synthetic_dataset(
        str(tmp_path / "jax"), n_samples=16, shape=(32, 32), num_classes=8)
    for key, path in paths.items():
        other = theirs[key]
        if path.endswith(".csv"):
            assert open(path).read() == open(other).read()
    for name in os.listdir(root):
        if name.endswith(".png"):
            assert open(root / name, "rb").read() == \
                open(tmp_path / "jax" / name, "rb").read()
    ds = synthetic.SyntheticDepthSegDataset(4, (24, 32), 6, seed=3)
    ds_j = jax_synthetic.SyntheticDepthSegDataset(4, (24, 32), 6, seed=3)
    for i in range(4):
        for k, v in ds_j[i].items():
            np.testing.assert_array_equal(ds[i][k], v, err_msg=k)

    logs = []
    for module, sub in ((port_logging, "port"), (jax_logging, "jax")):
        path = str(tmp_path / sub / "results.txt")
        module.log("hello", path, to_console=False)
        module.log_configuration(path, {"a": 1, "b": [2, 3]})
        writer = module.ScalarWriter(str(tmp_path / sub / "tb"))
        writer.add_scalar("x/y", 1.5, 3)
        writer.add_scalars("c", {"p": 0.25, "q": "n/a"}, 4)
        writer.close()
        rows = [line.split(",")[1:] for line in open(
            tmp_path / sub / "tb" / "events.csv").read().splitlines()]
        logs.append((open(path).read(), rows))
    assert logs[0] == logs[1]

    rng = np.random.default_rng(12)
    images = rng.random((3, 40, 30, 3)).astype(np.float32)
    boxes = np.array([[2, 3, 20, 30], [0, 0, 30, 40], [10, 5, 11, 6]],
                     np.int32)
    want = np.asarray(jax_crops(jnp.asarray(images), jnp.asarray(boxes),
                                out_size=32))
    got = prepare_image_crops(torch.from_numpy(images),
                              torch.from_numpy(boxes), out_size=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    stub = JaxImageEmbedder(dim=16)
    ours = HashImageEmbedder(dim=16, projection=np.asarray(stub._proj))
    np.testing.assert_allclose(ours(got).numpy(),
                               np.asarray(stub(jnp.asarray(want))),
                               rtol=1e-5, atol=1e-5)
