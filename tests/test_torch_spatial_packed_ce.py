"""The bf16 packed-CE train step at C = 2048 with the class tables split
over 'model' on a (2, 1, 2) process grid, against the same step on one
device on the whole batch (its data-only run, JAX's
``tests/test_parallel.py:538``).

Four gloo ranks on the CPU (``tests/torch_dist_worker.py``, mode
``grid_step``) each hold their data block of JAX's 8-row batch and their
model slice of the tables; the one-device step runs here meanwhile, from
the same weights (seed 5), batch and generators.  Held to JAX's two
checks (the loss terms within rtol 5e-3 / atol 1e-5, the parameters'
summed magnitude within rtol 1e-3) and to the dry run's
(``parallel/dryrun.check_step`` with ``LARGE_C_TOLERANCE``: the gradients
within 0.1 of their norm, the loss within 5e-3, every parameter within
2 lr, every rank bit-equal to rank 0).  The bf16 steps run without oneDNN
on the CPU (``parallel/dryrun.native_cpu_convolutions``)."""

import math

import numpy as np
import pytest
import torch

from rangeclip_tpu_torch.losses.hybrid import HybridLossConfig
from rangeclip_tpu_torch.parallel.dryrun import (
    LARGE_C,
    LARGE_C_TOLERANCE,
    StepSpec,
    _snapshot,
    check_step,
    native_cpu_convolutions,
)
from rangeclip_tpu_torch.training.state import create_train_state
from rangeclip_tpu_torch.training.train_step import make_train_step
from torch_dist_worker import big_config, join_ranks, start_ranks

GRID = (2, 1, 2)
LOSS_KEYS = ("total_loss", "text_contrastive_loss", "image_contrastive_loss",
             "smoothness_loss")


def _inputs():
    """JAX's C = 2048 packed-CE batch (``tests/test_parallel.py:538``):
    8 rows of 16^2, labels kept under 64 so that packing never overflows,
    D = 128."""
    rng = np.random.default_rng(17)
    C = 2048
    seg = rng.integers(0, C, size=(2, 8, 16, 16)).astype(np.int32) % 64
    batch = {
        "depth": rng.standard_normal((2, 8, 16, 16, 1)).astype(np.float32),
        "segmentation": seg,
        "object_label": np.ones((2, 8), np.int32),
        "image_embeddings": rng.standard_normal((2, 8, 128)).astype(
            np.float32),
        "sample_valid": np.ones((2, 8), np.float32),
    }
    tables = {"text": rng.standard_normal((C, 128)).astype(np.float32),
              "medium": np.zeros((C, C), bool), "hard": np.zeros((C, C), bool)}
    return batch, tables


def _single(batch, tables):
    """The packed-CE step on one device: the same weights (seed 5), batch
    and generators as the grid's ranks."""
    state = create_train_state(big_config(), torch.device("cpu"), 1e-4, 5)
    step = make_train_step(HybridLossConfig(contrast_capacity=128), 2)
    t = torch.from_numpy
    with native_cpu_convolutions(True, "cpu"):  # as the ranks run it
        state, info = step(state, {k: t(v) for k, v in batch.items()},
                           (3, 0), 1e-3, 0.25, 0.5, t(tables["text"]),
                           t(tables["medium"]), t(tables["hard"]))
    return _snapshot(state, info)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's snapshot after the step, and the one-device step's
    (computed here while the ranks run)."""
    tmp = tmp_path_factory.mktemp("packed_ce")
    batch, tables = _inputs()
    np.savez(tmp / "inputs.npz", grids=np.zeros((0, 3), np.int64),
             **{"big.grid": np.array(GRID)},
             **{f"big.{k}": v for k, v in {**batch, **tables}.items()})
    procs = start_ranks("grid_step", int(np.prod(GRID)), tmp,
                        tmp / "inputs.npz", threads=1)
    want = _single(batch, tables)
    ranks = [torch.load(p)["big"] for p in join_ranks(*procs)]
    return ranks, want


def test_model_sharded_packed_ce_step_matches_single_device(run):
    """JAX's checks: the loss terms finite and within rtol 5e-3 / atol
    1e-5, the parameters' summed magnitude within rtol 1e-3."""
    ranks, want = run
    lead = ranks[0]
    for k in LOSS_KEYS:
        assert np.isfinite(lead["info"][k])
        np.testing.assert_allclose(lead["info"][k], want["info"][k],
                                   rtol=5e-3, atol=1e-5, err_msg=k)
    norm = lambda params: sum(float(v.double().abs().sum())  # noqa: E731
                              for v in params.values())
    np.testing.assert_allclose(norm(lead["params"]), norm(want["params"]),
                               rtol=1e-3)


def test_model_sharded_packed_ce_step_gradients(run):
    """The dry run's check of this step: the ranks bit-equal, the
    gradients of the model-sharded bf16 CE within 0.1 of the one-device
    step's norm, and every parameter within 2 lr of it; the step moved
    the parameters as far as the one-device step (within 5%)."""
    ranks, want = run
    spec = StepSpec(**LARGE_C, grid=GRID, shard_classes=True, batch=4)
    errors = check_step(ranks, want, spec, LARGE_C_TOLERANCE)
    assert errors["grads_norm"] <= LARGE_C_TOLERANCE.grads_norm
    # Adam's first step moves each trained entry by about lr: a state left
    # as it was (or half updated) shows in the size of the move
    init = dict(create_train_state(big_config(), torch.device("cpu"), 1e-4,
                                   5).model.named_parameters())

    def moved(params):
        return math.sqrt(sum(float((params[n].double() - p.detach().double())
                                   .square().sum())
                             for n, p in init.items()))

    assert moved(want["params"]) > 0
    np.testing.assert_allclose(moved(ranks[0]["params"]),
                               moved(want["params"]), rtol=0.05)
