"""The MiT UNet under a grid's 'spatial' axis (JAX's GSPMD partitioning of
its flax MiT when the mesh shards H: ``rangeclip_tpu/parallel/predict.py:
218``, ``tests/test_parallel.py:108-110``) against JAX on the CPU: the
global-batch step on (1, 2, 1) and (2, 2, 1) against JAX's single-device
MiT step on the whole batch, with JAX's draws fed; the grid predict in f32
on (1, 2, 1) and (1, 2, 2) against JAX's single-device predict; and the
refusals, which read the field's scale (the MiT's field is at H/4).

Four gloo ranks on the CPU (``tests/torch_dist_worker.py``, mode
``grid_mit``), one spawn for the file.  The model is
``test_torch_mit.py``'s narrow MiT (stage widths 16-96, D = 32) with JAX's
weights loaded through ``state_dict_from_jax``, at 32^2: its last stage and
every ``sr`` output have one row, so on two spatial ranks rank 1 owns none
of them, and still takes part in each attention's gather of K and V and in
its backward.  The step's inputs and draws are
``test_torch_mit.test_mit_native_loss_step_matches_jax``'s, with SGD as
``test_torch_spatial_step.py`` takes it, and its tolerances: the loss
within rtol 2e-4, ``log_temperature_text`` within rtol 1e-5 and
``test_torch_global_batch.assert_step_close``; the ranks of a grid end
bit-equal.  Predicted labels equal JAX's but for counted near-ties (within
1e-5 of the cosine)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rangeclip_tpu.losses.hybrid import HybridLossConfig as JaxLossConfig
from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.training.state import TrainState as JaxTrainState
from rangeclip_tpu.training.train_step import make_train_step as jax_step
from rangeclip_tpu_torch.evals.validate import validate_model
from rangeclip_tpu_torch.models.interop import state_dict_from_jax
from rangeclip_tpu_torch.parallel.dryrun import near_ties
from rangeclip_tpu_torch.parallel.mesh import Grid
from rangeclip_tpu_torch.parallel.predict import (
    make_grid_predict,
    pad_class_table,
)
from test_torch_global_batch import LR, assert_step_close
from test_torch_mit import (
    CONFIGS,
    C,
    D,
    K,
    _draws,
    _inputs,
    _models,
    mit_step_inputs,
)
from torch_dist_worker import join_ranks, start_ranks

A, B, H = 2, 2, 32
STEP_GRIDS = ((1, 2, 1), (2, 2, 1))
PREDICT_GRIDS = ((1, 2, 1), (1, 2, 2))
CFG = CONFIGS["mit"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's results; JAX's single-device step and predict (computed
    here while the ranks run); the port model, the predict's inputs and
    the initial weights."""
    tmp = tmp_path_factory.mktemp("grid_mit")
    model, v, port = _models("mit")
    init = state_dict_from_jax(v["params"], {})
    batch, text, medium, hard = mit_step_inputs(A, B, H)
    key = jax.random.key(7)
    draws = {}
    for i, d in enumerate(_draws(key, A, B, H)):
        draws[f"step.pixels.{i}"] = d.pixels.numpy()
        draws[f"step.gumbel0.{i}"] = d.gumbel[0].numpy()
        draws[f"step.gumbel1.{i}"] = d.gumbel[1].numpy()
    depth, table, _ = _inputs(3)
    np.savez(tmp / "inputs.npz", unet_type="mit", use_batch_norm=False,
             filters=np.array(CFG["encoder_filters"]), dim=np.int32(D),
             **{f"sd.{k}": a.numpy() for k, a in init.items()},
             **{f"step.{k}": a for k, a in batch.items()}, **draws,
             **{"step.text": text, "step.medium": medium, "step.hard": hard,
                "step.lr": np.float32(LR),
                "step.grids": np.array(STEP_GRIDS),
                "predict.depth": depth, "predict.table": table,
                "predict.top_k": np.int32(K),
                "predict.grids": np.array(PREDICT_GRIDS)})
    procs = start_ranks("grid_mit", 4, tmp, tmp / "inputs.npz", threads=1)
    opt = optax.sgd(1.0)
    jstate, jinfo = jax_step(model, opt, JaxLossConfig(), accum_steps=A,
                             donate=False)(
        JaxTrainState(step=jnp.int32(0), params=v["params"], batch_stats={},
                      opt_state=opt.init(v["params"])),
        {k: jnp.asarray(a) for k, a in batch.items()}, key,
        jnp.float32(LR), jnp.float32(0.3), jnp.float32(0.5),
        jnp.asarray(text), jnp.asarray(medium), jnp.asarray(hard))
    jstate = jax.device_get(jstate)
    want_step = {"state": state_dict_from_jax(jstate.params, {}),
                 "info": {k: float(a)
                          for k, a in jax.device_get(jinfo).items()}}
    want_labels = torch.from_numpy(np.array(jax.jit(
        lambda v, x, t: model.apply(
            v, x, t, jnp.ones((C,), bool), K, method=JaxDepthUNet.predict,
            scoring="xla", return_embeddings=False)[0])(
        v, jnp.asarray(depth), jnp.asarray(table))))
    ranks = [torch.load(p) for p in join_ranks(*procs)]
    return ranks, want_step, want_labels, init, port, depth, table


def _members(ranks, part, shape):
    n = int(np.prod(shape))
    assert all(shape not in r[part] for r in ranks[n:])
    return [r[part][shape] for r in ranks[:n]]


@pytest.mark.parametrize("shape", STEP_GRIDS)
def test_mit_grid_step_matches_jax_single_device(run, shape):
    """Rank 0 of the grid against JAX's single-device MiT step on the
    whole batch: the loss, ``log_temperature_text`` and every parameter."""
    ranks, want, _, init, _, _, _ = run
    got = _members(ranks, "step", shape)[0]
    np.testing.assert_allclose(got["info"]["total_loss"],
                               want["info"]["total_loss"], rtol=2e-4)
    np.testing.assert_allclose(
        got["state"]["log_temperature_text"].numpy(),
        want["state"]["log_temperature_text"].numpy(), rtol=1e-5)
    assert_step_close(got, want, init)


@pytest.mark.parametrize("shape", STEP_GRIDS)
def test_mit_grid_step_ranks_end_bit_equal(run, shape):
    """Every rank of the grid, the one owning no row of the last stage
    included, holds rank 0's parameters and info."""
    lead, *rest = _members(run[0], "step", shape)
    for res in rest:
        assert sorted(res["state"]) == sorted(lead["state"])
        for name, v in lead["state"].items():
            assert torch.equal(res["state"][name], v), name
        assert res["info"] == lead["info"]


@pytest.mark.parametrize("shape", PREDICT_GRIDS)
def test_mit_grid_predict_matches_jax_single_device(run, shape):
    """Every rank gathered the same [2, 32, 32, 4] map: JAX's labels and
    the port's single-device ones except counted near-ties."""
    ranks, _, want, _, port, depth, table = run
    maps = _members(ranks, "predict", shape)
    for got in maps:
        assert got.shape == (B, H, H, K) and got.dtype == torch.int32
        assert torch.equal(got, maps[0])
    x, t = torch.from_numpy(depth), torch.from_numpy(table)
    with torch.no_grad():
        single = port.predict(x, t, None, K, return_embeddings=False)[0]
    for other in (want, single):
        ties = near_ties(maps[0], other, port, x, t, 1e-5)
        assert ties <= 0.001 * want.numel(), (shape, ties)


def test_mit_grid_refusals(run):
    """The checks read the field's scale, 4 for the MiT: a 36-row batch
    (18 rows a rank on two spatial ranks, even but not a multiple of 4)
    is refused by both ranks' step, by the grid predict and by grid
    validation, each before any collective of the model; 'folded' still
    cannot spatially shard."""
    ranks = run[0]
    for res in ranks[:2]:
        assert res["refusal"] is not None
        assert "must divide by 4 x the 'spatial' size 2" in res["refusal"], \
            res["refusal"]
    port = run[4]
    groups = {"data": None, "spatial": None, "model": None, "batch": None}
    grid = Grid(1, 2, 1, 0, 0, 0, groups)
    with pytest.raises(ValueError, match="'folded' cannot spatially shard"):
        make_grid_predict(port, grid, K, predict_path="folded")
    padded, ids = pad_class_table(torch.zeros(C, D), 1)
    with pytest.raises(ValueError, match="height 36 must divide by 4x the "
                                         "'spatial' size 2"):
        make_grid_predict(port, grid, K)(torch.zeros(B, 36, 32, 1), padded,
                                         ids)
    rng = np.random.default_rng(0)
    batch = {"depth": np.zeros((B, 36, 32, 1), np.float32),
             "segmentation": np.zeros((B, 36, 32), np.int32),
             "object_label": np.zeros(B, np.int32),
             "sample_valid": np.ones(B, np.float32),
             "image": rng.random((B, 36, 32, 3)).astype(np.float32),
             "object_bbox": np.tile(np.array([0, 0, 16, 16], np.int32),
                                    (B, 1))}
    provider = lambda crops: torch.zeros(crops.shape[0], D)  # noqa: E731
    with pytest.raises(ValueError, match="height 36 must divide by 4x the "
                                         "'spatial' size 2"):
        validate_model(port, [batch], torch.zeros(C, D),
                       torch.zeros(C, C, dtype=torch.bool),
                       torch.zeros(C, C, dtype=torch.bool),
                       torch.eye(C, dtype=torch.bool), torch.arange(C),
                       {"pct_medium": 0.3, "pct_hard": 0.5}, provider, 1,
                       {}, group=grid)
