"""The global-batch step on a ``data x spatial x model`` process grid (JAX's
step jitted over its three-axis mesh, ``tests/test_parallel.py:77-113``)
against JAX's single-device ``make_train_step`` on the whole batch, on the
grids (1, 2, 1), (2, 2, 1) and (2, 2, 2), the class tables split over
'model' where it has two ranks (``shard_classes=(n_model > 1)``).  The
packed-CE step at C = 2048 is ``test_torch_spatial_packed_ce.py``'s.

Eight gloo ranks on the CPU (``tests/torch_dist_worker.py``, mode
``grid_step``) hold every grid in turn, each rank its data block of the
8-row batch and its spatial block of the 32 rows; the weights, batch and
draws are ``test_torch_global_batch.py``'s (JAX's draws for the whole
batch, SGD as JAX's tests take it).  JAX's tolerances: the loss within
rtol 2e-4 and ``log_temperature_text`` within rtol 1e-5, and the global
step's own on the parameters and BatchNorm statistics
(``test_torch_global_batch.assert_step_close``).  Every rank of a grid ends
with the same parameters, statistics and info, bit for bit: its model
replicas compute the same rows, its spatial ranks sum one gradient.  In
the same spawn, the instance-norm UNet (``use_instance_norm``) steps on
(1, 2, 1), held to JAX's single-device step of the same model by the same
bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rangeclip_tpu.losses.hybrid import HybridLossConfig as JaxLossConfig
from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.models.depth_unet import DepthUNetConfig as JaxConfig
from rangeclip_tpu.models.torch_interop import convert_reference_checkpoint
from rangeclip_tpu.training.state import TrainState as JaxTrainState
from rangeclip_tpu.training.train_step import make_train_step as jax_step
from rangeclip_tpu_torch.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip_tpu_torch.models.interop import state_dict_from_jax
from test_torch_global_batch import (
    FILTERS,
    LR,
    A,
    D,
    _inputs,
    assert_step_close,
)
from torch_dist_worker import join_ranks, start_ranks

GRIDS = ((1, 2, 1), (2, 2, 1), (2, 2, 2))
INORM_GRID = (1, 2, 1)
INORM = dict(use_batch_norm=False, use_instance_norm=True)


def _jax_step(port, batch, tables, key, **norm):
    """JAX's single-device step on the whole batch from ``port``'s weights
    (the model's norm fields in ``norm``), as a port state dict and
    info."""
    params, stats = convert_reference_checkpoint(
        *({k: v.detach().numpy() for k, v in m.state_dict().items()}
          for m in (port.encoder, port.decoder)),
        port.log_temperature_text.detach().numpy(),
        port.log_temperature_image.detach().numpy())
    opt = optax.sgd(1.0)
    model = JaxDepthUNet(JaxConfig(encoder_filters=FILTERS, embedding_dim=D,
                                   **norm))
    step = jax_step(model, opt, JaxLossConfig(), accum_steps=A, donate=False)
    jstate, jinfo = step(
        JaxTrainState(step=jnp.int32(0), params=params, batch_stats=stats,
                      opt_state=opt.init(params)),
        {k: jnp.asarray(v) for k, v in batch.items()}, key,
        jnp.float32(LR), jnp.float32(0.25), jnp.float32(0.5),
        jnp.asarray(tables["text"]), jnp.asarray(tables["medium"]),
        jnp.asarray(tables["hard"]))
    jstate = jax.device_get(jstate)
    return {"state": state_dict_from_jax(jstate.params, jstate.batch_stats),
            "info": {k: float(v) for k, v in jax.device_get(jinfo).items()}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's results; JAX's single-device steps of the BatchNorm and
    the instance-norm UNets (computed here while the ranks run), and their
    initial weights."""
    tmp = tmp_path_factory.mktemp("grid_step")
    batch, tables, port, init, key, draws = _inputs()
    inorm = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                      embedding_dim=D, **INORM),
                      generator=torch.Generator().manual_seed(6))
    inorm_init = {k: v.clone() for k, v in inorm.state_dict().items()}
    np.savez(tmp / "inputs.npz", **batch, **tables, **draws,
             lr=np.float32(LR), filters=np.array(FILTERS), dim=np.int32(D),
             grids=np.array(GRIDS),
             **{f"sd.{k}": v.numpy() for k, v in init.items()},
             **{"inorm.grids": np.array([INORM_GRID])},
             **{f"inorm.{k}": v for k, v in INORM.items()},
             **{f"inorm.sd.{k}": v.numpy() for k, v in inorm_init.items()})
    procs = start_ranks("grid_step", 8, tmp, tmp / "inputs.npz", threads=1)
    want = _jax_step(port, batch, tables, key, use_batch_norm=True)
    want_inorm = _jax_step(inorm, batch, tables, key, **INORM)
    ranks = [torch.load(p) for p in join_ranks(*procs)]
    return ranks, want, init, (want_inorm, inorm_init)


def _members(ranks, shape):
    n = int(np.prod(shape))
    assert all(shape not in r for r in ranks[n:])
    return [r[shape] for r in ranks[:n]]


@pytest.mark.parametrize("shape", GRIDS)
def test_grid_step_matches_jax_single_device(run, shape):
    """Rank 0 of the grid against JAX's single-device step on the 8-row
    batch: the loss (rtol 2e-4, and ``assert_step_close``'s 2e-5),
    ``log_temperature_text``
    (rtol 1e-5), every parameter and BatchNorm statistic."""
    ranks, want, init, _ = run
    got = _members(ranks, shape)[0]
    np.testing.assert_allclose(got["info"]["total_loss"],
                               want["info"]["total_loss"], rtol=2e-4)
    np.testing.assert_allclose(
        got["state"]["log_temperature_text"].numpy(),
        want["state"]["log_temperature_text"].numpy(), rtol=1e-5)
    assert_step_close(got, want, init)


@pytest.mark.parametrize("shape", GRIDS)
def test_grid_step_ranks_end_bit_equal(run, shape):
    """Every rank of the grid (its spatial ranks, its model replicas, its
    data blocks) holds rank 0's parameters, statistics and info."""
    lead, *rest = _members(run[0], shape)
    for res in rest:
        assert sorted(res["state"]) == sorted(lead["state"])
        for name, v in lead["state"].items():
            assert torch.equal(res["state"][name], v), name
        assert res["info"] == lead["info"]


def test_instance_norm_grid_step_matches_one_device(run):
    """The instance-norm UNet (its statistics summed over 'spatial' only)
    stepped on 1 x 2 x 1 against JAX's single-device step of the same
    weights, batch and draws, by the BatchNorm grid's bounds; both ranks
    bit-equal."""
    ranks, _, _, (want, init) = run
    members = [r[("inorm",) + INORM_GRID] for r in ranks[:2]]
    assert all(("inorm",) + INORM_GRID not in r for r in ranks[2:])
    got = members[0]
    assert not any("running_" in k for k in got["state"])
    np.testing.assert_allclose(got["info"]["total_loss"],
                               want["info"]["total_loss"], rtol=2e-4)
    np.testing.assert_allclose(
        got["state"]["log_temperature_text"].numpy(),
        want["state"]["log_temperature_text"].numpy(), rtol=1e-5)
    assert_step_close(got, want, init)
    for name, v in got["state"].items():
        assert torch.equal(members[1]["state"][name], v), name
    assert members[1]["info"] == got["info"]
