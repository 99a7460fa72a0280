"""Spatially sharded predict over a process grid (JAX's 'spatial' mesh axis,
``rangeclip_tpu/parallel/predict.py:218-260``) against JAX's single-device
``DepthUNet.predict``, at ``tests/test_parallel.py:449``'s configuration
(B 4, 32^2, C 100, top-5) on the grids (1, 2, 1), (2, 2, 1) and (1, 4, 2).

Eight gloo ranks on the CPU (``tests/torch_dist_worker.py``, mode
``grid_predict``) hold every grid in turn: each rank runs ``native_field``
on its block (its halo rows from its spatial neighbours), scores its slice
of the padded table, joins the exact merge over its 'model' group and
upsamples its own label rows; the map is gathered.  Its labels must equal
the port's single-device predict, and JAX's except near-ties (top-k values
within 1e-5 of the cosine, counted: the port and JAX round the network
otherwise).  JAX's refusals keep their text."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu_torch.parallel.dryrun import near_ties
from rangeclip_tpu_torch.parallel.mesh import Grid
from rangeclip_tpu_torch.parallel.predict import (
    make_grid_predict,
    pad_class_table,
)
from test_torch_model import DIM, FILTERS, jax_and_port
from torch_dist_worker import join_ranks, start_ranks

B, H, C, K = 4, 32, 100, 5
GRIDS = ((1, 2, 1), (2, 2, 1), (1, 4, 2))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's gathered maps, JAX's single-device labels, the port's
    single-device labels and the inputs."""
    tmp = tmp_path_factory.mktemp("grid_predict")
    model, v, port = jax_and_port()
    rng = np.random.default_rng(21)
    depth = rng.standard_normal((B, H, H, 1)).astype(np.float32)
    table = rng.standard_normal((C, DIM)).astype(np.float32)
    np.savez(tmp / "inputs.npz", depth=depth, table=table, top_k=K,
             grids=np.array(GRIDS), filters=np.array(FILTERS), dim=DIM,
             **{f"sd.{k}": t.numpy() for k, t in port.state_dict().items()})
    procs = start_ranks("grid_predict", 8, tmp, tmp / "inputs.npz",
                        threads=1)
    want = np.array(jax.jit(lambda v, x, t: model.apply(
        v, x, t, jnp.ones((C,), bool), K, method=JaxDepthUNet.predict,
        return_embeddings=False)[0])(v, jnp.asarray(depth),
                                     jnp.asarray(table)))
    with torch.no_grad():
        single = port.predict(torch.from_numpy(depth),
                              torch.from_numpy(table), None, K,
                              return_embeddings=False)[0]
    ranks = [torch.load(p) for p in join_ranks(*procs)]
    return ranks, torch.from_numpy(want), single, port, depth, table


@pytest.mark.parametrize("shape", GRIDS)
def test_spatial_predict_matches_jax_single_device(run, shape):
    """Every rank of the grid gathered the same [4, 32, 32, 5] map: the
    port's single-device labels, and JAX's except counted near-ties."""
    ranks, want, single, port, depth, table = run
    n = int(np.prod(shape))
    maps = [r[shape] for r in ranks[:n]]
    assert all(shape not in r for r in ranks[n:])
    for got in maps:
        assert got.shape == (B, H, H, K) and got.dtype == torch.int32
        assert torch.equal(got, maps[0])
    assert torch.equal(maps[0], single), shape
    ties = near_ties(maps[0], want, port, torch.from_numpy(depth),
                     torch.from_numpy(table), 1e-5)
    assert ties <= 0.001 * want.numel(), (shape, ties)


def test_spatial_predict_refusals():
    """JAX's refusals: 'folded' cannot spatially shard; the height must
    divide by twice the 'spatial' size (raised before any collective).  A
    grid without a 'spatial' axis is make_sharded_predict's."""
    _, _, port = jax_and_port()
    groups = {"data": None, "spatial": None, "model": None, "batch": None}
    grid = Grid(1, 4, 1, 0, 0, 0, groups)
    with pytest.raises(ValueError, match="'folded' cannot spatially shard"):
        make_grid_predict(port, grid, K, predict_path="folded")
    with pytest.raises(ValueError, match="make_sharded_predict"):
        make_grid_predict(port, Grid(2, 1, 2, 0, 0, 0, groups), K)
    fn = make_grid_predict(port, grid, K)
    padded, ids = pad_class_table(torch.zeros(C, DIM), 1)
    with pytest.raises(ValueError, match="must divide by 2x the 'spatial'"):
        fn(torch.zeros(B, 36, 32, 1), padded, ids)
