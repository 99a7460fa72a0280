"""The port's data-parallel, class-sharded predict on the CPU: its grids
stand in for JAX's virtual devices as ``[cpu] * n``.  ``pad_class_table``
against JAX's; the sharded predict (folded and default, f32) on ``2 x 2``
and ``1 x 3`` grids against JAX's ``make_sharded_predict`` on the same CPU
meshes with the same weights (the JAX package's reference-checkpoint
converter) and against the port's single-device predict: labels exactly equal.  A tie
across slices goes to the smaller global id; the packed and fused
selectors return the value that ranked each id; ``cli/serve``'s sharded
route through ``devices``, and its two refusals."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rangeclip_tpu.parallel.predict import (
    make_sharded_predict as jax_make_sharded_predict,
)
from rangeclip_tpu.parallel.predict import pad_class_table as jax_pad
from rangeclip_tpu.parallel.predict import shard_predict_inputs
from rangeclip_tpu_torch.cli import serve
from rangeclip_tpu_torch.models.depth_unet import predict_folded
from rangeclip_tpu_torch.models.interop import save_reference_pth
from rangeclip_tpu_torch.ops.kernels.conv_score_topk import (
    conv_score_topk,
    fold_to_rows,
)
from rangeclip_tpu_torch.ops.kernels.score_topk import score_topk
from rangeclip_tpu_torch.parallel import (
    make_mesh,
    make_sharded_predict,
    pad_class_table,
)
from rangeclip_tpu_torch.parallel.predict import merge_topk
from test_torch_model import FILTERS, jax_and_port

B, H, C, D, K = 4, 32, 61, 32, 3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port model with the same weights,
    depth [B, H, H, 1], table [C, D]) from seeds: the port's random weights
    (norm statistics randomised too) carried to JAX by the JAX package's
    reference-checkpoint converter."""
    model, variables, port = jax_and_port(seed=2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, H, H, 1)).astype(np.float32)
    table = rng.standard_normal((C, D)).astype(np.float32)
    return model, variables, port, x, table


@pytest.mark.parametrize("n_model,rows", [(3, 72), (2, 64)])
def test_pad_class_table_matches_jax(n_model, rows):
    """C = 61 over 3 (and 2) slices at the CPU's quantum 8, the quantum
    following the table's device (CUDA's 128 runs in ``chip_smoke.py``'s
    sharded predict): pad rows are zero with id -1, as JAX pads them
    off-TPU."""
    table = np.random.default_rng(0).standard_normal((C, D)).astype(
        np.float32)
    got_t, got_ids = pad_class_table(torch.from_numpy(table), n_model)
    want_t, want_ids = jax_pad(jnp.asarray(table), n_model,
                               lane_multiple=False)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert got_ids.dtype == torch.int32
    assert got_t.shape[0] == rows and int((got_ids < 0).sum()) == rows - C


@pytest.mark.parametrize("grid", [(2, 2), (1, 3)])
@pytest.mark.parametrize("path", ["folded", "default"])
def test_sharded_predict_matches_jax_and_single_device(models, grid, path):
    model, variables, port, x, table = models
    n_data, n_model = grid
    mesh = jax_make_mesh(n_data=n_data, n_model=n_model)
    padded, ids = jax_pad(jnp.asarray(table), n_model, lane_multiple=False)
    fn = jax_make_sharded_predict(model, mesh, top_k=K, predict_path=path)
    with jax.sharding.set_mesh(mesh):
        want = np.asarray(jax.device_get(fn(
            variables, *shard_predict_inputs(mesh, jnp.asarray(x), padded,
                                             ids))))

    depth, text = torch.from_numpy(x), torch.from_numpy(table)
    grid_mesh = make_mesh(n_data, n_model, [CPU] * (n_data * n_model))
    got = make_sharded_predict(port, grid_mesh, K, path)(
        depth, *pad_class_table(text, n_model))
    single = (predict_folded(port, depth, text, top_k=K) if path == "folded"
              else port.predict(depth, text, None, K,
                                return_embeddings=False)[0])
    assert got.shape == (B, H, H, K) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, single)


def test_merge_breaks_ties_to_the_smaller_global_id():
    """Per pixel, two columns' local picks with equal values: the merge
    takes value descending, then id ascending, whichever column holds the
    smaller id; dead picks (-1, -1e30) sort last."""
    left = (torch.tensor([[3, 5, 1]], dtype=torch.int32),
            torch.tensor([[0.5, 0.25, 0.25]]))
    right = (torch.tensor([[2, 7, -1]], dtype=torch.int32),
             torch.tensor([[0.5, 0.25, -1e30]]))
    got = merge_topk([left, right], CPU, 5)
    assert got.tolist() == [[2, 3, 1, 5, 7]]
    got = merge_topk([right, left], CPU, 6)
    assert got.tolist() == [[2, 3, 1, 5, 7, -1]]


@pytest.mark.parametrize("path", ["folded", "default"])
def test_duplicated_row_across_slices_resolves_to_the_smaller_id(models,
                                                                 path):
    """Table row 3 copied into row 40 (another slice of a 1 x 2 grid):
    the two score alike, so every pixel that ranks them ranks 3 first, as
    single-device predict does."""
    _, _, port, x, table = models
    table = table.copy()
    table[40] = table[3]
    depth, text = torch.from_numpy(x), torch.from_numpy(table)
    got = make_sharded_predict(port, make_mesh(1, 2, [CPU] * 2), K, path)(
        depth, *pad_class_table(text, 2))
    single = (predict_folded(port, depth, text, top_k=K) if path == "folded"
              else port.predict(depth, text, None, K,
                                return_embeddings=False)[0])
    assert torch.equal(got, single)
    pos3, pos40 = ((got == c).int().argmax(-1) for c in (3, 40))
    both = (got == 3).any(-1) & (got == 40).any(-1)
    assert both.sum() > 0 and bool((pos3[both] < pos40[both]).all())
    assert not bool(((got == 40).any(-1) & ~(got == 3).any(-1)).any())


def test_packed_and_fused_selectors_return_the_ranking_value():
    """With want_values, the packed bf16 selector (max_id) and the fused
    conv + select return, for each id, the very score that ranked it (the
    merge compares them across slices)."""
    gen = torch.Generator().manual_seed(4)
    scores = torch.randn(64, 128, generator=gen).to(torch.bfloat16)
    ids = torch.arange(1000, 1128, dtype=torch.int32)
    idx, val = score_topk(scores, ids, top_k=5, want_values=True,
                          selector="packed", max_id=2 ** 16 - 1)
    picked = scores.float().gather(1, (idx - 1000).long())
    assert torch.equal(val, picked)
    features = torch.randn(1, 6, 8, 16, generator=gen).to(torch.bfloat16)
    folded = torch.randn(128, 16, 3, 3, generator=gen).to(torch.bfloat16)
    idx, val = conv_score_topk(features, fold_to_rows(folded), ids, top_k=4,
                               want_values=True)
    conv = torch.nn.functional.conv2d(features.float().permute(0, 3, 1, 2),
                                      folded.float(), padding=1)
    conv = conv.to(torch.bfloat16).float().permute(0, 2, 3, 1).reshape(
        -1, 128)
    assert torch.equal(val, conv.gather(1, (idx - 1000).long()))


def _serve_args(tmp_path, **kw):
    base = dict(checkpoint_path=str(tmp_path / "m.pth"),
                labels_path=str(tmp_path / "labels.csv"), batch_size=4,
                height=H, width=H, top_k=K, embedding_dim=D,
                unet_architecture="resnet", bf16=False, predict_path="auto",
                device="cpu", clip_checkpoint_path=None,
                clip_vocab_path=None, clip_merges_path=None,
                data_parallel=True, model_parallel=2)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def served(models, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    save_reference_pth(models[2], str(tmp / "m.pth"))
    with open(tmp / "labels.csv", "w") as f:
        # 1-based on disk; the loader puts the background class at 0
        f.write("label,index\n" + "".join(f"class {i},{i}\n"
                                          for i in range(1, C)))
    return tmp


def test_serve_sharded_route_matches_single_device(models, served):
    """--data_parallel --model_parallel 2 over [cpu] * 4 (a 2 x 2 grid):
    the engine's labels equal the single-device engine's."""
    overrides = {"encoder_filters": FILTERS}
    sharded, _, labels, _ = serve.build_engine(
        _serve_args(served), overrides, devices=[CPU] * 4)
    single, _, _, _ = serve.build_engine(
        _serve_args(served, data_parallel=False), overrides)
    batch = models[3]
    assert len(labels) == C
    assert torch.equal(sharded(batch), single(batch))


@pytest.mark.parametrize("kw,message", [
    (dict(model_parallel=5), "--model_parallel 5 exceeds the device count 4"),
    (dict(batch_size=3), "--batch_size 3 must divide by the data-parallel "
                         "degree 2"),
])
def test_serve_sharded_route_refuses(served, kw, message):
    with pytest.raises(SystemExit, match=message):
        serve.build_engine(_serve_args(served, **kw),
                           {"encoder_filters": FILTERS}, devices=[CPU] * 4)


def test_make_mesh_layout_and_refusals():
    """Row-major cells as JAX lays its mesh out, a repeated device counted
    once; JAX's assertion text for a grid that does not fit; a 'spatial'
    axis refused, naming ROADMAP item 10b; torchrun's flags without a
    coordinator refused with JAX's assertion text."""
    from rangeclip_tpu_torch.parallel import init_distributed

    mesh = make_mesh(2, 2, [CPU] * 5)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.distinct_devices() == [CPU]
    assert make_mesh(n_model=2, devices=[CPU] * 5).shape["data"] == 2
    with pytest.raises(AssertionError, match="mesh data=3 x spatial=1 x "
                       "model=2 does not fit 4 devices"):
        make_mesh(3, 2, [CPU] * 4)
    with pytest.raises(NotImplementedError, match="ROADMAP item 10b"):
        make_mesh(1, 1, [CPU] * 4, n_spatial=2)
    with pytest.raises(AssertionError, match="have no effect without "
                       "--coordinator_address"):
        init_distributed(num_processes=2, device="cpu")
