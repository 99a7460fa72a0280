"""Validation over a ``data x spatial x model`` grid (JAX's
``validate_model(mesh=...)`` on a mesh with a 'spatial' axis, whose
``shard_batch`` shards H: ``rangeclip_tpu/evals/validate.py:136-205``,
``rangeclip_tpu/parallel/mesh.py:92-118``) against JAX's single-device
``make_val_step`` on the CPU, for the ResNet UNet and the MiT, on the grids
(1, 2, 1) and (2, 2, 1).

Four gloo ranks (``tests/torch_dist_worker.py``, mode ``grid_validate``),
one spawn for the file.  Each rank takes its data block's images of two
4-image val batches at 32^2 and its spatial block of their rows, and runs
the grid's val step with JAX's candidate-mask noise and loss draws fed:
summed over the grid's ranks, its metric accumulators and loss shares are
JAX's single-device step's on the whole batch (``test_torch_eval.py``'s
tolerances: top-k ids equal, accumulators within 1e-6, loss parts rtol
1e-4).  ``validate_model`` over the grid returns the same results on every
rank, and the port's single-device ``validate_model``'s on the same
batches (metrics within 1e-6, losses rtol 1e-4).  The models are
``test_torch_eval.py``'s ResNet (filters 8-32, BatchNorm) and
``test_torch_mit.py``'s MiT, D = 32, C = 24, 5 negatives, top-5; at 32^2
the deepest level has one row, which one of two spatial ranks does not
own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.evals.metrics import metrics_init as jax_init
from rangeclip_tpu.evals.validate import make_val_step as jax_val_step
from rangeclip_tpu.losses.hybrid import HybridLossConfig as JaxLossConfig
from rangeclip_tpu_torch.evals.validate import validate_model
from rangeclip_tpu_torch.models.clip.provider import HashImageEmbedder
from test_torch_eval import C, D, FILTERS, _jax_draws, _val_inputs
from test_torch_eval import _models as resnet_models
from test_torch_mit import CONFIGS
from test_torch_mit import _models as mit_models
from torch_dist_worker import join_ranks, start_ranks

B, H, TOP_K, NEGATIVES, N_VAL = 4, 32, 5, 5, 2
GRIDS = ((1, 2, 1), (2, 2, 1))
ARCHS = ("resnet", "mit")
CASES = [(arch, shape) for arch in ARCHS for shape in GRIDS]


def _models(arch):
    """(JAX model, params, batch_stats, the port model in eval mode)."""
    if arch == "resnet":
        port, model, params, stats = resnet_models()
        return model, params, stats, port
    model, v, port = mit_models("mit")
    return model, v["params"], v["batch_stats"], port


def _batches():
    """N_VAL val batches (numpy) and one set of tables, equivalences and
    image embeddings per batch."""
    batches, images = [], []
    for i in range(N_VAL):
        batch, text, medium, hard, eq, cmap, emb = _val_inputs(i, B, H)
        if i == 0:
            tables = (text, medium, hard, eq, cmap)
        rng = np.random.default_rng(40 + i)
        batch["image"] = rng.random((B, H, H, 3)).astype(np.float32)
        batch["object_bbox"] = np.tile(np.array([0, 0, 20, 20], np.int32),
                                       (B, 1))
        batches.append(batch)
        images.append(emb)
    return batches, tables, images


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's results; JAX's val step on each whole batch and the
    port's single-device validate_model (computed here while the ranks
    run)."""
    tmp = tmp_path_factory.mktemp("grid_validate")
    batches, (text, medium, hard, eq, cmap), images = _batches()
    keys = [jax.random.fold_in(jax.random.key(11), i) for i in range(N_VAL)]
    noise = [_jax_draws(k, B, H) for k in keys]
    shared = {"text": text, "medium": medium, "hard": hard, "eq": eq,
              "cmap": cmap, "top_k": np.int32(TOP_K),
              "negatives": np.int32(NEGATIVES), "dim": np.int32(D),
              "images": np.stack(images),
              "cand": np.stack([c.numpy() for c, _ in noise]),
              "pixels": np.stack([d.pixels.numpy() for _, d in noise]),
              "gumbel0": np.stack([d.gumbel[0].numpy() for _, d in noise]),
              "gumbel1": np.stack([d.gumbel[1].numpy() for _, d in noise]),
              **{k: np.stack([b[k] for b in batches]) for k in batches[0]}}
    arrays = {"archs": np.array(ARCHS), "grids": np.array(GRIDS)}
    for arch in ARCHS:
        port = _models(arch)[3]
        model_keys = {
            "unet_type": arch,
            "use_batch_norm": arch == "resnet",
            "filters": np.array(FILTERS if arch == "resnet"
                                else CONFIGS["mit"]["encoder_filters"])}
        for k, v in {**shared, **model_keys}.items():
            arrays[f"{arch}.{k}"] = v
        for k, v in port.state_dict().items():
            arrays[f"{arch}.sd.{k}"] = v.numpy()
    np.savez(tmp / "inputs.npz", **arrays)
    procs = start_ranks("grid_validate", 4, tmp, tmp / "inputs.npz",
                        threads=1)
    t = torch.from_numpy
    want = {}
    for arch in ARCHS:
        model, params, stats, port = _models(arch)
        step = jax_val_step(model, JaxLossConfig(), TOP_K, NEGATIVES)
        steps = []
        for i, batch in enumerate(batches):
            acc, parts, pred = step(
                params, stats,
                {k: jnp.asarray(batch[k]) for k in (
                    "depth", "segmentation", "object_label",
                    "sample_valid")},
                keys[i], jnp.float32(0.3), jnp.float32(0.5),
                jnp.asarray(text), jnp.asarray(medium), jnp.asarray(hard),
                jnp.asarray(eq), jnp.asarray(cmap), jnp.asarray(images[i]),
                jax_init(C))
            steps.append(jax.device_get((acc, parts, pred)))
        single = validate_model(
            port, batches, t(text), t(medium), t(hard), t(eq), t(cmap),
            {"pct_medium": 0.3, "pct_hard": 0.5}, HashImageEmbedder(dim=D),
            1, {"step": -1, "loss": float("inf"), "mIoU_tk": -1.0},
            top_k=TOP_K, num_negatives=NEGATIVES)
        want[arch] = {"steps": steps, "single": single}
    ranks = [torch.load(p) for p in join_ranks(*procs)]
    return ranks, want


def _members(ranks, arch, shape):
    n = int(np.prod(shape))
    key = (arch,) + shape
    assert all(key not in r for r in ranks[n:])
    return [r[key] for r in ranks[:n]]


@pytest.mark.parametrize("arch,shape", CASES)
def test_grid_val_step_matches_jax_single_device(run, arch, shape):
    """Each batch: the gathered top-k map equals JAX's, the grid's
    accumulators summed over its ranks are JAX's within 1e-6, and its loss
    shares summed are JAX's loss parts within rtol 1e-4."""
    ranks, want = run
    members = _members(ranks, arch, shape)
    for i, (acc_j, parts_j, pred_j) in enumerate(want[arch]["steps"]):
        got = [m["steps"][i] for m in members]
        for m in got:
            np.testing.assert_array_equal(m["pred"].numpy(),
                                          np.asarray(pred_j))
        for key, value in acc_j.items():
            total = sum(m["acc"][key].double() for m in got)
            if key == "gt_present":
                total = total > 0
            np.testing.assert_allclose(total.numpy(), np.asarray(value),
                                       atol=1e-6, err_msg=f"{key} batch {i}")
        parts = sum(m["parts"].double() for m in got)
        np.testing.assert_allclose(parts.numpy(), np.asarray(parts_j),
                                   rtol=1e-4, err_msg=f"batch {i}")
        assert float(parts[2]) > 0  # the area-image term ran


@pytest.mark.parametrize("arch,shape", CASES)
def test_grid_validate_model_same_on_every_rank(run, arch, shape):
    """validate_model over the grid: every rank's results are rank 0's,
    and the single-device pass's (metrics within 1e-6, losses rtol
    1e-4)."""
    ranks, want = run
    results = [m["results"] for m in _members(ranks, arch, shape)]
    for res in results[1:]:
        assert res == results[0]
    single = want[arch]["single"]
    assert sorted(results[0]) == sorted(single)
    for key, value in single.items():
        if "loss" in key:
            np.testing.assert_allclose(results[0][key], value, rtol=1e-4,
                                       err_msg=key)
        else:
            assert abs(results[0][key] - value) <= 1e-6, (
                key, results[0][key], value)
