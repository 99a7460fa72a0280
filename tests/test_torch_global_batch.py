"""The port's global-batch step (JAX's default over a mesh) over 2 and 4
gloo ranks on the CPU, each rank holding its block of an 8-row batch.

Held against JAX's single-device ``make_train_step`` on the whole batch
(JAX's own tests show that its global step equals its single-device step,
``tests/test_parallel.py:77``): the same weights (carried by the JAX
package's reference-checkpoint converter), the draws of ``fold_in(key, i)``
for the whole batch, SGD as JAX's tests take it, at the tolerances of the
``ddp_parity`` comparison (``test_torch_ddp.py``).  The ranks end
bit-equal, and 2 and 4 ranks agree with the port's single-device step.

The same rank processes also hold sync-BatchNorm in f64 against
``BatchNorm2d`` on the whole batch, each ``parallel/kernel_shard`` function
against its single call, and sharded ``validate_model`` over 2 ranks
against single-device validation of the same global batches."""

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
from rangeclip_tpu_torch.data.labels import (
    build_equivalence_class_map,
    build_equivalence_tensor,
)
from rangeclip_tpu_torch.evals.validate import validate_model
from rangeclip_tpu_torch.losses.hybrid import Draws, HybridLossConfig
from rangeclip_tpu_torch.losses.infonce import build_contrast_mask, n_draws
from rangeclip_tpu_torch.losses.pooling import masked_average_pooling
from rangeclip_tpu_torch.models.clip.provider import HashImageEmbedder
from rangeclip_tpu_torch.models.depth_unet import (
    DepthUNet,
    DepthUNetConfig,
    build_candidate_mask,
)
from rangeclip_tpu_torch.models.interop import state_dict_from_jax
from rangeclip_tpu_torch.ops.blocks import BatchNorm2d
from rangeclip_tpu_torch.ops.kernels.class_presence import class_presence
from rangeclip_tpu_torch.ops.kernels.histogram import histogram
from rangeclip_tpu_torch.ops.kernels.masked_pooling import (
    fused_masked_pooling,
)
from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import fused_pixel_text_ce
from rangeclip_tpu_torch.ops.kernels.tv_rowtile import tv_rowtile
from rangeclip_tpu_torch.training.state import TrainState
from rangeclip_tpu_torch.training.train_step import make_train_step
from rangeclip_tpu_torch.utils.math import l2_normalize
from torch_dist_worker import join_ranks, start_ranks

FILTERS = (8, 16, 16, 16, 32)
A, G, H, C, D = 2, 8, 32, 24, 32  # G global rows, split over the ranks
LR = 1e-3
VAL_BATCHES = 2
t = torch.from_numpy


def _inputs():
    """The global batch (test_torch_ddp.py's shapes; row b's labels in
    [b, b + 5), so that no rank's rows hold every label of the batch),
    table, matrices, initial weights and the draws of JAX's single-device
    step for it."""
    rng = np.random.default_rng(3)
    seg = (rng.integers(0, 5, (A, G, H, H))
           + np.arange(G)[None, :, None, None]).astype(np.int32)
    batch = {
        "depth": rng.standard_normal((A, G, H, H, 1)).astype(np.float32),
        "segmentation": seg,
        "object_label": seg[:, :, 5, 5].copy(),
        "image_embeddings": rng.standard_normal((A, G, D)).astype(np.float32),
        "sample_valid": np.array([[1] * 8, [1, 0, 1, 1, 1, 1, 0, 1]],
                                 np.float32),
    }
    tables = {"text": rng.standard_normal((C, D)).astype(np.float32),
              "medium": rng.random((C, C)) < 0.15,
              "hard": rng.random((C, C)) < 0.15}
    port = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                     embedding_dim=D),
                     generator=torch.Generator().manual_seed(5))
    init = {k: v.clone() for k, v in port.state_dict().items()}
    key = jax.random.key(7)
    draws = {}
    for i in range(A):
        key_pix, key_contrast = jax.random.split(jax.random.fold_in(key, i))
        draws[f"pixels.{i}"] = np.array(jax.random.randint(
            key_pix, (G, n_draws(H, H)), 0, H * H), np.int32)
        for j, k in enumerate(jax.random.split(key_contrast)):
            draws[f"gumbel{j}.{i}"] = np.array(jax.random.gumbel(k, (C,)),
                                               np.float32)
    return batch, tables, port, init, key, draws


def _side_inputs():
    """The inputs of the sync-BatchNorm, kernel_shard and validation cases
    (numpy, seeded): each rank takes its block of every global array."""
    rng = np.random.default_rng(11)
    field = rng.standard_normal((G, 8, 8, 16)).astype(np.float32)
    seg = rng.integers(-1, 10, (G, 8, 8)).astype(np.int32)
    ks = {
        "samples": rng.standard_normal((G * 16, D)).astype(np.float32),
        "labels": rng.integers(0, 6, (G * 16,)).astype(np.int32),
        "valid": rng.integers(0, 3, (G * 16,)).astype(np.float32),
        "table": rng.standard_normal((C, D)).astype(np.float32),
        "mask": np.arange(C) < 9,
        "temperature": np.float32(0.07),
        "field": field, "seg": seg,
        "weight": np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32),
        "objects": np.array([0, 3, 3, 7, 11], np.int32),
        "idx": rng.integers(0, 40, (G, 50)).astype(np.int32),
        "bins": np.int32(64), "classes": np.int32(10),
        # row b's labels are 2b and 2b + 1: each rank holds its own
        "cseg": (2 * np.arange(G)[:, None, None]
                 + rng.integers(0, 2, (G, 4, 4))).astype(np.int32),
        "gumbel0": rng.gumbel(size=C).astype(np.float32),
        "gumbel1": rng.gumbel(size=C).astype(np.float32),
    }
    bn = {"x": rng.standard_normal((G, 6, 5, 4)) * 3 + 1,
          "w": rng.standard_normal((G, 6, 5, 4)),
          "weight": rng.random(6) + 0.5, "bias": rng.standard_normal(6)}
    vseg = rng.integers(0, 12, (VAL_BATCHES, G, H, H)).astype(np.int32)
    val = {
        "depth": rng.standard_normal((VAL_BATCHES, G, H, H, 1)
                                     ).astype(np.float32),
        "segmentation": vseg,
        "object_label": vseg[:, :, 9, 9].copy(),
        "sample_valid": np.array([[1] * 8, [1, 1, 1, 0, 1, 1, 1, 0]],
                                 np.float32),
        "image": rng.random((VAL_BATCHES, G, H, H, 3)).astype(np.float32),
        "object_bbox": np.tile(np.array([2, 3, 26, 30], np.int32),
                               (VAL_BATCHES, G, 1)),
    }
    eq = {i: [i, (i + 1) % C] for i in range(0, C, 3)}
    tensor = build_equivalence_tensor(eq, C)
    val["eq"] = tensor
    val["cmap"] = build_equivalence_class_map(tensor)
    return ks, bn, val


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """{world: rank outputs} for 2 and 4 ranks, started together, while
    JAX's single-device step runs here; and JAX's state and info, the
    port's initial weights and the inputs."""
    tmp = tmp_path_factory.mktemp("global")
    batch, tables, port, init, key, draws = _inputs()
    ks, bn, val = _side_inputs()
    common = {**batch, **tables, **draws, "lr": np.float32(LR),
              "filters": np.array(FILTERS), "dim": np.int32(D),
              **{f"sd.{k}": v.numpy() for k, v in init.items()},
              **{f"ks.{k}": v for k, v in ks.items()},
              **{f"bn.{k}": v for k, v in bn.items()}}
    started = {}
    for world in (2, 4):
        inputs = dict(common)
        if world == 2:
            inputs.update({f"val.{k}": v for k, v in val.items()})
        root = tmp / f"w{world}"
        root.mkdir()
        np.savez(root / "inputs.npz", **inputs)
        started[world] = start_ranks("global", world, root,
                                     root / "inputs.npz")

    params, stats = convert_reference_checkpoint(
        *({k: v.detach().numpy() for k, v in m.state_dict().items()}
          for m in (port.encoder, port.decoder)),
        port.log_temperature_text.detach().numpy(),
        port.log_temperature_image.detach().numpy())
    opt = optax.sgd(1.0)
    model = JaxDepthUNet(JaxConfig(encoder_filters=FILTERS, embedding_dim=D,
                                   use_batch_norm=True))
    step = jax_step(model, opt, JaxLossConfig(), accum_steps=A, donate=False)
    jstate, jinfo = step(
        JaxTrainState(step=jnp.int32(0), params=params, batch_stats=stats,
                      opt_state=opt.init(params)),
        {k: jnp.asarray(v) for k, v in batch.items()}, key,
        jnp.float32(LR), jnp.float32(0.25), jnp.float32(0.5),
        jnp.asarray(tables["text"]), jnp.asarray(tables["medium"]),
        jnp.asarray(tables["hard"]))
    ranks = {world: [torch.load(p) for p in join_ranks(*started[world])]
             for world in started}
    return {"ranks": ranks, "jax": (jax.device_get(jstate),
                                    jax.device_get(jinfo)),
            "init": init, "inputs": (batch, tables, draws, ks, bn, val)}


def port_single_step(run, group=None):
    """The port's single-device step on the whole batch (or the step over
    ``group``), from the run's weights and draws."""
    batch, tables, draws, *_ = run["inputs"]
    model = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                      embedding_dim=D))
    model.load_state_dict(run["init"])
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    step = make_train_step(HybridLossConfig(), A, group=group)
    state, info = step(
        state, {k: t(v) for k, v in batch.items()}, (0, 0), LR, 0.25, 0.5,
        t(tables["text"]), t(tables["medium"]), t(tables["hard"]),
        draws=[Draws(t(draws[f"pixels.{i}"]),
                     (t(draws[f"gumbel0.{i}"]), t(draws[f"gumbel1.{i}"])))
               for i in range(A)])
    return {"state": model.state_dict(),
            "grads": {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None},
            "info": {k: float(v) for k, v in info.items()}}


def assert_step_close(got, want, init):
    """Loss within rtol 2e-5, parameters within rtol 5e-4 / atol 5e-6,
    BatchNorm running statistics within rtol 5e-4 / atol 5e-7 (``want`` a
    port state dict); most parameters with a gradient moved."""
    np.testing.assert_allclose(got["info"]["total_loss"],
                               want["info"]["total_loss"], rtol=2e-5)
    checked = moved = 0
    for name, w in want["state"].items():
        if name.endswith("num_batches_tracked"):
            assert int(got["state"][name]) == A
            continue
        if "running_" in name:
            np.testing.assert_allclose(got["state"][name].numpy(), w.numpy(),
                                       rtol=5e-4, atol=5e-7, err_msg=name)
            continue
        if name not in got["grads"]:
            continue  # an identity block's projection: absent in JAX
        np.testing.assert_allclose(got["state"][name].numpy(), w.numpy(),
                                   rtol=5e-4, atol=5e-6, err_msg=name)
        moved += not torch.equal(got["state"][name], init[name])
        checked += 1
    assert checked > 50 and moved > checked // 2, (moved, checked)


@pytest.mark.parametrize("world", [2, 4])
def test_global_step_matches_jax_single_device(run, world):
    """Each world's rank 0 against JAX's single-device step on the 8-row
    batch (2 and 4 rows a rank)."""
    jstate, jinfo = run["jax"]
    want = {"state": state_dict_from_jax(jstate.params, jstate.batch_stats),
            "info": {"total_loss": float(jinfo["total_loss"])}}
    assert_step_close(run["ranks"][world][0], want, run["init"])


@pytest.mark.parametrize("world", [2, 4])
def test_global_step_ranks_end_bit_equal(run, world):
    """Every rank holds rank 0's parameters, BatchNorm statistics,
    gradients and info after the step."""
    lead, *rest = run["ranks"][world]
    for res in rest:
        for part in ("state", "grads"):
            assert sorted(res[part]) == sorted(lead[part])
            for name, v in lead[part].items():
                assert torch.equal(res[part][name], v), (part, name)
        assert res["info"] == lead["info"]


def test_global_step_layout_invariance(run):
    """1, 2 and 4 ranks agree: each world against the port's single-device
    step on the whole batch, and 2 ranks against 4, at the JAX
    tolerances; the info's loss terms agree to rtol 2e-5."""
    single = port_single_step(run)
    two, four = run["ranks"][2][0], run["ranks"][4][0]
    for got in (two, four):
        assert_step_close(got, single, run["init"])
        for k in ("text_contrastive_loss", "image_contrastive_loss",
                  "smoothness_loss", "temperature_text"):
            np.testing.assert_allclose(got["info"][k], single["info"][k],
                                       rtol=2e-5, err_msg=k)
    assert_step_close(four, two, run["init"])


@pytest.mark.parametrize("world", [2, 4])
def test_sync_batch_norm_matches_batch_norm_f64(run, world):
    """Sync-BatchNorm in f64 on each rank's rows against BatchNorm2d on
    the whole batch: outputs and input gradients per rank, the weight and
    bias gradients summed over the ranks, and the running statistics
    (biased variance) on every rank."""
    _, _, _, _, bn, _ = run["inputs"]
    x = t(bn["x"]).requires_grad_(True)
    ref = BatchNorm2d(6, momentum=0.1).double()
    with torch.no_grad():
        ref.weight.copy_(t(bn["weight"]))
        ref.bias.copy_(t(bn["bias"]))
    y = ref(x)
    (y * t(bn["w"])).sum().backward()
    per = G // world
    ranks = [r["bn"] for r in run["ranks"][world]]
    for r, got in enumerate(ranks):
        rows = slice(r * per, (r + 1) * per)
        np.testing.assert_allclose(got["y"], y[rows].detach(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got["dx"], x.grad[rows], rtol=1e-10,
                                   atol=1e-12)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-12)
    np.testing.assert_allclose(sum(g["dweight"] for g in ranks),
                               ref.weight.grad, rtol=1e-10)
    np.testing.assert_allclose(sum(g["dbias"] for g in ranks),
                               ref.bias.grad, rtol=1e-10)


@pytest.mark.parametrize("world", [2, 4])
def test_kernel_shard_matches_single_calls(run, world):
    """Each kernel_shard function on the ranks' rows against its single
    call on the whole batch: CE partial sums adding up (rtol 1e-5) over the
    global valid count (exact), presence (OR'd), per-image histograms and
    L2-normalised rows (equal), TV shares adding up (rtol 1e-5), masked
    pooling's sums (rtol 1e-5) and counts (exact), and
    masked_average_pooling's means (rtol 1e-5); the contrast and
    candidate masks over rows whose labels differ by rank, equal to the
    whole batch's."""
    ks = {k: t(np.asarray(v)) for k, v in run["inputs"][3].items()}
    tables = run["inputs"][1]
    contrast = build_contrast_mask(
        ks["cseg"], torch.ones(ks["cseg"].shape), C, t(tables["medium"]),
        t(tables["hard"]), 3, 0.25, 0.5, (ks["gumbel0"], ks["gumbel1"]))
    candidate = build_candidate_mask(ks["cseg"], C, 3, ks["gumbel0"])
    assert int(contrast.sum()) == 2 * G + 3
    ranks = [r["kernel_shard"] for r in run["ranks"][world]]
    want_ce = fused_pixel_text_ce(ks["samples"], ks["temperature"],
                                  ks["labels"], ks["valid"], ks["table"],
                                  ks["mask"])
    np.testing.assert_allclose(float(sum(r["ce"] for r in ranks)),
                               float(want_ce), rtol=1e-5)
    presence = class_presence(ks["seg"].reshape(-1), ks["weight"][:, None,
                              None].expand(G, 8, 8).reshape(-1), 10)
    hist = histogram(ks["idx"], int(ks["bins"]))
    norm = l2_normalize(ks["field"], dim=-1)
    sums, counts = fused_masked_pooling(ks["field"].reshape(-1, 16),
                                        ks["seg"].reshape(-1), ks["objects"])
    pooled = masked_average_pooling(ks["field"], ks["seg"], ks["objects"])
    per = G // world
    for r, got in enumerate(ranks):
        rows = slice(r * per, (r + 1) * per)
        assert float(got["n_valid"]) == float(ks["valid"].sum())
        assert torch.equal(got["presence"], presence)
        assert torch.equal(got["contrast"], contrast)
        assert torch.equal(got["candidate"], candidate)
        assert torch.equal(got["histogram"], hist[rows])
        assert torch.equal(got["l2"], norm[rows])
        np.testing.assert_allclose(got["sums"], sums, rtol=1e-5, atol=1e-6)
        assert torch.equal(got["counts"], counts)
        np.testing.assert_allclose(got["pooled"], pooled, rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(
        float(sum(r["tv"] for r in ranks)),
        float(tv_rowtile(ks["field"], ks["weight"], 2)), rtol=1e-5)


def test_sharded_validation_matches_single_device(run):
    """validate_model over 2 ranks, each on its rows of two 8-row val
    batches (padded rows among them), against single-device validate_model
    over the whole batches: pixel accuracies and IoU-based metrics exactly,
    the losses within rtol 1e-5, the same results on both ranks."""
    _, tables, _, _, _, val = run["inputs"]
    model = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                      embedding_dim=D))
    model.load_state_dict(run["init"])
    keys = ("depth", "segmentation", "object_label", "sample_valid",
            "image", "object_bbox")
    want = validate_model(
        model, [{k: val[k][i] for k in keys} for i in range(VAL_BATCHES)],
        t(tables["text"]), t(tables["medium"]), t(tables["hard"]),
        t(val["eq"]), t(val["cmap"]), {"pct_medium": 0.25, "pct_hard": 0.5},
        HashImageEmbedder(dim=D), 3,
        {"step": -1, "loss": float("inf"), "mIoU_tk": -1.0}, num_negatives=5)
    got = [r["val"] for r in run["ranks"][2]]
    assert got[0] == got[1]
    assert got[0]["step"] == want["step"] == 3
    for k in ("mIoU_t1", "mIoU_tk", "pixel_accuracy_t1",
              "pixel_accuracy_tk"):
        assert got[0][k] == want[k], k
    for k in ("loss", "latest_val_loss", "avg_text_contrastive_loss",
              "avg_image_contrastive_loss", "avg_smoothness_loss"):
        np.testing.assert_allclose(got[0][k], want[k], rtol=1e-5, err_msg=k)
    assert want["avg_image_contrastive_loss"] > 0
