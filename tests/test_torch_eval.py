"""The port's evaluation layer against the JAX package on the CPU: the
metrics (equivalences, pixel weights, -1 ids), one validation step with
JAX's draws injected, ``validate_model``'s mode handling, the baselines,
the prediction grids and ``cli/validate`` on a synthetic 32x32 dataset.
Inputs are made from numpy seeds; the model is narrow (filters
8 16 16 16 32, D = 32) with its weights carried to JAX."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.evals import baselines as jax_baselines
from rangeclip_tpu.evals.metrics import metrics_finalize as jax_finalize
from rangeclip_tpu.evals.metrics import metrics_init as jax_init
from rangeclip_tpu.evals.metrics import metrics_update as jax_update
from rangeclip_tpu.evals.validate import make_val_step as jax_val_step
from rangeclip_tpu.losses.hybrid import HybridLossConfig as JaxLossConfig
from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.models.depth_unet import DepthUNetConfig as JaxConfig
from rangeclip_tpu.models.torch_interop import convert_reference_checkpoint
from rangeclip_tpu.utils import visualization as jax_visualization
from rangeclip_tpu_torch.cli import validate as validate_cli
from rangeclip_tpu_torch.data import labels, synthetic
from rangeclip_tpu_torch.evals import baselines
from rangeclip_tpu_torch.evals.metrics import (
    metrics_finalize,
    metrics_init,
    metrics_update,
)
from rangeclip_tpu_torch.evals.validate import make_val_step, validate_model
from rangeclip_tpu_torch.losses.hybrid import Draws
from rangeclip_tpu_torch.losses.infonce import n_draws
from rangeclip_tpu_torch.models.depth_unet import (
    DepthUNet,
    DepthUNetConfig,
    build_candidate_mask,
)
from rangeclip_tpu_torch.models.interop import save_reference_pth
from rangeclip_tpu_torch.utils import visualization

t = torch.from_numpy
FILTERS = (8, 16, 16, 16, 32)
C, D = 24, 32


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


def _equivalences(rng, num_classes):
    """A symmetric equivalence tensor with a few merged classes, and its
    class map (the label module's own builders)."""
    eq = {i: {i} for i in range(num_classes)}
    for a, b in rng.choice(num_classes, (4, 2), replace=False):
        eq[int(a)].add(int(b))
        eq[int(b)].add(int(a))
    tensor = labels.build_equivalence_tensor(eq, num_classes)
    return tensor, labels.build_equivalence_class_map(tensor)


@pytest.mark.parametrize("weights", [None, "items", "pixels"])
def test_metrics_match_jax(weights):
    """Two accumulated batches, raw top-1 oracle quirk included, some -1
    ids (an exhausted candidate set), weights per item or per pixel: every
    accumulator within 1e-6 and every finalized metric within 1e-6."""
    rng = np.random.default_rng(3)
    B, H, W, k, nc = 2, 10, 12, 3, 15
    eq, cmap = _equivalences(rng, nc)
    acc_j, acc_p = jax_init(nc), metrics_init(nc)
    for _ in range(2):
        gt = rng.integers(0, nc, (B, H, W)).astype(np.int32)
        pred = rng.integers(0, nc, (B, H, W, k)).astype(np.int32)
        pred[..., 0] = np.where(rng.random((B, H, W)) < 0.4, gt,
                                pred[..., 0])
        pred[0, 0, :3, 2] = -1
        w = {None: None,
             "items": np.array([1.0, 0.0], np.float32),
             "pixels": (rng.random((B, H, W)) < 0.7).astype(np.float32)
             }[weights]
        acc_j = jax_update(acc_j, jnp.asarray(pred), jnp.asarray(gt),
                           jnp.asarray(eq), jnp.asarray(cmap),
                           None if w is None else jnp.asarray(w))
        acc_p = metrics_update(acc_p, t(pred), t(gt), t(eq), t(cmap),
                               None if w is None else t(w))
    for key, value in acc_j.items():
        np.testing.assert_allclose(acc_p[key].numpy(), np.asarray(value),
                                   atol=1e-6, err_msg=key)
    want, got = jax_finalize(acc_j), metrics_finalize(acc_p)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-6, (key, got[key], value)
    empty = metrics_finalize(metrics_init(4))
    assert empty == jax_finalize(jax_init(4))


@functools.lru_cache(maxsize=None)
def _models():
    port = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS, embedding_dim=D),
                     generator=torch.Generator().manual_seed(8)).eval()
    params, stats = convert_reference_checkpoint(
        *({k: v.detach().numpy() for k, v in m.state_dict().items()}
          for m in (port.encoder, port.decoder)),
        port.log_temperature_text.detach().numpy(),
        port.log_temperature_image.detach().numpy())
    model = JaxDepthUNet(JaxConfig(encoder_filters=FILTERS, embedding_dim=D,
                                   use_batch_norm=True))
    return port, model, params, stats


def _val_inputs(seed, B=3, H=32):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 8, (B, H, H)).astype(np.int32)
    batch = {"depth": rng.standard_normal((B, H, H, 1)).astype(np.float32),
             "segmentation": seg,
             "object_label": seg[:, 4, 4].copy(),
             "sample_valid": np.array([1.0] * (B - 1) + [0.0], np.float32)}
    text = rng.standard_normal((C, D)).astype(np.float32)
    medium = rng.random((C, C)) < 0.15
    hard = rng.random((C, C)) < 0.15
    eq, cmap = _equivalences(rng, C)
    images = rng.standard_normal((B, D)).astype(np.float32)
    return batch, text, medium, hard, eq, cmap, images


def _jax_draws(rng, B, H):
    """The candidate-mask noise and the loss's draws of JAX's val step:
    ``split(rng)`` into the mask and loss keys, then the loss's splits."""
    key_cand, key_loss = jax.random.split(rng)
    key_pix, key_contrast = jax.random.split(key_loss)
    pixels = jax.random.randint(key_pix, (B, n_draws(H, H)), 0, H * H)
    gumbel = tuple(t(np.array(jax.random.gumbel(k, (C,))))
                   for k in jax.random.split(key_contrast))
    return (t(np.array(jax.random.gumbel(key_cand, (C,)))),
            Draws(t(np.array(pixels, np.int32)), gumbel))


def test_val_step_matches_jax():
    """fp32, the same weights, batch and draws: top-k ids equal, every
    metric accumulator within 1e-6 and the four loss parts within rtol
    1e-4 (f32 sums through the UNet in another order).  The port's
    candidate mask from JAX's noise is JAX's mask."""
    port, model, params, stats = _models()
    batch, text, medium, hard, eq, cmap, images = _val_inputs(0)
    rng = jax.random.key(11)
    acc_j, parts_j, pred_j = jax_val_step(model, JaxLossConfig())(
        params, stats, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
        jnp.float32(0.3), jnp.float32(0.5), jnp.asarray(text),
        jnp.asarray(medium), jnp.asarray(hard), jnp.asarray(eq),
        jnp.asarray(cmap), jnp.asarray(images), jax_init(C))
    gumbel, draws = _jax_draws(rng, 3, 32)
    acc_p, parts_p, pred_p = make_val_step()(
        port, {k: t(v) for k, v in batch.items()}, (0, 0), 0.3, 0.5,
        t(text), t(medium), t(hard), t(eq), t(cmap), t(images),
        metrics_init(C), candidate_gumbel=gumbel, draws=draws)
    np.testing.assert_array_equal(pred_p.numpy(), np.asarray(pred_j))
    for key, value in acc_j.items():
        np.testing.assert_allclose(acc_p[key].numpy(), np.asarray(value),
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(parts_p.numpy(), np.asarray(parts_j),
                               rtol=1e-4)
    assert float(parts_p[2]) > 0  # the area-image term ran


def test_validate_model_keeps_the_model_and_its_statistics():
    """validate_model in eval mode: a model in train mode comes back in
    train mode with its BatchNorm statistics untouched; two runs with the
    same seed give identical results; best results key on top-k mIoU and
    always record the latest val loss."""
    port, _, _, _ = _models()
    model = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                      embedding_dim=D))
    model.load_state_dict(port.state_dict())
    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k or "num_batches" in k}
    batch, text, medium, hard, eq, cmap, _ = _val_inputs(1, B=2, H=32)
    rng = np.random.default_rng(2)
    batch["image"] = rng.random((2, 32, 32, 3)).astype(np.float32)
    batch["object_bbox"] = np.array([[0, 0, 16, 16], [4, 4, 30, 20]],
                                    np.int32)
    image_provider = lambda crops: crops.float().mean(  # noqa: E731
        dim=(1, 2, 3))[:, None].expand(-1, D)
    runs = []
    for _ in range(2):
        best = {"step": -1, "loss": float("inf"), "mIoU_tk": -1.0}
        runs.append(validate_model(
            model, [batch, batch], t(text), t(medium), t(hard), t(eq),
            t(cmap), {"pct_medium": 0.2, "pct_hard": 0.1}, image_provider,
            7, best))
    assert model.training
    for k, v in stats.items():
        assert torch.equal(model.state_dict()[k], v), k
    assert runs[0] == runs[1]
    assert runs[0]["step"] == 7
    assert runs[0]["latest_val_loss"] == runs[0]["loss"]
    best = validate_model(
        model, [batch], t(text), t(medium), t(hard), t(eq), t(cmap),
        {"pct_medium": 0.2, "pct_hard": 0.1}, image_provider, 9,
        {"step": 3, "loss": 1.0, "mIoU_tk": 2.0})
    assert best["step"] == 3 and best["latest_val_loss"] != 1.0


def _baseline_loader(seed, n_batches=2, B=2, H=8, W=8, nc=8):
    rng = np.random.default_rng(seed)
    return [{"depth": rng.standard_normal((B, H, W, 1)).astype(np.float32),
             "segmentation": rng.integers(1, nc, (B, H, W)).astype(np.int32),
             "sample_valid": np.array([1.0, 0.0][:B], np.float32)}
            for _ in range(n_batches)]


def test_majority_baseline_matches_jax():
    rng = np.random.default_rng(4)
    eq, cmap = _equivalences(rng, 8)
    loader = _baseline_loader(5)
    want = jax_baselines.evaluate_majority_model(loader, 3, eq, cmap, 8)
    got = baselines.evaluate_majority_model(loader, 3, eq, cmap, 8)
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-6, key
    pred = baselines.MajorityBaseline(5).predict(torch.zeros(2, 4, 6, 1), 3)
    assert pred.shape == (2, 4, 6, 3) and (pred == 5).all()


def test_random_baseline_draws_uniformly_within_the_candidate_set():
    """Every label lies in its item's candidate set (the item's GT labels
    plus at most num_negatives others) and the draw is uniform within it:
    each member's share of 40,000 draws within 5 sigma of 1 / n."""
    rng = np.random.default_rng(6)
    nc, negatives = 50, 7
    seg = t(rng.integers(0, 5, (2, 100, 100)).astype(np.int32))
    seg[1] += 20
    model = baselines.RandomWithNegativesBaseline(nc, negatives)
    gen = torch.Generator().manual_seed(0)
    pred = model.predict(seg, top_k=4, generator=gen)
    assert pred.shape == (2, 100, 100, 4) and pred.dtype == torch.int32
    for b in range(2):
        gt = set(seg[b].unique().tolist())
        drawn = pred[b].reshape(-1)
        members = set(drawn.unique().tolist())
        assert gt <= members and len(members - gt) <= negatives
        counts = torch.bincount(drawn.long(), minlength=nc)[sorted(members)]
        share = counts.double() / drawn.numel()
        n = len(members)
        sigma = np.sqrt((1 / n) * (1 - 1 / n) / drawn.numel())
        assert bool(((share - 1 / n).abs() <= 5 * sigma).all()), share
    again = model.predict(seg, top_k=4,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(pred, again)
    res = baselines.evaluate_random_model(_baseline_loader(7), 8,
                                          np.eye(8, dtype=bool), np.arange(8),
                                          num_negatives=8)
    assert 0.0 <= res["pixel_accuracy_t1"] <= 1.0


def test_prediction_grid_matches_jax():
    """The copied host helpers draw the same pixels as the JAX module."""
    rng = np.random.default_rng(9)
    depth = rng.random((24, 32, 1)).astype(np.float32)
    image = rng.random((24, 32, 3)).astype(np.float32)
    gt = rng.integers(0, 6, (24, 32))
    pred = rng.integers(-1, 6, (24, 32))
    names = [f"class {i}" for i in range(6)]
    for img in (image, None):
        np.testing.assert_array_equal(
            visualization.prediction_grid(depth, img, gt, pred, names),
            jax_visualization.prediction_grid(depth, img, gt, pred, names))
    np.testing.assert_array_equal(
        visualization.apply_colormap(depth[..., 0]),
        jax_visualization.apply_colormap(depth[..., 0]))


@pytest.fixture(scope="module")
def validate_workspace(tmp_path_factory):
    """A synthetic 32x32 dataset and two checkpoints of the narrow model
    (steps 3 and 12; the CLI reads the newest)."""
    root = tmp_path_factory.mktemp("validate")
    paths = synthetic.write_synthetic_dataset(str(root / "data"),
                                              n_samples=16, shape=(32, 32),
                                              num_classes=8)
    ckpt = root / "checkpoints"
    os.makedirs(ckpt)
    port, _, _, _ = _models()
    save_reference_pth(port, str(ckpt / "depth_segmentation_model-12.pth"),
                       train_step=12)
    other = DepthUNet(DepthUNetConfig(encoder_filters=FILTERS,
                                      embedding_dim=D))
    save_reference_pth(other, str(ckpt / "depth_segmentation_model-3.pth"),
                       train_step=3)
    return paths, str(ckpt)


def _validate_argv(paths, ckpt, *extra):
    return ["--labeled_metadata_path", paths["metadata"],
            "--labels_path", paths["labels"],
            "--equivalence_dict_path", paths["similarity"],
            "--checkpoint_dir", ckpt, "--batch_size", "2",
            "--n_height", "32", "--n_width", "32", *extra]


def test_cli_validate_on_synthetic_data(validate_workspace, capsys):
    """``--device cpu --baselines``: the newest checkpoint (step 12), the
    validation results of ``validate_model`` on that model, and both
    baselines; the architecture and widths come from the checkpoint, and an
    ``--embedding_dim`` or ``--unet_architecture`` that does not match it
    is refused; the default device is cuda; ``--clip_checkpoint_path
    random`` validates with the ViT-B/32 image tower (seeded random
    weights) in place of the hash stub."""
    paths, ckpt = validate_workspace
    out = validate_cli.main(_validate_argv(paths, ckpt, "--device", "cpu",
                                           "--baselines"))
    printed = capsys.readouterr().out
    assert out["step"] == 12 and "Validation results @ step 12" in printed
    assert "[Val] [Step 12] Top-k mIoU (equiv)" in printed
    assert "[Majority Baseline] mIoU" in printed
    assert "[Random Baseline] Pixel accuracy" in printed
    for key in ("mIoU_t1", "mIoU_tk", "pixel_accuracy_t1", "latest_val_loss"):
        assert np.isfinite(out["best"][key]), key
    assert 0.0 <= out["majority"]["pixel_accuracy_t1"] <= 1.0
    assert validate_cli.build_parser().parse_args(
        _validate_argv(paths, ckpt)).device == "cuda"
    with pytest.raises(ValueError, match="does not match"):
        validate_cli.main(_validate_argv(paths, ckpt, "--device", "cpu",
                                         "--embedding_dim", str(2 * D)))
    with pytest.raises(ValueError, match="does not match"):
        validate_cli.main(_validate_argv(paths, ckpt, "--device", "cpu",
                                         "--unet_architecture", "mit"))
    tower = validate_cli.main(_validate_argv(
        paths, ckpt, "--device", "cpu", "--clip_checkpoint_path", "random"))
    assert np.isfinite(tower["best"]["latest_val_loss"])
    assert tower["best"]["mIoU_tk"] == out["best"]["mIoU_tk"]


def test_candidate_mask_from_jax_noise_is_jax_mask():
    """build_candidate_mask with JAX's Gumbel draw gives JAX's mask (what
    lets the val-step test feed JAX's key to both sides)."""
    from rangeclip_tpu.models.depth_unet import (
        build_candidate_mask as jax_mask,
    )

    seg = np.random.default_rng(12).integers(0, 9, (2, 16, 16)).astype(
        np.int32)
    key = jax.random.key(4)
    want = np.asarray(jax_mask(key, jnp.asarray(seg), C, 6))
    got = build_candidate_mask(t(seg), C, 6, gumbel=t(np.array(
        jax.random.gumbel(key, (C,)))))
    np.testing.assert_array_equal(got.numpy(), want)
