"""The port's robustness sweep and its CLIPSeg subject against the JAX
package's on the CPU.

The sweep runs the same numpy predictions on both sides (a predict_fn of
the enhanced image, so every brightness and saturation level moves the
rows), over batches one of which has no ground truth (the reference's
per-sample skip): every metric of every row within 1e-6.  The CLIPSeg
mapping is held on the same logits: labels equal, except where the two
resizes' scores are a near-tie (gap below 1e-5); and through an oracle
``logits_fn`` (``tests/test_baselines.py``'s) with and without
distractors.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.benchmark import clipseg as jax_clipseg
from rangeclip_tpu.benchmark import robustness as jax_robustness
from rangeclip_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from rangeclip_tpu_torch.benchmark import clipseg, robustness

C, B, H, W = 9, 3, 16, 16


def _batches():
    rng = np.random.default_rng(4)
    out = []
    for i in range(3):
        seg = rng.integers(0, C, (B, H, W)).astype(np.int32)
        if i == 1:
            seg[:] = 0  # no ground truth: the reference skips the items
        seg[2, :4] = 0
        out.append({"image": rng.random((B, H, W, 3)).astype(np.float32),
                    "segmentation": seg,
                    "sample_valid": np.array([1, 1, i != 2], np.float32)})
    return out


def _predict(image, seg):
    """[B, H, W, 3] ids from the enhanced image and the ground truth."""
    lum = image.mean(axis=-1)
    first = np.where(lum > 0.3, seg, (seg + 1) % C)
    cols = [first] + [(first + j) % C for j in (2, 5)]
    return np.stack(cols, axis=-1).astype(np.int32)


def _equivalence():
    eq = np.eye(C, dtype=bool)
    eq[2, 7] = eq[7, 2] = True
    ecm = np.arange(C, dtype=np.int32)
    ecm[7] = 2
    return eq, ecm


def test_enhancements_match_jax():
    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    for f in (0.0, 0.05, 0.5, 1.0, 1.7):
        np.testing.assert_array_equal(
            robustness.enhance_brightness(img, f),
            jax_robustness.enhance_brightness(img, f))
        np.testing.assert_array_equal(
            robustness.enhance_saturation(img, f),
            jax_robustness.enhance_saturation(img, f))


def test_sweep_rows_match_jax():
    batches = _batches()
    eq, ecm = _equivalence()
    levels = dict(brightness_levels=(1.0, 0.4, 0.1),
                  saturation_levels=(1.0, 0.3))
    ours = robustness.robustness_sweep(
        lambda: batches,
        lambda gen, batch, image: torch.from_numpy(
            _predict(image, batch["segmentation"])),
        eq, ecm, C, **levels)
    theirs = jax_robustness.robustness_sweep(
        lambda: batches,
        lambda rng, batch, image: jnp.asarray(
            _predict(image, batch["segmentation"])),
        eq, ecm, C, **levels)
    assert len(ours) == len(theirs) == 6
    assert len({(r["pixel_accuracy_t1"], r["mIoU_t1"]) for r in ours}) > 1
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-6,
                                       err_msg=key)
    assert robustness.format_results_table(ours) == \
        jax_robustness.format_results_table(theirs)


def test_sweep_skips_items_without_ground_truth():
    """A batch of items without ground truth moves no metric, whatever it
    predicts."""
    batches = _batches()
    eq, ecm = _equivalence()

    def predict(gen, batch, image):
        return torch.from_numpy(_predict(image, batch["segmentation"]))

    def wrong_on_empty(gen, batch, image):
        pred = predict(gen, batch, image)
        if not batch["segmentation"].any():
            pred = (pred + 3) % C
        return pred

    rows = [robustness.robustness_sweep(lambda: batches, fn, eq, ecm, C,
                                        brightness_levels=(0.5,))
            for fn in (predict, wrong_on_empty)]
    assert rows[0] == rows[1]


def test_batch_generators_are_keyed_by_seed_and_batch():
    seen = []
    batches = _batches()
    eq, ecm = _equivalence()

    def predict(gen, batch, image):
        seen.append(int(torch.randint(0, 2 ** 31 - 1, (), generator=gen)))
        return torch.from_numpy(_predict(image, batch["segmentation"]))

    robustness.robustness_sweep(lambda: batches, predict, eq, ecm, C,
                                brightness_levels=(1.0, 0.2))
    assert seen[:3] == seen[3:] and len(set(seen[:3])) == 3


@pytest.mark.parametrize("P,h,top_k", [(4, 8, 3), (2, 5, 5), (7, 16, 5)])
def test_clipseg_topk_matches_jax(P, h, top_k):
    """Labels equal JAX's except at near-ties of the resized scores (gap
    below 1e-5, both resizes' f32 interpolation)."""
    rng = np.random.default_rng(P)
    logits = rng.standard_normal((P, h, h)).astype(np.float32)
    gidx = rng.permutation(50)[:P].tolist()
    got = clipseg.clipseg_topk_from_logits(logits, gidx, (H, W), top_k)
    want = np.asarray(jax_clipseg.clipseg_topk_from_logits(
        logits, gidx, (H, W), top_k))
    assert got.shape == (H, W, top_k) and got.dtype == torch.int32
    differ = got.numpy() != want
    if differ.any():
        scores = np.asarray(jax_resize_bilinear(
            jnp.moveaxis(jnp.asarray(logits), 0, -1)[None], (H, W)))[0]
        pos = {g: i for i, g in enumerate(gidx)}
        a = np.vectorize(pos.get)(got.numpy())
        b = np.vectorize(pos.get)(want)
        gaps = np.abs(np.take_along_axis(scores, a, -1)
                      - np.take_along_axis(scores, b, -1))[differ]
        assert gaps.max() < 1e-5, gaps.max()


@pytest.mark.parametrize("distractors", [0, 3])
def test_clipseg_predict_fn_matches_jax_with_an_oracle(distractors):
    """An oracle logits_fn (the GT prompt +5 at the GT pixels at half
    resolution, -5 elsewhere): without distractors every column equals
    JAX's; with them (drawn from different streams) the top-1 column does,
    and both reconstruct the blocky ground truth."""
    labels = [f"class_{i}" for i in range(C)]
    index = {n: i for i, n in enumerate(labels)}
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, C, (B, H // 4, W // 4)).astype(np.int32)
    seg = np.kron(blocks, np.ones((4, 4), np.int32))
    seg[1] = 0
    batch = {"segmentation": seg,
             "image": rng.random((B, H, W, 3)).astype(np.float32)}

    def oracle(calls):
        def logits_fn(prompts, image_hwc):
            small = seg[calls[0]][::2, ::2]
            calls[0] += 1 + (calls[0] == 0)  # item 1 has no GT: skipped
            out = np.full((len(prompts), H // 2, W // 2), -5.0, np.float32)
            for p, name in enumerate(prompts):
                out[p][small == index[name]] = 5.0
            return out
        return logits_fn

    ours = clipseg.make_clipseg_predict_fn(
        oracle([0]), labels, num_distractors=distractors, top_k=3)(
            torch.Generator().manual_seed(0), batch, batch["image"])
    theirs = np.asarray(jax_clipseg.make_clipseg_predict_fn(
        oracle([0]), labels, num_distractors=distractors, top_k=3)(
            jax.random.key(0), batch, batch["image"]))
    assert ours.shape == (B, H, W, 3)
    cols = slice(None) if distractors == 0 else slice(0, 1)
    np.testing.assert_array_equal(ours.numpy()[..., cols], theirs[..., cols])
    assert (ours.numpy()[1] == 0).all()
    has = seg != 0
    assert (ours.numpy()[..., 0][has] == seg[has]).mean() > 0.8


def test_plot_results_names_a_missing_matplotlib(monkeypatch, tmp_path):
    rows = [{"brightness": 1.0, "saturation": 1.0, "pixel_accuracy_t1": 0.5,
             "pixel_accuracy_tk": 0.6, "mIoU_t1": 0.3, "mIoU_tk": 0.4}]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        robustness.plot_results(rows, str(tmp_path / "p.png"))
