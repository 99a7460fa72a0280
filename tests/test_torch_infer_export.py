"""The port's ``cli/infer`` and ``cli/export`` on the CPU, against the JAX
package, and the host helpers they use against the JAX functions they copy.

infer's labels are held against JAX ``DepthUNet.predict`` (XLA scoring) on
the same weights and PNGs: >= 99.9% agreement, every mismatch a near-tie of
the fp32 scores (<= 1e-5).  export's ``--verify`` must find the loaded
``.pt2`` bit-identical to the live function, and the artifact must equal
the port's own predict.
"""

import csv
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.data.labels import (
    load_candidate_labels as jax_load_candidate_labels,
)
from rangeclip_tpu.data.transforms import depth_transform as jax_depth_transform
from rangeclip_tpu.models.clip.provider import (
    HashTextEmbedder as JaxHashTextEmbedder,
)
from rangeclip_tpu.models.depth_unet import DepthUNet as JaxDepthUNet
from rangeclip_tpu.utils.visualization import (
    colorize_segmentation as jax_colorize_segmentation,
    label_colors as jax_label_colors,
)
from rangeclip_tpu_torch.cli import export, infer
from rangeclip_tpu_torch.cli.common import make_predict
from rangeclip_tpu_torch.data.dataset import open_gray
from rangeclip_tpu_torch.models.interop import save_reference_pth
from rangeclip_tpu_torch.utils.math import l2_normalize
from rangeclip_tpu_torch.utils.visualization import (
    colorize_segmentation,
    label_colors,
)
from test_torch_model import DIM, FILTERS, jax_and_port

SIZE = (32, 32)
WIDTHS = ["--encoder_filters", *map(str, FILTERS), "--embedding_dim",
          str(DIM)]


def _write_labels(path, n):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["label", "index"])
        for i in range(1, n + 1):
            writer.writerow([f"class {i}", i])
    return str(path)


def _write_depth_pngs(directory, n):
    from PIL import Image

    rng = np.random.default_rng(40)
    for i in range(n):
        shape = (48, 64) if i % 2 else (40, 40)
        depth = rng.integers(300, 9000, shape).astype(np.uint16)
        Image.fromarray(depth).save(os.path.join(directory, f"d{i:02d}.png"))
    return sorted(glob.glob(os.path.join(directory, "d*.png")))


def test_infer_matches_jax_predict(tmp_path, monkeypatch):
    """5 maps at batch 2 (a padded tail), --predict_path default: the
    files for every map, labels PNG = top-1, previews, and ids against JAX
    predict on the same decoded depth."""
    from PIL import Image

    monkeypatch.setenv("RANGECLIP_NATIVE", "off")  # the numpy transform
    model, v, port = jax_and_port()
    save_reference_pth(port, str(tmp_path / "m.pth"))
    labels_path = _write_labels(tmp_path / "labels.csv", 20)
    paths = _write_depth_pngs(tmp_path, 5)
    out = tmp_path / "out"
    n = infer.main(["--checkpoint_path", str(tmp_path / "m.pth"),
                    "--depth_glob", str(tmp_path / "d*.png"),
                    "--labels_path", labels_path, "--output_dir", str(out),
                    "--batch_size", "2", "--height", str(SIZE[0]),
                    "--width", str(SIZE[1]), "--top_k", "3",
                    "--predict_path", "default", "--save_preview",
                    "--device", "cpu", *WIDTHS])
    assert n == 5
    got = []
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0]
        topk = np.load(out / f"{name}_topk.npy")
        assert topk.shape == (*SIZE, 3) and topk.dtype == np.int32
        top1 = np.asarray(Image.open(out / f"{name}_labels.png"))
        np.testing.assert_array_equal(top1, topk[..., 0])
        assert (out / f"{name}_preview.png").exists()
        got.append(topk)
    got = np.stack(got)

    batch = np.stack([jax_depth_transform(
        np.asarray(Image.open(p).convert("I")).astype(np.float32), SIZE)
        for p in paths])[..., None]
    table = JaxHashTextEmbedder(dim=DIM)(jax_load_candidate_labels(
        labels_path))
    want = np.asarray(jax.jit(lambda v, x, t: model.apply(
        v, x, t, jnp.ones(len(t), bool), 3, method=JaxDepthUNet.predict,
        scoring="xla", return_embeddings=False)[0])(
            v, jnp.asarray(batch), jnp.asarray(table)))
    agree = got == want
    assert agree.mean() >= 0.999, agree.mean()
    if not agree.all():  # near-ties only
        field = port(torch.from_numpy(batch))[0].detach()
        logits = torch.einsum("bhwd,cd->bhwc", field,
                              l2_normalize(torch.from_numpy(table))).numpy()
        g = np.take_along_axis(logits, got, -1)
        w = np.take_along_axis(logits, want, -1)
        np.testing.assert_allclose(g[~agree], w[~agree], atol=1e-5)


def test_infer_refuses_clip_towers(tmp_path):
    """The three --clip_* flags build the CLIP text tower from their files:
    absent files are refused before any model loads."""
    with pytest.raises(FileNotFoundError, match="clip.safetensors"):
        infer.main(["--checkpoint_path", "absent.pth", "--depth_glob", "x",
                    "--labels_path", _write_labels(tmp_path / "l.csv", 3),
                    "--output_dir", str(tmp_path), "--device", "cpu",
                    "--clip_checkpoint_path", "clip.safetensors",
                    "--clip_vocab_path", "vocab.json",
                    "--clip_merges_path", "merges.txt"])


@pytest.mark.parametrize("predict_path,text_as_input",
                         [("default", True), ("default", False),
                          ("folded", False)])
def test_export_verify_and_reload(tmp_path, predict_path, text_as_input):
    """--portable --verify on the CPU: bit-identical, no custom operator in
    the program, and the reloaded artifact equals the port's predict."""
    _, _, port = jax_and_port()
    save_reference_pth(port, str(tmp_path / "m.pth"))
    labels_path = _write_labels(tmp_path / "labels.csv", 12)
    output = str(tmp_path / "model.pt2")
    argv = ["--checkpoint_path", str(tmp_path / "m.pth"),
            "--labels_path", labels_path, "--output", output,
            "--batch_size", "2", "--height", str(SIZE[0]),
            "--width", str(SIZE[1]), "--top_k", "3",
            "--predict_path", predict_path, "--portable", "--verify",
            *WIDTHS] + (["--text_as_input"] if text_as_input else [])
    sidecar = export.main(argv)
    with open(output + ".json") as f:
        assert json.load(f) == sidecar
    assert sidecar["predict_path"] == predict_path
    assert sidecar["device"] == "cpu" and sidecar["portable"]
    assert sidecar["inputs"][0]["shape"] == [2, *SIZE, 1]
    assert len(sidecar["inputs"]) == (2 if text_as_input else 1)

    program = torch.export.load(output)
    assert not [n for n in program.graph.nodes
                if "rangeclip" in str(n.target)]
    depth = torch.randn(2, *SIZE, 1, generator=torch.Generator().manual_seed(3))
    table = torch.from_numpy(JaxHashTextEmbedder(dim=DIM)(
        jax_load_candidate_labels(labels_path)))
    with torch.no_grad():
        got = program.module()(depth, *([table] if text_as_input else []))
    want = make_predict(port, 3, predict_path == "folded")(depth, table)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_export_requires_a_table(tmp_path):
    with pytest.raises(SystemExit):
        export.main(["--init_random", "--num_classes", "5", "--output",
                     str(tmp_path / "m.pt2")])


def test_host_copies_match_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(41)
    depth = rng.integers(0, 65535, (9, 13)).astype(np.uint16)
    Image.fromarray(depth).save(tmp_path / "d.png")
    got = open_gray(str(tmp_path / "d.png"))
    np.testing.assert_array_equal(got, depth.astype(np.int32))
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(tmp_path / "d.png").convert("I")))
    for num_classes in (1, 13, 1000):
        np.testing.assert_array_equal(label_colors(num_classes),
                                      jax_label_colors(num_classes))
    colors = label_colors(13)
    seg = rng.integers(-2, 16, (5, 7))
    np.testing.assert_array_equal(colorize_segmentation(seg, colors),
                                  jax_colorize_segmentation(seg, colors))
