"""``rangeclip_tpu_torch.cli.setup`` against ``rangeclip_tpu.cli.setup``:
every subcommand run through both CLIs on the same fixtures (those of the
JAX package's tests/test_setup_cli.py:13-52, plus NYUv2 .h5 scenes, a
labeled .mat in both storage formats and metadata CSVs with numeric and
empty cells), each into its own directory.  Written CSV and text files and
path lists must be identical text (output directory names aside) and PNGs
identical pixels, except for the one reference trait of
``combine-metadata``: the JAX package merges through pandas, which
re-types numeric cells (``1`` in an integer column holding an empty cell
is written ``1.0``, ``1.50`` as ``1.5``), where the port copies every cell
as read; those cells must still hold equal numbers.  The similarity sets
run with the hash stub at ``--embedding_dim 32`` and with a tiny CLIP text
tower converted from a ``.safetensors`` file on the CPU, whose embeddings
are within 1e-5 of JAX's: their sets agree except for pairs within 1e-5 of
a threshold."""

import csv
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from rangeclip_tpu.cli import setup as jax_setup
from rangeclip_tpu_torch.cli import setup as port_setup

THRESHOLDS = (0.9, 0.85, 0.8, 0.75)


@pytest.fixture()
def fixtures(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "void/image").mkdir(parents=True)
    (tmp_path / "void/depth").mkdir(parents=True)
    for i in range(4):
        Image.fromarray(
            rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
        ).save(tmp_path / f"void/image/{i:03d}.png")
        Image.fromarray(
            rng.integers(0, 5000, (16, 16)).astype(np.int32), mode="I"
        ).save(tmp_path / f"void/depth/{i:03d}.png")
    Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
        tmp_path / "void/image/unpaired.jpg")

    (tmp_path / "dets").mkdir()
    (tmp_path / "dets/img0.txt").write_text(
        "1 0.5 0.5 0.4 0.4 0.9\n2 0.52 0.52 0.4 0.4 0.8\n"
        "3 0.1 0.1 0.1 0.1 0.7\n")
    (tmp_path / "dets/img1.txt").write_text(
        "4 0.3 0.3 0.2 0.2 0.6\n4 0.31 0.3 0.2 0.2 0.65\nbad line\n")

    (tmp_path / "raw_labels.txt").write_text("Chair\nchair \nTable\nlamp\n")
    (tmp_path / "labelpngs").mkdir()
    for name, top in (("a", 5), ("b", 5)):
        Image.fromarray(rng.integers(0, top, (8, 8)).astype(np.int32),
                        mode="I").save(tmp_path / f"labelpngs/{name}.png")

    with open(tmp_path / "candidate_labels.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "label"])
        for i, name in enumerate(["chair", "table", "lamp", "sofa", "bed",
                                  "table lamp"], start=1):
            w.writerow([i, name])

    with open(tmp_path / "meta.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image", "depth", "object_id"])
        w.writeheader()
        for k in range(8):
            w.writerow({"image": f"i{k}.png", "depth": f"d{k}.png",
                        "object_id": str(1 if k < 5 else 2)})
    return tmp_path


def _run(fixtures, argv_of):
    """Run ``argv_of(out_dir)`` through the JAX CLI into <tmp>/jax and the
    port's into <tmp>/port; returns the two directories."""
    dirs = []
    for name, main in (("jax", jax_setup.main), ("port", port_setup.main)):
        out = fixtures / name
        out.mkdir()
        main(argv_of(out, name == "port"))
        dirs.append(out)
    return dirs


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_outputs(jax_dir, port_dir, min_files=1):
    """Identical trees: text equal once the directory names are swapped,
    PNGs equal in mode and pixels."""
    names = _files(jax_dir)
    assert names == _files(port_dir) and len(names) >= min_files, names
    for name in names:
        a, b = jax_dir / name, port_dir / name
        if name.endswith(".png"):
            with Image.open(a) as ia, Image.open(b) as ib:
                assert ia.mode == ib.mode and ia.size == ib.size, name
                np.testing.assert_array_equal(np.asarray(ib),
                                              np.asarray(ia), err_msg=name)
        else:
            want = a.read_text().replace(str(jax_dir), str(port_dir))
            assert b.read_text() == want, name


def test_similarity_sets_hash_stub(fixtures):
    def argv(out, port):
        return ["similarity-sets", "--labels_path",
                str(fixtures / "candidate_labels.csv"), "--output_csv",
                str(out / "sim.csv"), "--embedding_dim", "32",
                "--same_threshold", "0.2", "--hard_low", "0.0",
                "--hard_high", "0.1", "--medium_low", "-0.2",
                "--medium_high", "0.0"] + (["--device", "cpu"] if port
                                           else [])

    jax_dir, port_dir = _run(fixtures, argv)
    _same_outputs(jax_dir, port_dir)
    rows = list(csv.DictReader(open(port_dir / "sim.csv")))
    assert rows[0]["label"] == "unavailable" and len(rows) == 7
    assert any(r[k] != "[]" for r in rows for k in ("same", "medium",
                                                    "hard"))
    assert port_setup.build_parser().parse_args([
        "similarity-sets", "--labels_path", "l", "--output_csv",
        "o"]).device == "cuda"


def _tiny_clip(tmp_path):
    """A tiny CLIP checkpoint in HF's layout as .safetensors and a
    byte-level vocabulary; (paths, port config, JAX config)."""
    from rangeclip_tpu.models.clip.model import CLIPConfig as JaxConfig
    from rangeclip_tpu_torch.models.clip.convert import (
        hf_state_dict,
        write_safetensors,
    )
    from rangeclip_tpu_torch.models.clip.model import (
        CLIPConfig,
        CLIPTextTower,
        CLIPVisionTower,
    )
    from rangeclip_tpu_torch.models.clip.tokenizer import bytes_to_unicode

    symbols = list(bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>"
                                                   for s in symbols])}
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    vp, mp = str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")
    with open(vp, "w") as f:
        json.dump(vocab, f)
    with open(mp, "w") as f:
        f.write("#version: 0.2\n")
    kw = dict(vocab_size=len(vocab), max_position_embeddings=77,
              text_width=32, text_heads=4, text_layers=2, image_size=32,
              patch_size=8, vision_width=48, vision_heads=4,
              vision_layers=1, projection_dim=24)
    cfg = CLIPConfig(**kw)
    towers = (CLIPTextTower(cfg, generator=torch.Generator().manual_seed(1)),
              CLIPVisionTower(cfg,
                              generator=torch.Generator().manual_seed(2)))
    ckpt = write_safetensors(str(tmp_path / "clip.safetensors"), {
        k: v.numpy() for k, v in hf_state_dict(*towers).items()})
    return (ckpt, vp, mp), cfg, JaxConfig(**kw)


def _sets(path):
    with open(path) as f:
        return [{k: json.loads(r[k]) for k in ("same", "medium", "hard")}
                for r in csv.DictReader(f)]


def test_similarity_sets_tiny_tower_on_cpu(fixtures):
    from rangeclip_tpu.models.clip import provider as jax_provider
    from rangeclip_tpu.setup_tools.similarity_sets import (
        generate_label_similarity_sets as jax_generate,
    )
    from rangeclip_tpu_torch.data.labels import load_candidate_labels
    from rangeclip_tpu_torch.models.clip import provider
    from rangeclip_tpu_torch.setup_tools.similarity_sets import (
        generate_label_similarity_sets,
        label_similarity,
    )

    files, cfg, jax_cfg = _tiny_clip(fixtures)
    labels = load_candidate_labels(str(fixtures / "candidate_labels.csv"))
    ours = provider.get_text_provider(*files, config=cfg,
                                      device=torch.device("cpu"))
    theirs = jax_provider.get_text_provider(*files, config=jax_cfg)
    sim = label_similarity(labels, ours)
    np.testing.assert_allclose(sim, label_similarity(labels, theirs),
                               rtol=0, atol=1e-5)
    kw = dict(same_threshold=0.9, hard_range=(0.8, 0.85),
              medium_range=(0.75, 0.8))
    got = _sets(generate_label_similarity_sets(
        labels, ours, str(fixtures / "port.csv"), **kw))
    want = _sets(jax_generate(labels, theirs, str(fixtures / "jax.csv"),
                              **kw))
    near = {(i, j) for i, j in zip(*np.nonzero(
        np.min([np.abs(sim - t) for t in THRESHOLDS], axis=0) <= 1e-5))}
    for i, (g, w) in enumerate(zip(got, want)):
        for key in g:
            assert {j for j in set(g[key]) ^ set(w[key])
                    if (i, j) not in near} == set(), (i, key)
    assert len(got) == len(labels)
    assert any(row[key] for row in got for key in row)


def test_cleanup_labels_warns_and_matches(fixtures):
    Image.fromarray(np.array([[1, 9], [4, 2]], np.int32), mode="I").save(
        fixtures / "labelpngs/corrupt.png")

    def argv(out, _port):
        return ["cleanup-labels", "--raw_labels",
                str(fixtures / "raw_labels.txt"), "--label_png_glob",
                str(fixtures / "labelpngs/*.png"), "--output_dir",
                str(out / "clean"), "--labels_csv", str(out / "clean.csv"),
                "--frequency_csv", str(out / "freq.csv")]

    with pytest.warns(UserWarning, match="outside"):
        jax_dir, port_dir = _run(fixtures, argv)
    _same_outputs(jax_dir, port_dir, min_files=5)
    assert (port_dir / "clean.csv").read_text().splitlines() == [
        "label,index", "chair,1", "lamp,2", "table,3"]


def test_void_train_files(fixtures):
    def argv(out, _port):
        return ["void-train-files", "--image_dir",
                str(fixtures / "void/image"), "--depth_dir",
                str(fixtures / "void/depth"), "--image_list_out",
                str(out / "img.txt"), "--depth_list_out",
                str(out / "dep.txt")]

    jax_dir, port_dir = _run(fixtures, argv)
    _same_outputs(jax_dir, port_dir, min_files=2)
    assert len((port_dir / "img.txt").read_text().splitlines()) == 4


def _write_h5_scenes(root, n=2, H=48, W=40):
    import h5py

    rng = np.random.default_rng(5)
    for i in range(n):
        with h5py.File(root / f"scene{i}.h5", "w") as f:
            f["rgb"] = rng.integers(0, 256, (3, H, W)).astype(np.uint8)
            f["depth"] = rng.uniform(0.5, 9.0, (H, W)).astype(np.float32)


def test_nyu_crops(fixtures):
    _write_h5_scenes(fixtures)

    def argv(out, _port):
        return ["nyu-crops", "--h5_glob", str(fixtures / "scene*.h5"),
                "--output_dir", str(out / "crops"), "--n_patches", "3",
                "--min_size", "12", "--seed", "4"]

    jax_dir, port_dir = _run(fixtures, argv)
    _same_outputs(jax_dir, port_dir, min_files=5)


def _labeled_arrays():
    N, H, W = 2, 30, 26
    rng = np.random.default_rng(3)
    images = rng.integers(0, 255, (N, H, W, 3)).astype(np.uint8)
    depths = rng.uniform(0.5, 9.0, (N, H, W)).astype(np.float32)
    labels = np.zeros((N, H, W), np.uint16)
    labels[0, 2:6, 3:8] = 7
    labels[0, 10:20, 1:4] = 3
    labels[1, 1:4, 1:4] = 2
    return images, depths, labels


@pytest.mark.parametrize("storage", ["v7.3", "v5"])
def test_nyu_labeled_from_both_storage_formats(fixtures, storage):
    images, depths, labels = _labeled_arrays()
    mat = fixtures / f"labeled_{storage}.mat"
    if storage == "v7.3":  # MATLAB's HDF5 layout as h5py reads it
        import h5py

        with h5py.File(mat, "w") as f:
            f["images"] = images.transpose(0, 3, 2, 1)  # [N, 3, W, H]
            f["depths"] = depths.transpose(0, 2, 1)
            f["labels"] = labels.transpose(0, 2, 1)
    else:
        from scipy.io import savemat

        savemat(str(mat), {"images": images.transpose(1, 2, 3, 0),
                           "depths": depths.transpose(1, 2, 0),
                           "labels": labels.transpose(1, 2, 0)})
    from rangeclip_tpu_torch.setup_tools.nyu import load_nyu_labeled_mat

    data = load_nyu_labeled_mat(str(mat))
    np.testing.assert_array_equal(data["images"], images)
    np.testing.assert_array_equal(data["depths"], depths)
    np.testing.assert_array_equal(data["labels"], labels)

    def argv(out, _port):
        return ["nyu-labeled", "--mat_path", str(mat), "--output_dir",
                str(out / "patches"), "--patch_size", "8",
                "--bbox_padding", "2"]

    jax_dir, port_dir = _run(fixtures, argv)
    _same_outputs(jax_dir, port_dir, min_files=7)
    rows = list(csv.DictReader(open(port_dir / "patches/metadata.csv")))
    assert sorted(int(r["object_id"]) for r in rows) == [2, 3, 7]


def _write_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def test_combine_metadata_text_equal(fixtures):
    _write_csv(fixtures / "m1.csv", ["image", "depth", "object_id"],
               [["a.png", "a_d.png", 3], ["b, quoted.png", "b_d.png", 12]])
    _write_csv(fixtures / "m2.csv", ["image", "depth", "object_id"],
               [["c.png", "c_d.png", 7]])

    def argv(out, _port):
        return ["combine-metadata", "--inputs", str(fixtures / "m1.csv"),
                str(fixtures / "m2.csv"), "--output_csv",
                str(out / "all.csv")]

    jax_dir, port_dir = _run(fixtures, argv)
    _same_outputs(jax_dir, port_dir)
    assert (port_dir / "all.csv").read_text().count("\n") == 4


def test_combine_metadata_pandas_trait(fixtures):
    """Numeric and empty cells: the texts differ only where pandas
    re-types a cell, and there the numbers are equal."""
    _write_csv(fixtures / "n1.csv", ["image", "object_id", "scale"],
               [["a.png", 3, "0.5"], ["b.png", "", "1.50"]])
    _write_csv(fixtures / "n2.csv", ["image", "object_id", "scale"],
               [["c.png", 7, "2"], ["d.png", 12, ""]])

    def argv(out, _port):
        return ["combine-metadata", "--inputs", str(fixtures / "n1.csv"),
                str(fixtures / "n2.csv"), "--output_csv",
                str(out / "all.csv")]

    jax_dir, port_dir = _run(fixtures, argv)
    want = list(csv.reader(open(jax_dir / "all.csv")))
    got = list(csv.reader(open(port_dir / "all.csv")))
    assert got == [["image", "object_id", "scale"], ["a.png", "3", "0.5"],
                   ["b.png", "", "1.50"], ["c.png", "7", "2"],
                   ["d.png", "12", ""]]
    assert len(got) == len(want)
    differing = []
    for g_row, w_row in zip(got, want):
        for g, w in zip(g_row, w_row):
            if g != w:
                differing.append((g, w))
                assert float(g) == float(w), (g, w)
    # object_id holds an empty cell: pandas reads it as floats; scale's
    # "1.50" and "2" are rewritten in pandas' float format
    assert sorted(differing) == sorted([("3", "3.0"), ("7", "7.0"),
                                        ("12", "12.0"), ("1.50", "1.5"),
                                        ("2", "2.0")])


def test_remove_small(fixtures):
    def argv(out, _port):
        return ["remove-small", "--metadata_csv", str(fixtures / "meta.csv"),
                "--output_csv", str(out / "pruned.csv"), "--min_count", "4"]

    jax_dir, port_dir = _run(fixtures, argv)
    _same_outputs(jax_dir, port_dir)
    assert len(list(csv.DictReader(open(port_dir / "pruned.csv")))) == 5


def test_pseudo_gt_from_detection_files(fixtures):
    def argv(out, _port):
        return ["pseudo-gt", "--detections_glob",
                str(fixtures / "dets/*.txt"), "--output_dir",
                str(out / "nms")]

    jax_dir, port_dir = _run(fixtures, argv)
    _same_outputs(jax_dir, port_dir, min_files=2)
    kept = [int(line.split()[0]) for line in
            (port_dir / "nms/img0.txt").read_text().splitlines()]
    assert kept == [1, 3]


def _fake_ultralytics(calls):
    class _Box:
        def __init__(self, cls, xywhn, conf):
            self.cls, self.xywhn, self.conf = cls, [xywhn], [conf]

    class _YOLO:
        def __init__(self, weights):
            calls.append(("weights", weights))

        def set_classes(self, names):
            calls.append(("classes", list(names)))

        def predict(self, source, **kwargs):
            calls.append(("predict", list(source)))
            assert kwargs.get("save_txt") is False
            return [types.SimpleNamespace(boxes=[
                _Box(2.0, [0.5, 0.5, 0.2, 0.2], 0.70),
                _Box(5.0, [0.5, 0.5, 0.2, 0.2], 0.90),
                _Box(1.0, [0.1, 0.1, 0.05, 0.05], 0.40)])]

    module = types.ModuleType("ultralytics")
    module.YOLO = _YOLO
    return module


def test_pseudo_gt_ultralytics_adapter(fixtures, monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, "ultralytics", _fake_ultralytics(calls))
    (fixtures / "imgs").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        fixtures / "imgs/scene0.png")
    (fixtures / "cats.json").write_text(
        '{"categories": [{"name": "chair"}, {"name": "table"}]}')

    def argv(out, _port):
        return ["pseudo-gt", "--images_glob", str(fixtures / "imgs/*.png"),
                "--yolo_weights", "local-yolo.pt", "--classes_json",
                str(fixtures / "cats.json"), "--output_dir", str(out / "gt")]

    jax_dir, port_dir = _run(fixtures, argv)
    _same_outputs(jax_dir, port_dir)
    assert calls[:3] == calls[3:] == [
        ("weights", "local-yolo.pt"), ("classes", ["chair", "table"]),
        ("predict", [str(fixtures / "imgs/scene0.png")])]
    from rangeclip_tpu_torch.setup_tools.pseudo_ground_truth import (
        read_detection_file,
    )

    dets = read_detection_file(str(port_dir / "gt/scene0.txt"))
    assert [int(c) for c in dets[:, 0]] == [5, 1]


def test_pseudo_gt_errors(fixtures, monkeypatch):
    with pytest.raises(SystemExit, match="exactly one"):
        port_setup.main(["pseudo-gt", "--output_dir", "x"])
    with pytest.raises(SystemExit, match="exactly one"):
        port_setup.main(["pseudo-gt", "--detections_glob", "a/*.txt",
                         "--images_glob", "b/*.png", "--output_dir", "x"])
    monkeypatch.setitem(sys.modules, "ultralytics", None)
    with pytest.raises(ImportError, match="'ultralytics' package"):
        port_setup.main(["pseudo-gt", "--images_glob", "b/*.png",
                         "--output_dir", str(fixtures / "x")])
