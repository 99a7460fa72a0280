"""The port's native C++ preprocessing (``rangeclip_tpu_torch/native``) on
the CPU: the PNG decoder byte-identical to PIL on RGB, 8-bit and 16-bit
grayscale files and handing palette, alpha and Adam7 files (and a JPEG) to
PIL, counted; the native depth transform and label resize bit-equal to the
JAX package's native versions, and the numpy paths (``RANGECLIP_NATIVE=off``)
bit-equal to JAX's numpy paths (never across the two: the native transform
multiplies by 1/median, numpy divides); a dataset sample equal to JAX's
with both native paths on; the build keyed, atomic under two concurrent
builds, and raising on a compiler error unless the native path is off."""

import ctypes
import os
import shutil
import struct
import subprocess
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from rangeclip_tpu import native as jax_native
from rangeclip_tpu.data import transforms as jax_transforms
from rangeclip_tpu_torch import native
from rangeclip_tpu_torch.data import transforms
from rangeclip_tpu_torch.data.dataset import open_gray, open_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEPTH_CASES = [((37, 53), (24, 24)), ((480, 640), (224, 224)),
               ((10, 10), (10, 10)), ((16, 16), (40, 24)),
               ((33, 61), (32, 60)), ((8, 8), (4, 4))]


def _adam7_png(path: str, pixels: np.ndarray) -> None:
    """An 8-bit RGB PNG with Adam7 interlacing (PIL writes none): each pass
    a sub-image of unfiltered rows."""
    H, W, _ = pixels.shape
    raw = b""
    for y0, x0, dy, dx in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4),
                           (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
                           (1, 0, 2, 1)):
        sub = pixels[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\x00" + row.tobytes() for row in sub)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 1))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    smooth = np.add.outer(np.arange(45), np.arange(67)) % 256
    files = {
        "rgb": rng.integers(0, 256, (37, 53, 3), np.uint8),
        "rgb_smooth": np.stack([smooth, smooth // 2, 255 - smooth],
                               -1).astype(np.uint8),
        "gray8": rng.integers(0, 256, (41, 29), np.uint8),
        "gray16": rng.integers(0, 65536, (33, 61)).astype(np.int32),
        "flat": np.full((64, 64, 3), 7, np.uint8),
    }
    paths = {}
    for name, a in files.items():
        paths[name] = str(d / f"{name}.png")
        if name == "gray16":
            Image.fromarray(a, mode="I").save(paths[name])
        else:
            Image.fromarray(a).save(paths[name])
    fallback = {
        "palette": Image.fromarray(files["rgb"]).convert("P"),
        "rgba": Image.fromarray(rng.integers(0, 256, (10, 12, 4), np.uint8),
                                mode="RGBA"),
        "gray_alpha": Image.fromarray(files["rgb"]).convert("LA"),
    }
    for name, image in fallback.items():
        paths[name] = str(d / f"{name}.png")
        image.save(paths[name])
    paths["adam7"] = str(d / "adam7.png")
    _adam7_png(paths["adam7"], files["rgb"])
    paths["jpeg"] = str(d / "image.jpg")
    Image.fromarray(files["rgb"]).save(paths["jpeg"])
    return paths


@pytest.mark.parametrize("name", ["rgb", "rgb_smooth", "gray8", "gray16",
                                  "flat"])
def test_png_decode_is_byte_identical_to_pil(pngs, name):
    before = native.pil_fallbacks.value
    got = native.decode_png_native(pngs[name])
    want = np.asarray(Image.open(pngs[name]))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert native.pil_fallbacks.value == before
    # the dataset's loaders: PIL's convert("I") / convert("RGB") arrays
    if got.ndim == 2:
        gray = open_gray(pngs[name])
        assert gray.dtype == np.int32
        np.testing.assert_array_equal(
            gray, np.asarray(Image.open(pngs[name]).convert("I")))
    rgb = np.asarray(open_rgb(pngs[name]))
    np.testing.assert_array_equal(
        rgb, np.asarray(Image.open(pngs[name]).convert("RGB")))


@pytest.mark.parametrize("name", ["palette", "rgba", "gray_alpha", "adam7",
                                  "jpeg"])
def test_unsupported_files_take_pil_and_are_counted(pngs, name):
    native.pil_fallbacks.reset()
    assert native.decode_png_native(pngs[name]) is None
    assert native.pil_fallbacks.value == 1
    rgb = np.asarray(open_rgb(pngs[name]))
    np.testing.assert_array_equal(
        rgb, np.asarray(Image.open(pngs[name]).convert("RGB")))
    assert native.pil_fallbacks.value == 2
    if name == "adam7":  # PIL reads the interlaced file back exactly
        np.testing.assert_array_equal(
            rgb, np.asarray(Image.open(pngs["rgb"])))


def test_threads_decode_and_count_together(pngs):
    """16 threads decode at once (ctypes drops the GIL): every result
    byte-identical, every fallback counted once."""
    native.pil_fallbacks.reset()
    names = ["rgb", "gray16", "palette", "adam7"] * 40
    want = {n: np.asarray(Image.open(pngs[n])).tobytes()
            for n in ("rgb", "gray16")}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            got = list(pool.map(
                lambda n: (n, native.decode_png_native(pngs[n])), names))
    finally:
        sys.setswitchinterval(switch)
    for n, arr in got:
        if n in want:
            assert arr.tobytes() == want[n]
        else:
            assert arr is None
    assert native.pil_fallbacks.value == 80


def _depth(shape, seed):
    return np.random.default_rng(seed).uniform(100, 5000, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape, size", DEPTH_CASES)
def test_depth_transform_bit_equal_to_jax_on_each_path(shape, size,
                                                       monkeypatch):
    assert jax_native.lib() is not None, "the JAX native library must build"
    d = _depth(shape, shape[0])
    got = native.depth_transform_native(d, size)
    want = jax_native.depth_transform_native(d, size)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert transforms.depth_transform(d, size).tobytes() == want.tobytes()
    seg = np.random.default_rng(1).integers(0, 99, shape).astype(np.int32)
    assert (native.segmentation_resize_native(seg, size).tobytes()
            == jax_native.segmentation_resize_native(seg, size).tobytes())

    monkeypatch.setenv("RANGECLIP_NATIVE", "off")
    assert native.lib() is None and jax_native.lib() is None
    got_np = transforms.depth_transform(d, size)
    want_np = jax_transforms.depth_transform(d, size)
    assert got_np.dtype == np.float32 and got_np.tobytes() == \
        want_np.tobytes()
    assert (transforms.segmentation_transform(seg, size).tobytes()
            == jax_transforms.segmentation_transform(seg, size).tobytes())
    # across the two paths: a multiply by 1/median against a divide
    ulp = np.spacing(np.abs(got_np))
    assert (np.abs(got - got_np) <= ulp).all()


def test_zero_median_gives_zeros():
    zeros = np.zeros((8, 8), np.float32)
    assert not native.depth_transform_native(zeros, (4, 4)).any()


def test_dataset_sample_equals_jax_with_native_on(tmp_path):
    from rangeclip_tpu.data.dataset import ImageDepthTextDataset as JaxSet
    from rangeclip_tpu_torch.data.dataset import ImageDepthTextDataset
    from rangeclip_tpu_torch.data.synthetic import write_synthetic_dataset

    paths = write_synthetic_dataset(str(tmp_path), n_samples=3,
                                    shape=(40, 36), num_classes=8)
    ours = ImageDepthTextDataset(paths["metadata"], paths["labels"], (24, 20))
    theirs = JaxSet(paths["metadata"], paths["labels"], (24, 20))
    native.pil_fallbacks.reset()
    for i in range(3):
        got = ours.__getitem__(i, np.random.default_rng(i))
        want = theirs.__getitem__(i, np.random.default_rng(i))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert native.pil_fallbacks.value == 0


_BUILD = r"""
import sys
from pathlib import Path
from rangeclip_tpu_torch import native
print(native.build(Path(sys.argv[1])))
"""


def test_two_concurrent_builds(tmp_path):
    """Two processes build the library from nothing into one directory at
    the same moment: both name the same file, which loads, and no private
    file is left."""
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build_dir)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "PYTHONPATH": REPO})
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert os.listdir(build_dir) == [os.path.basename(paths.pop())]
    built = native._bind(ctypes.CDLL(
        str(build_dir / os.listdir(build_dir)[0])))
    assert built.preprocess_abi_version() == native.ABI_VERSION


def test_a_failed_build_raises_unless_off(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        shutil.copy(os.path.join(native.NATIVE_DIR, name), src / name)
    with open(src / "preprocess.cpp", "a") as f:
        f.write("\nint broken( {\n")
    with pytest.raises(RuntimeError, match="error"):
        native.build(tmp_path / "build", src)
    assert not any((tmp_path / "build").iterdir())

    def failing():
        raise RuntimeError("building the native preprocessing library "
                           "failed")

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "build", failing)
    with pytest.raises(RuntimeError, match="native preprocessing"):
        native.lib()
    d = _depth((12, 10), 3)
    with pytest.raises(RuntimeError):
        transforms.depth_transform(d, (6, 5))
    monkeypatch.setenv("RANGECLIP_NATIVE", "off")
    assert native.lib() is None
    assert transforms.depth_transform(d, (6, 5)).tobytes() == \
        jax_transforms.depth_transform(d, (6, 5)).tobytes()


def test_missing_compiler_is_named(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build(tmp_path / "build")
