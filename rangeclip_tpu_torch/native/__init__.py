"""Native (C++) host preprocessing through ctypes
(``rangeclip_tpu/native/``): the PNG decoder and the depth and label
transforms of the data loader.

:func:`lib` builds ``preprocess.cpp`` and ``png_decode.cpp`` at first use
with the system g++ (``CXX`` names another compiler) into
``rangeclip_tpu_torch/_build/``, under a name keyed by the sources, the
flags and the instruction set ``-march=native`` selects on this host, so an
edited source is rebuilt and a library built on another CPU is never
loaded.  The compiler writes a private file that is then renamed into
place: builds that race (test workers, loader threads) never load half a
file.  A failed build or load raises with the compiler's output; only
``RANGECLIP_NATIVE=off`` (an environment variable, so it reaches every
process) turns the native path off, and the callers then take the numpy
and PIL paths.

The one fallback kept is the decoder's own: a PNG shape it does not handle
(palette, alpha, Adam7 interlacing, another bit depth) or a file that is
not a PNG decodes through PIL, as in JAX, and :data:`pil_fallbacks` counts
those files.  ctypes releases the GIL during each call, so the loader's
threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
SOURCES = ("preprocess.cpp", "png_decode.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
# Must equal preprocess.cpp's preprocess_abi_version(); bump both on any
# exported-signature or semantics change.
ABI_VERSION = 2


class Counter:
    """A count that threads can add to."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0


# PNG files the native decoder handed to PIL (see module docstring)
pil_fallbacks = Counter()

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TARGETS: dict = {}


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _target(cxx: str) -> bytes:
    """The macros ``-march=native`` defines on this host (its instruction
    set), part of the library's name."""
    if cxx not in _TARGETS:
        proc = subprocess.run([cxx, "-march=native", "-E", "-dM", "-x", "c++",
                               os.devnull], capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cxx} -march=native failed ({proc.returncode}):\n"
                f"{proc.stderr.decode(errors='replace')}")
        _TARGETS[cxx] = proc.stdout
    return _TARGETS[cxx]


def build(build_dir: Path = BUILD_DIR, source_dir: Path = NATIVE_DIR) -> Path:
    """Compile the sources into ``build_dir`` unless the library for them
    exists there; returns its path.  Raises with the compiler's output when
    the compiler fails or is missing."""
    cxx = _compiler()
    sources = [Path(source_dir) / name for name in SOURCES]
    digest = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    for path in sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    try:
        digest.update(_target(cxx))
    except FileNotFoundError as e:
        raise RuntimeError(
            f"the native preprocessing library needs a C++ compiler: {cxx} "
            "was not found (set CXX, or RANGECLIP_NATIVE=off for the numpy "
            "and PIL paths)") from e
    out = Path(build_dir) / f"libpreprocess_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = [cxx, *CXX_FLAGS, *map(str, sources), "-o", str(tmp), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native preprocessing library failed "
                f"({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a racing build never loads half a file
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _bind(cdll: ctypes.CDLL) -> ctypes.CDLL:
    i64, ci = ctypes.c_int64, ctypes.c_int
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    cip = ctypes.POINTER(ci)
    for name, argtypes, restype in (
            ("nearest_resize_f32", [f32p, f32p, i64, i64, i64, i64, i64],
             None),
            ("nearest_resize_i32", [i32p, i32p, i64, i64, i64, i64], None),
            ("lower_median_f32", [f32p, i64], ctypes.c_float),
            ("median_normalize_f32", [f32p, i64], None),
            ("depth_transform_f32", [f32p, f32p, i64, i64, i64, i64], None),
            ("png_header", [ctypes.c_char_p, cip, cip, cip, cip], ci),
            ("png_decode", [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long],
             ci),
            ("preprocess_abi_version", [], i64)):
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = argtypes, restype
    version = cdll.preprocess_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(
            f"native preprocessing library ABI {version}, expected "
            f"{ABI_VERSION}: the sources and native/__init__.py disagree")
    return cdll


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None only when
    ``RANGECLIP_NATIVE`` is ``off`` (or ``0``)."""
    global _LIB
    if os.environ.get("RANGECLIP_NATIVE", "").lower() in ("off", "0"):
        return None
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _check_2d(a: np.ndarray, size) -> tuple:
    h_out, w_out = (int(v) for v in size)
    if a.ndim != 2 or min(a.shape) < 1 or h_out < 1 or w_out < 1:
        raise ValueError(f"expected a non-empty 2-D map and a positive size, "
                         f"got {a.shape} -> {size}")
    return h_out, w_out


def depth_transform_native(depth: np.ndarray, size) -> Optional[np.ndarray]:
    """Fused nearest resize + lower-median normalisation to f32 [H, W];
    None when the native path is off."""
    cdll = lib()
    if cdll is None:
        return None
    src = np.ascontiguousarray(depth, np.float32)
    h_out, w_out = _check_2d(src, size)
    dst = np.empty((h_out, w_out), np.float32)
    cdll.depth_transform_f32(_fptr(src), _fptr(dst), src.shape[0],
                             src.shape[1], h_out, w_out)
    return dst


def segmentation_resize_native(seg: np.ndarray, size
                               ) -> Optional[np.ndarray]:
    """Nearest resize of an integer label map to int32 [H, W]; None when
    the native path is off."""
    cdll = lib()
    if cdll is None:
        return None
    src = np.ascontiguousarray(seg, np.int32)
    h_out, w_out = _check_2d(src, size)
    dst = np.empty((h_out, w_out), np.int32)
    cdll.nearest_resize_i32(_iptr(src), _iptr(dst), src.shape[0],
                            src.shape[1], h_out, w_out)
    return dst


def decode_png_native(path: str) -> Optional[np.ndarray]:
    """A PNG's pixels, byte-identical with PIL's: uint8 [H, W] or
    [H, W, 3], or uint16 [H, W].  None when the native path is off, or when
    the file is not a PNG of a shape the decoder handles (counted in
    :data:`pil_fallbacks`; the caller decodes it with PIL)."""
    cdll = lib()
    if cdll is None:
        return None
    w, h, ch, bits = (ctypes.c_int() for _ in range(4))
    p = os.fsencode(path)
    if cdll.png_header(p, ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch),
                       ctypes.byref(bits)) != 0:
        pil_fallbacks.add()
        return None
    dtype = np.uint16 if bits.value == 16 else np.uint8
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, dtype)
    if cdll.png_decode(p, out.ctypes.data_as(ctypes.c_void_p),
                       ctypes.c_long(out.nbytes)) != 0:
        pil_fallbacks.add()
        return None
    return out
