"""Build, load and launch bookkeeping for the hand-written CUDA kernels.

All sources under ``rangeclip_tpu_torch/csrc/`` compile with ``nvcc`` into
one shared library with a plain C interface, loaded with ``ctypes``: a few
seconds of build, against minutes for an extension that includes PyTorch's
headers.  The build runs at first use, into ``rangeclip_tpu_torch/_build/``
(listed in ``.gitignore``), under a name keyed by the sources' hash, so an
edited source is rebuilt and a stale library is never loaded.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.  Kernels run on the
current PyTorch stream and do not synchronise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Launches per kernel (and selector), counted by each wrapper right after a
# successful launch, so a run can show which kernels its main path went
# through.  Comparison and timing code resets it before the path it proves.
launch_counts = {
    "class_presence": 0,
    "score_topk[knockout]": 0,
    "score_topk[packed]": 0,
    "conv_score_topk": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "rc_class_presence": (_P, _P, _L, _I, _P, _P),
    "rc_score_topk": (_P, _I, _I, _P, _L, _I, _I, _P, _P, _P),
    "rc_conv_score_topk": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library for these sources already existed


_library: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "rangeclip_tpu_torch cannot be built")


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` into the shared library unless it exists."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"librangeclip_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return BuildResult(out, seconds)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.rc_error_string.argtypes = [ctypes.c_int]
        lib.rc_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error; else count the launch."""
    if code != 0:
        message = library().rc_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} "
                           f"({message})")
    launch_counts[kernel] += 1


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(message)


def require_device(kernel: str, *tensors: torch.Tensor) -> str:
    """The tensors' common device type: 'cuda' launches the kernel, 'cpu'
    runs the plain version; anything else is refused."""
    devices = {t.device for t in tensors}
    require(len(devices) == 1,
            f"{kernel}: tensors on several devices {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    require(kind in ("cuda", "cpu"), f"{kernel}: unsupported device {kind}")
    return kind
