"""Build, load, launch bookkeeping and op registration for the hand-written
CUDA kernels.

Each source under ``rangeclip_tpu_torch/csrc/`` compiles with its own
``nvcc`` process, all started together, and the objects link into one shared
library with a plain C interface, loaded with ``ctypes``: seconds of build,
against minutes for an extension that includes PyTorch's headers.  The
build runs at first use, into ``rangeclip_tpu_torch/_build/`` (listed in
``.gitignore``), under a name keyed by the sources' hash, so an edited
source is rebuilt and a stale library is never loaded.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.  Kernels run on the
current PyTorch stream and do not synchronise.

Every kernel is also a ``torch.library`` operator ``rangeclip::<name>``
(:func:`define_op`): its CUDA implementation launches the kernel, its CPU
implementation (the serving and predict kernels only; the training,
evaluation and opt-in kernels register none) is the plain version, and a fake implementation gives
``torch.export`` and ``torch.compile`` the output shapes.  The public
wrappers call the operator for CUDA tensors only and the plain version
directly for CPU tensors, so a program traced on the CPU holds no custom op.
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
from typing import Callable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
# Sources whose ptxas resource lines (registers, shared memory, spills) the
# build keeps: the tensor-core kernels and the redesigned CUDA-core ones.
PTXAS_VERBOSE = ("class_presence.cu", "conv_score_topk.cu", "head_topk.cu",
                 "histogram.cu", "live_rows.cu", "masked_pooling.cu",
                 "pixel_text_ce.cu", "pixel_text_ce_slots.cu",
                 "pixel_text_topk.cu", "tv_loss.cu",
                 "tv_rowtile.cu")

# Launches per kernel (and selector), counted by each wrapper right after a
# successful launch, so a run can show which kernels its main path went
# through.  Comparison and timing code resets it before the path it proves.
launch_counts = {
    "class_presence": 0,  # with a validity vector
    "class_presence[labels]": 0,  # every label valid: the labels only
    "score_topk[knockout]": 0,
    "score_topk[packed]": 0,
    "conv_score_topk": 0,
    "pixel_text_topk[bf16]": 0,  # tensor cores
    "pixel_text_topk[fp32]": 0,  # CUDA cores (and bf16 beyond 1280 dims)
    "l2_normalize[fwd]": 0,
    "l2_normalize[bwd]": 0,
    "histogram": 0,
    "live_rows": 0,  # the gather of the CUDA-core scoring kernels' rows
    "pixel_text_ce[fwd]": 0,  # CUDA cores: the contrast members
    "pixel_text_ce[bwd]": 0,
    "pixel_text_ce_tc[fwd]": 0,  # tensor cores: the bf16 packed branch
    "pixel_text_ce_tc[bwd]": 0,
    # tensor cores: bf16 past 4 label slots, every contrast member
    "pixel_text_ce_slots[fwd]": 0,
    "pixel_text_ce_slots[bwd]": 0,
    "tv_rowtile[fwd]": 0,
    "tv_rowtile[bwd]": 0,
    "masked_pooling": 0,
    "head_topk[bf16]": 0,  # tensor cores
    "head_topk[fp32]": 0,  # CUDA cores (and bf16 beyond C_in 64 or D 512)
    "tv_loss[fwd]": 0,
    "tv_loss[bwd]": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "rc_class_presence": (_P, _P, _L, _I, _P, _P, _P),
    "rc_score_topk": (_P, _I, _I, _P, _L, _I, _I, _P, _P, _P),
    "rc_conv_score_topk": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "rc_pixel_text_topk": (_P, _P, _P, _L, _I, _I, _I, _P, _P, _P),
    "rc_pixel_text_topk_fma": (_P, _I, _P, _I, _P, _P, _L, _I, _I, _I, _P,
                               _P, _P),
    "rc_l2_normalize_fwd": (_P, _I, _P, _L, _I, _P),
    "rc_l2_normalize_bwd": (_P, _P, _I, _P, _L, _I, _P),
    "rc_histogram": (_P, _I, _L, _I, _P, _P),
    "rc_live_rows": (_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _P, _I,
                     _P, _P, _P),
    "rc_live_rows_bf16": (_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P,
                          _I, _P, _P, _P),
    "rc_pixel_text_ce_members_fwd": (_P, _I, _P, _P, _P, _I, _L, _I, _P, _I,
                                     _P, _P, _P, _I, _P, _P, _I, _P, _I,
                                     _P, _P, _P),
    "rc_pixel_text_ce_bwd": (_P, _I, _P, _P, _P, _P, _I, _L, _I, _P, _I, _P,
                             _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P,
                             _P, _P, _P),
    "rc_pixel_text_ce_tc_fwd": (_P, _P, _P, _P, _I, _L, _I, _P, _P, _P, _I,
                                _P, _P, _P, _P),
    "rc_pixel_text_ce_tc_bwd": (_P, _P, _P, _P, _P, _I, _L, _I, _P, _P, _P,
                                _P, _I, _P, _P, _P, _P),
    "rc_pixel_text_ce_slots_fwd": (_P, _P, _P, _P, _L, _I, _P, _P, _P, _I,
                                   _P, _I, _P, _P, _I, _P, _P, _P, _P),
    "rc_pixel_text_ce_slots_bwd": (_P, _P, _P, _P, _P, _L, _I, _P, _P, _I,
                                   _P, _P, _I, _P, _P, _I, _P, _P, _P, _I,
                                   _P, _P, _P, _I, _P, _P, _P, _P, _P),
    "rc_tv_rowtile_fwd": (_P, _I, _I, _I, _I, _P, _P, _F, _F, _F, _F, _P,
                          _P),
    "rc_tv_rowtile_bwd": (_P, _I, _I, _I, _I, _P, _P, _F, _F, _F, _F, _P,
                          _P),
    "rc_masked_pooling": (_P, _I, _P, _P, _L, _I, _I, _P, _P, _P, _P, _P, _P,
                          _P, _P),
    "rc_head_topk": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                     _P, _P, _P, _L, _P, _P, _P),
    "rc_head_topk_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                        _P, _P),
    "rc_tv_loss_fwd": (_P, _I, _I, _I, _I, _I, _P, _F, _F, _P, _P),
    "rc_tv_loss_bwd": (_P, _I, _I, _I, _I, _I, _P, _F, _F, _P, _P),
}
# Queries that return a long long: the dynamic shared memory of a kernel's
# block at a width (D, C_in) or for a field dtype (is_bf16).
_QUERIES = ("rc_pixel_text_topk_tc_smem", "rc_conv_score_topk_smem",
            "rc_pixel_text_topk_fma_smem")
# Queries of a kernel's device workspace in bytes at (a width, rows).
_WORKSPACE_QUERIES = ("rc_pixel_text_ce_workspace",)
# Queries of a kernel's scratch at a field shape: their int arguments,
# (B, H, W, D) or (is_bf16, B, H, W, D).
_SHAPE_QUERIES = {"rc_tv_rowtile_fwd_partials": 4,
                  "rc_tv_loss_fwd_partials": 5}

OPS = torch.library.Library("rangeclip", "DEF")


def define_op(schema: str, cuda_impl: Callable,
              cpu_impl: Optional[Callable], fake_impl: Callable):
    """Define ``rangeclip::<schema>`` with its CUDA and fake
    implementations, and a CPU one where given; returns the operator
    overload."""
    name = schema.split("(", 1)[0]
    OPS.define(schema)
    OPS.impl(name, cuda_impl, "CUDA")
    if cpu_impl is not None:
        OPS.impl(name, cpu_impl, "CPU")
    torch.library.register_fake(f"rangeclip::{name}", fake_impl, lib=OPS)
    return getattr(torch.ops.rangeclip, name).default


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library for these sources already existed
    ptxas: str  # ptxas -v lines of PTXAS_VERBOSE's sources, kept beside it


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


def _run_all(cmds) -> list:
    """Run the commands concurrently; return their outputs, or raise with
    the compiler's output if any fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        outputs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n({proc.returncode}):\n"
                          f"{outputs[-1]}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return outputs


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` into the shared library unless it exists: one
    ``nvcc -c`` per source, all at once, then one link."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"librangeclip_kernels_{digest.hexdigest()[:16]}.so"
    ptxas_file = out.with_suffix(".ptxas.txt")
    if out.exists():
        return BuildResult(out, 0.0, ptxas_file.read_text()
                           if ptxas_file.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        outputs = _run_all([
            [nvcc, *NVCC_FLAGS,
             *(("-Xptxas", "-v") if src.name in PTXAS_VERBOSE else ()),
             "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources, objects)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objects)]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    ptxas = "".join(f"== {src.name}\n{text}" for src, text
                    in zip(sources, outputs) if src.name in PTXAS_VERBOSE)
    ptxas_file.write_text(ptxas)
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return BuildResult(out, seconds, ptxas)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        for name in _QUERIES:
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_longlong
        for name in _WORKSPACE_QUERIES:
            getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_longlong]
            getattr(lib, name).restype = ctypes.c_longlong
        for name, ints in _SHAPE_QUERIES.items():
            getattr(lib, name).argtypes = [ctypes.c_int] * ints
            getattr(lib, name).restype = ctypes.c_longlong
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


def topk_outputs(like: torch.Tensor, n: int, top_k: int, want_values: bool):
    """Empty (idx [n, k] int32, values [n, k] f32) on ``like``'s device; the
    values are [0] when not wanted, since an operator cannot return None."""
    idx = like.new_empty((n, top_k), dtype=torch.int32)
    val = like.new_empty((n, top_k) if want_values else (0,),
                         dtype=torch.float32)
    return idx, val


def workspace(query: str, like: torch.Tensor, d: int, rows: int
              ) -> Optional[torch.Tensor]:
    """The device workspace a kernel asks for at (d, rows), allocated on
    ``like``'s device and current stream, or None when it needs none."""
    nbytes = getattr(library(), query)(d, rows)
    return (like.new_empty(nbytes, dtype=torch.uint8) if nbytes > 0
            else None)


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pad_dim8(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` with its last dimension zero-padded up to the next multiple of
    8, the width the kernels take; ``t`` itself (or None) when it already
    is one.  Differentiable: the gradient is sliced back."""
    if t is None or t.shape[-1] % 8 == 0:
        return t
    return torch.nn.functional.pad(t, (0, -t.shape[-1] % 8))


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
