"""Numerical-health monitoring (``rangeclip_tpu/utils/monitoring.py``).

Reference: utils/src/log_utils.py:80-121 (``validate_tensor`` NaN/Inf/
extreme-value checker), train_util.py:35-36 (``contains_nan``).

Plus what the JAX package adds: a step timer, a device trace context
(``torch.profiler`` here, where JAX runs ``jax.profiler``) and per-device
memory statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


def contains_nan(x) -> bool:
    return bool(torch.isnan(torch.as_tensor(x)).any())


def validate_tensor(
    x,
    name: str = "tensor",
    extreme: float = 1e8,
    raise_on_error: bool = False,
) -> Dict[str, float]:
    """Check for NaN/Inf/extreme magnitudes; returns summary stats.

    (log_utils.py:80-121 semantics: report rather than silently continue.)
    """
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    arr = np.asarray(x, dtype=np.float64)
    stats = {
        "nan": float(np.isnan(arr).sum()),
        "inf": float(np.isinf(arr).sum()),
        "extreme": float((np.abs(arr[np.isfinite(arr)]) > extreme).sum()),
        "min": float(np.nanmin(arr)) if arr.size else 0.0,
        "max": float(np.nanmax(arr)) if arr.size else 0.0,
        "mean": float(np.nanmean(arr)) if arr.size else 0.0,
    }
    bad = stats["nan"] or stats["inf"] or stats["extreme"]
    if bad:
        msg = (
            f"validate_tensor[{name}]: nan={stats['nan']:.0f} "
            f"inf={stats['inf']:.0f} extreme={stats['extreme']:.0f} "
            f"range=[{stats['min']:.3e}, {stats['max']:.3e}]"
        )
        if raise_on_error:
            raise FloatingPointError(msg)
        print(f"Warning: {msg}")
    return stats


class StepTimer:
    """Wall-clock step timing with warmup exclusion (for maps/sec).  The
    caller synchronises the device before ``stop`` where the step is
    asynchronous."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block, CPU and (where CUDA is available)
    CUDA activity, written as a Chrome trace ``trace-<pid>-<ns>.json`` into
    ``log_dir`` when the block ends; the path is in the yielded list.  A
    no-op when ``log_dir`` is None.  The caller synchronises the device
    before the block ends, so the trace holds the block's kernels."""
    if log_dir is None:
        yield []
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    written = []
    with torch.profiler.profile(activities=activities) as prof:
        yield written
    path = os.path.join(log_dir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    written.append(path)


def log_device_usage(log_fn=print) -> dict:
    """Per-device memory stats (the reference's ``log_gpu_usage``,
    validate.py:19-22): ``torch.cuda.memory_stats`` of each visible CUDA
    device, keyed ``cuda:<i>``, with a one-line summary logged per device;
    ``{}`` without CUDA (the CPU reports none)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for index in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(index)
        out[f"cuda:{index}"] = stats
        used = stats.get("allocated_bytes.all.current")
        limit = torch.cuda.get_device_properties(index).total_memory
        if used is not None:
            log_fn(f"[cuda:{index}] memory in use: {used / 2**20:.1f} MiB "
                   f"({100 * used / limit:.1f}%)")
    return out
