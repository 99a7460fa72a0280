"""Device selection.

The JAX package picks its kernels from the default backend
(``rangeclip_tpu/utils/platform.py``); its ``use_tpu_kernels()`` is False on
a GPU and has no counterpart here.  In the port the kernels run exactly when
the tensors lie on a CUDA device, and the device is always named by the
caller: nothing falls back to the CPU by itself.
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``, refusing a CUDA device that is absent."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is not available")
        if device.index is not None and device.index >= \
                torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (use cuda or cpu)")
    return device


def describe_device(device: torch.device) -> str:
    """A name for logs and /healthz: the card's name on CUDA."""
    if device.type == "cuda":
        index = device.index if device.index is not None else \
            torch.cuda.current_device()
        return f"cuda:{index} ({torch.cuda.get_device_name(index)})"
    return str(device)
