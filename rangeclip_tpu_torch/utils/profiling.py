"""Device time of the port's predict paths and train step on one GPU, from
``torch.profiler``.

The port's counterpart of ``rangeclip_tpu/utils/profiling.py``:

    python -m rangeclip_tpu_torch.utils.profiling \\
        --config bench_unfolded bench_folded serve_fp32_default train_step

``train_step`` is the flagship train configuration (:func:`train_setup`):
bf16, accumulation 1 x batch 32 at 256^2, C = 512 hash-stub labels with 40
present, contrast capacity 128, the full hybrid loss.  Each configuration
runs two calls, then ``--calls`` calls under the
profiler, at full width with random weights from seed 0.  Only device events
count (``device_type`` CUDA: kernels, copies and memsets), never the
host-side operator rows that enclose them, so no kernel is counted twice.
Per call it prints the host wall time, the sum of device event times, the
time the device was busy (the union of the events' intervals) and the busy
share (busy time / host wall time), then the device time of each event name
in decreasing order (the first 25).
"""

from __future__ import annotations

import argparse
import collections
import time
from typing import Callable, Dict, List

import torch
from torch.autograd import DeviceType

# (batch, bf16, folded, top_k, candidate slots or None for the full table)
TRAIN_CONFIG = "train_step"
CONFIGS = {
    "bench_folded": (128, True, True, 5, 384),
    "bench_unfolded": (128, True, False, 5, 384),
    "serve_fp32": (8, False, True, 1, None),
    "serve_bf16": (8, True, True, 1, None),
    "serve_fp32_default": (8, False, False, 1, None),
}
NUM_CLASSES = 512
RES = 256


def busy_us(spans: List[tuple]) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile(fn: Callable[[], object], calls: int = 3, warmup: int = 2
            ) -> Dict[str, object]:
    """Profile ``calls`` calls of ``fn`` after ``warmup`` unprofiled ones;
    times are ms per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device events only; user annotations on the GPU timeline (e.g. the
    # optimizer's "Optimizer.step#Adam.step" range) enclose kernels and
    # would count them twice
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        raise RuntimeError("the profiler recorded no device event")
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in events])
    return {
        "wall_ms": wall_us / calls / 1e3,
        "device_ms": sum(by_name.values()) / calls / 1e3,
        "busy_ms": busy / calls / 1e3,
        "busy_share": busy / wall_us,
        "events": [(name, us / calls / 1e3)
                   for name, us in by_name.most_common()],
    }


def predict_call(config: str) -> Callable[[], torch.Tensor]:
    """The predict call of one configuration, on the GPU."""
    from rangeclip_tpu_torch.cli.common import make_predict, set_precision
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        build_candidate_indices,
        predict_folded,
    )

    batch, bf16, folded, top_k, slots = CONFIGS[config]
    set_precision(bf16)
    device = torch.device("cuda")
    model = DepthUNet(DepthUNetConfig(dtype=torch.bfloat16 if bf16 else None),
                      device=device,
                      generator=torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator(device=device).manual_seed(1)
    depth = torch.randn(batch, RES, RES, 1, device=device, generator=gen)
    text = torch.randn(NUM_CLASSES, model.config.embedding_dim, device=device,
                       generator=gen)
    if slots is None:
        predict = make_predict(model, top_k, folded)
        run = lambda: predict(depth, text)  # noqa: E731
    else:
        seg = torch.randint(0, 40, (batch, RES, RES), device=device,
                            generator=gen)
        cand = build_candidate_indices(
            seg, NUM_CLASSES, 300, slots,
            generator=torch.Generator().manual_seed(2))
        if folded:
            run = lambda: predict_folded(  # noqa: E731
                model, depth, text, top_k=top_k, candidate_indices=cand)
        else:
            run = lambda: model.predict(  # noqa: E731
                depth, text, None, top_k, return_embeddings=False,
                candidate_indices=cand)[0]

    def call():
        with torch.inference_mode():
            return run()

    return call


def train_setup(device: torch.device, batch: int = 32, bf16: bool = True,
                present: int = 40, seed: int = 0):
    """The flagship train configuration at full width (accumulation 1 at
    256^2, C = 512) with random weights and data from ``seed``: (state,
    batch dict with a leading accumulation axis, text table, medium matrix,
    hard matrix, step function).  The segmentation holds ``present``
    labels, so the packed CE branch runs."""
    import numpy as np

    from rangeclip_tpu_torch.losses.hybrid import HybridLossConfig
    from rangeclip_tpu_torch.models.clip.crops import prepare_image_crops
    from rangeclip_tpu_torch.models.clip.provider import (
        HashImageEmbedder,
        HashTextEmbedder,
    )
    from rangeclip_tpu_torch.models.depth_unet import DepthUNetConfig
    from rangeclip_tpu_torch.training.state import create_train_state
    from rangeclip_tpu_torch.training.train_step import make_train_step

    cfg = DepthUNetConfig(dtype=torch.bfloat16 if bf16 else None)
    state = create_train_state(cfg, device, 1e-4, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    accum, res, num_classes = 1, RES, NUM_CLASSES
    shape = (accum, batch, res, res)
    seg = torch.randint(1, present + 1, shape, device=device, generator=gen,
                        dtype=torch.int32)
    images = torch.rand(accum * batch, res, res, 3, device=device,
                        generator=gen)
    boxes = torch.tensor([[16, 32, 200, 240]] * (accum * batch),
                         dtype=torch.int32, device=device)
    embed = HashImageEmbedder(cfg.embedding_dim)
    data = {
        "depth": torch.randn(*shape, 1, device=device, generator=gen),
        "segmentation": seg,
        "object_label": seg[:, :, res // 2, res // 2].contiguous(),
        "image_embeddings": embed(prepare_image_crops(images, boxes)).reshape(
            accum, batch, -1),
        "sample_valid": torch.ones(accum, batch, device=device),
    }
    labels = [f"class {i:03d}" for i in range(num_classes)]
    text = torch.from_numpy(HashTextEmbedder(cfg.embedding_dim)(labels)).to(
        device)
    rng = np.random.default_rng(seed + 2)
    medium, hard = (torch.from_numpy(rng.random((num_classes, num_classes))
                                     < 3 / num_classes).to(device)
                    for _ in range(2))
    step = make_train_step(HybridLossConfig(), accum)
    return state, data, text, medium, hard, step


def train_call() -> Callable[[], object]:
    """One flagship train step per call, on the GPU."""
    from rangeclip_tpu_torch.cli.common import set_precision

    set_precision(True)
    state, data, text, medium, hard, step = train_setup(torch.device("cuda"))

    def call():
        return step(state, data, (0, state.step), 1e-4, 0.0, 0.75, text,
                    medium, hard)

    return call


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", nargs="+",
                        choices=sorted(CONFIGS) + [TRAIN_CONFIG],
                        default=["bench_unfolded"])
    parser.add_argument("--calls", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: CUDA is not available")
    for config in args.config:
        result = profile(train_call() if config == TRAIN_CONFIG
                         else predict_call(config), args.calls)
        print(f"{config} on {torch.cuda.get_device_name(0)}, {args.calls} "
              f"calls: wall {result['wall_ms']:.3f} ms/call, device events "
              f"{result['device_ms']:.3f} ms/call, busy "
              f"{result['busy_ms']:.3f} ms/call, busy share "
              f"{result['busy_share']:.3f}", flush=True)
        for name, ms in result["events"][:25]:
            print(f"  {ms:9.3f} ms  {ms / result['device_ms']:6.1%}  "
                  f"{name[:110]}", flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
