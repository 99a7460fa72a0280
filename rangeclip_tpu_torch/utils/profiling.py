"""Device time of the port's predict paths and train step on one GPU, from
``torch.profiler``.

The port's counterpart of ``rangeclip_tpu/utils/profiling.py``:

    python -m rangeclip_tpu_torch.utils.profiling \\
        --config bench_unfolded bench_folded serve_fp32_default train_step

``train_step`` is the flagship train configuration (:func:`train_setup`):
bf16, accumulation 1 x batch 32 at 256^2, C = 512 hash-stub labels with 40
present, contrast capacity 128, the full hybrid loss.  ``train_step_fp32``
is ``cli/train``'s default precision at its microbatch (fp32, batch 16, 40
labels present: 90 contrast members), ``train_step_overflow`` the bf16
step whose contrast set overflows the capacity (150 labels present: 200
members, the full-table branch); ``train_step_mit`` the bf16 MiT step
(stage widths 64-512) at ``cli/train``'s batch 16, whose field at H/4
gives the CE 16 label slots.  Each train configuration's line also gives
the CE's device time and share (its kernels and their tables' gather,
:data:`CE_EVENTS`).  ``serve_fp32_fused`` is
``predict_topk_fused`` on the fp32 serve model (batch 8, all 512 classes
live, top-1: ``head_topk``'s CUDA-core route).  ``ce_forward``,
``ce_forward_all``, ``ce_backward``, ``tv_forward``, ``tv_loss``,
``tv_loss_fp32``, ``histogram``, ``presence_*``, ``head_topk``,
``head_topk_fp32`` and ``masked_pooling`` call one operator (``tv_loss*``:
its forward and backward) at the shape of its main path
(:func:`kernel_call`): ``pixel_text_ce``'s forward on the fp32 validation
shape with 90 and with all 512 classes in the contrast set, its backward
with 90 (an fp32 train microbatch of batch 8), ``tv_rowtile``'s forward on
the flagship train field, ``fused_tv_loss``'s operators on the flagship
train field in bf16 and in f32, the flagship step's histogram, and
``class_presence`` at the bench shape and the main paths' label counts,
``fused_head_score_topk`` on bf16 pre-head features at the bench shape
(its tensor-core route) and on f32 ones at the serve shape (its CUDA-core
route), and ``fused_masked_pooling`` on the flagship train field;
``candidate_mask`` is validation's ``build_candidate_mask`` at batch 8.
Each configuration runs two calls, then ``--calls`` calls timed by the
host clock (synchronised), then as many under the profiler, at full width
with random weights from seed 0.  Only device events count
(``device_type`` CUDA: kernels, copies and memsets), never the host-side
operator rows that enclose them, so no kernel is counted twice.  Per call
it prints the unprofiled host clock, the host wall time under the profiler,
the sum of device event times, the number of device events (the launches,
copies and memsets), the time the device was busy (the union of the
events' intervals), the busy share (busy time / host wall time under the
profiler) and the traces taken (:func:`profile`), then the device time of each event name in decreasing order
(the first 25), and with ``--host N`` the N host operators with the most
CPU time of their own.  The script calls public operators only, so a copy
of it placed in another checkout of the package profiles that checkout.
"""

from __future__ import annotations

import argparse
import collections
import re
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType

# (batch, bf16, labels present, UNet) of the train steps
TRAIN_CONFIGS = {
    "train_step": (32, True, 40, "resnet"),
    "train_step_fp32": (16, False, 40, "resnet"),
    "train_step_overflow": (32, True, 150, "resnet"),
    "train_step_mit": (16, True, 40, "mit"),
}
# The CE's kernels and the gather of their tables: the share of a train
# step's device time that a train configuration's line reports.
CE_EVENTS = r"\bce_\w*kernel|live_rows_kernel"
# (batch, bf16, folded, top_k, candidate slots or None for the full table);
# folded "fused": predict_topk_fused over the full table, all classes live
CONFIGS = {
    "bench_folded": (128, True, True, 5, 384),
    "bench_unfolded": (128, True, False, 5, 384),
    "serve_fp32": (8, False, True, 1, None),
    "serve_bf16": (8, True, True, 1, None),
    "serve_fp32_default": (8, False, False, 1, None),
    "serve_fp32_fused": (8, False, "fused", 1, None),
}
NUM_CLASSES = 512
RES = 256
# class_presence's label counts: the bench shape, the flagship step's
# contrast set, the fp32 step's and validation's candidate mask (its
# build_candidate_mask call at batch 8 is ``candidate_mask``)
PRESENCE_LABELS = {"presence_bench": 128 * RES * RES,
                   "presence_2m": 32 * RES * RES,
                   "presence_1m": 16 * RES * RES,
                   "presence_512k": 8 * RES * RES,
                   "candidate_mask": 8 * RES * RES}
KERNEL_CONFIGS = ("ce_forward", "ce_forward_all", "ce_backward",
                  "tv_forward", "tv_loss", "tv_loss_fp32", "histogram",
                  "head_topk", "head_topk_fp32", "masked_pooling",
                  *PRESENCE_LABELS)


def busy_us(spans: List[tuple]) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


# The profiled window's host range: device events count from its start.
WINDOW = "rangeclip::profiled_calls"


def window_events(traced) -> Tuple[object, List[object], List[object]]:
    """(the window's host range, the runtime calls made from its start,
    the device events those calls launched) of a trace of
    :func:`profile`'s form.  The device events are matched to the runtime
    calls by correlation id, so no alignment of the clocks is needed, and
    user annotations on the GPU timeline (the optimizer's
    "Optimizer.step#Adam.step" range, the window's own), which enclose
    kernels and would count them twice, are left out."""
    window = next(e for e in traced if e.name == WINDOW
                  and e.device_type == DeviceType.CPU)
    runtime = [e for e in traced if e.device_type == DeviceType.CPU
               and e.name.startswith("cu")
               and e.time_range.start >= window.time_range.start]
    ids = {e.id for e in runtime}
    events = [e for e in traced if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.id in ids]
    return window, runtime, events


def profile(fn: Callable[[], object], calls: int = 3, warmup: int = 2,
            record_shapes: bool = False) -> Dict[str, object]:
    """Time ``calls`` calls of ``fn`` by the host clock, then profile as
    many, after ``warmup`` unprofiled ones; times are ms per call.  The
    tracer's start can lose device events (6 of 20 kernels once), so it
    first traces as many calls again, then idles 1 ms, and counts only the
    device events of the runtime calls (launches, copies, memsets, graphs)
    that the profiled calls' host range made, matched by correlation id.  A
    trace that misses the kernel of a launch in that range (19 of 20 once,
    on an H100 80GB HBM3 at 700 W) is taken again, up to five traces in
    all, and ``traces`` says how many were taken; when all five miss one it
    raises.  ``record_shapes`` records the operators' input shapes (for
    ``utils/roofline.records_from_profile``); ``profiler`` in the result is
    the trace the figures come from."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    for traces in range(1, 6):
        with torch.profiler.profile(activities=activities,
                                    record_shapes=record_shapes) as prof:
            for _ in range(calls):  # the tracer's start: not counted
                fn()
            torch.cuda.synchronize()
            time.sleep(1e-3)
            with torch.profiler.record_function(WINDOW):
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        traced = prof.events()
        window, runtime, events = window_events(traced)
        launched = {e.id for e in runtime if "LaunchKernel" in e.name}
        if events and launched <= {e.id for e in events}:
            break
    else:
        raise RuntimeError("the profiler missed the device events of the "
                           "window's launches in five traces")
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in events])
    # host operators by their own CPU time, in the window
    host_us, host_n = collections.Counter(), collections.Counter()
    for e in traced:
        if (e.device_type == DeviceType.CPU and e.name != WINDOW
                and e.time_range.start >= window.time_range.start):
            host_us[e.name] += e.self_cpu_time_total
            host_n[e.name] += 1
    return {
        "traces": traces,
        "host_ms": host_ms,
        "wall_ms": wall_us / calls / 1e3,
        "device_ms": sum(by_name.values()) / calls / 1e3,
        "device_events": len(events) / calls,
        "busy_ms": busy / calls / 1e3,
        "busy_share": busy / wall_us,
        "events": [(name, us / calls / 1e3)
                   for name, us in by_name.most_common()],
        # (name, ms, count) per call
        "host_events": [(name, us / calls / 1e3, host_n[name] / calls)
                        for name, us in host_us.most_common()],
        "profiler": prof,
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
    if folded == "fused":
        from rangeclip_tpu_torch.models.depth_unet import predict_topk_fused

        every = torch.ones(NUM_CLASSES, dtype=torch.bool, device=device)
        run = lambda: predict_topk_fused(  # noqa: E731
            model, depth, text, every, top_k)
    elif slots is None:
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


def kernel_call(config: str) -> Callable[[], torch.Tensor]:
    """One operator call at its main path's shape, on the GPU: the fp32
    CE forward of validation (N = 8 x 128 x 128 pixel rows, D = 512, C =
    512, 4 label slots, 90 or all classes members) or its backward (90
    members), the TV forward of the flagship train step (bf16 [32, 128,
    128, 512], upsample 2, one sample weight 0), the flagship step's
    histogram (32 x 45,875 draws into 65,536 bins), class_presence with a
    validity vector at :data:`PRESENCE_LABELS` (labels 0..39, C = 512),
    validation's build_candidate_mask at batch 8 (50 negatives), the
    opt-in TV loss's forward and backward on the flagship train field (bf16
    ``tv_loss``, or the same shape in f32 ``tv_loss_fp32``),
    fused_head_score_topk at the bench shape (bf16 features [128, 128, 128,
    32], D = C = 512, 340 classes live, top-5) or at the serve shape (f32
    features [8, 128, 128, 32], D = C = 512 all live, top-1), or
    fused_masked_pooling on the flagship train field (bf16 [32 * 128 * 128,
    512], labels 0..39 with every 101st -1, 256 ids 0..255)."""
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    if config == "histogram":
        from rangeclip_tpu_torch.losses.infonce import n_draws
        from rangeclip_tpu_torch.ops.kernels.histogram import histogram

        idx = torch.randint(0, RES * RES, (32, n_draws(RES, RES)),
                            device=device, generator=gen, dtype=torch.int32)
        return lambda: histogram(idx, RES * RES)
    if config in PRESENCE_LABELS:
        from rangeclip_tpu_torch.models.depth_unet import build_candidate_mask
        from rangeclip_tpu_torch.ops.kernels.class_presence import (
            class_presence,
        )

        n = PRESENCE_LABELS[config]
        labels = torch.randint(0, 40, (n,), device=device, generator=gen,
                               dtype=torch.int32)
        if config == "candidate_mask":
            seg = labels.reshape(-1, RES, RES)
            gumbel = torch.rand(NUM_CLASSES, device=device, generator=gen)
            return lambda: build_candidate_mask(seg, NUM_CLASSES, 50,
                                                gumbel=gumbel)
        valid = (torch.rand(n, device=device, generator=gen) > 0.1).float()
        return lambda: class_presence(labels, valid, NUM_CLASSES)
    if config == "masked_pooling":
        from rangeclip_tpu_torch.ops.kernels.masked_pooling import (
            fused_masked_pooling,
        )

        emb = torch.randn(32 * 128 * 128, 512, device=device,
                          generator=gen).to(torch.bfloat16)
        labels = torch.randint(0, 40, (emb.shape[0],), device=device,
                               generator=gen, dtype=torch.int32)
        labels[::101] = -1
        obj = torch.arange(256, device=device, dtype=torch.int32)
        return lambda: fused_masked_pooling(emb, labels, obj)
    if config in ("head_topk", "head_topk_fp32"):
        from rangeclip_tpu_torch.ops.kernels.head_topk import (
            fused_head_score_topk,
        )
        from rangeclip_tpu_torch.utils.math import l2_normalize

        if config == "head_topk_fp32":
            feats = torch.randn(8, RES // 2, RES // 2, 32, device=device,
                                generator=gen)
            rows = torch.randn(9 * 32, 512, device=device, generator=gen) / 17
            table = l2_normalize(torch.randn(NUM_CLASSES, 512, device=device,
                                             generator=gen), dim=-1)
            every = torch.ones(NUM_CLASSES, dtype=torch.bool, device=device)
            return lambda: fused_head_score_topk(feats, rows, table, every, 1)
        feats = torch.randn(128, RES // 2, RES // 2, 32, device=device,
                            generator=gen).to(torch.bfloat16)
        rows = torch.randn(9 * 32, 512, device=device, generator=gen) / 17
        table = l2_normalize(torch.randn(NUM_CLASSES, 512, device=device,
                                         generator=gen), dim=-1)
        mask = torch.zeros(NUM_CLASSES, dtype=torch.bool, device=device)
        mask[torch.randperm(NUM_CLASSES, device=device,
                            generator=gen)[:340]] = True
        return lambda: fused_head_score_topk(feats, rows, table, mask, 5)
    if config in ("tv_loss", "tv_loss_fp32"):
        from rangeclip_tpu_torch.ops.kernels.tv_loss import (
            tv_loss_backward_op,
            tv_loss_op,
        )

        x = torch.randn(32, 128, 128, 512, device=device, generator=gen)
        if config == "tv_loss":
            x = x.to(torch.bfloat16)
        g = torch.tensor(1.0, device=device)

        def call():
            tv_loss_op(x, 512)
            return tv_loss_backward_op(x, g, 512)

        return call
    if config == "tv_forward":
        from rangeclip_tpu_torch.ops.kernels.tv_rowtile import tv_rowtile_op

        x = torch.randn(32, 128, 128, 512, device=device,
                        generator=gen).to(torch.bfloat16)
        w = torch.ones(32, device=device)
        w[-1] = 0.0
        return lambda: tv_rowtile_op(x, w, 2)
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import (
        ce_operands,
        pixel_text_ce_backward_op,
        pixel_text_ce_op,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    n, d = 8 * 128 * 128, 512
    members = NUM_CLASSES if config == "ce_forward_all" else 90
    samples = torch.randn(n, d, device=device, generator=gen)
    table = l2_normalize(torch.randn(NUM_CLASSES, d, device=device,
                                     generator=gen), dim=-1)
    ids = torch.randperm(NUM_CLASSES, device=device, generator=gen)[:members]
    mask = torch.zeros(NUM_CLASSES, dtype=torch.bool, device=device)
    mask[ids] = True
    labels = ids.sort().values.int()[torch.randint(
        0, members, (4, n), device=device, generator=gen)]
    valid = torch.randint(0, 3, (4, n), device=device, generator=gen).float()
    temp = torch.tensor(0.07, device=device)
    flat, lab, val, msk, *_ = ce_operands(samples, temp, labels, valid,
                                          table, mask, None)
    args = (flat, temp, lab, val, table, msk, None, None, None, None)
    if config == "ce_backward":
        grad = torch.tensor(1.0 / n, device=device)
        stats = pixel_text_ce_op(*args)[1]
        return lambda: pixel_text_ce_backward_op(grad, stats, *args)
    return lambda: pixel_text_ce_op(*args)


def train_setup(device: torch.device, batch: int = 32, bf16: bool = True,
                present: int = 40, seed: int = 0, accum: int = 1,
                res: int = RES, num_classes: int = NUM_CLASSES,
                unet_type: str = "resnet", pixel_sampler: str = "auto",
                norm: str = "batch"):
    """The flagship train configuration at full width (accumulation 1 at
    256^2, C = 512; ``accum``, ``res``, ``num_classes``, ``unet_type`` and
    ``norm``, 'batch' or 'instance' (``use_instance_norm``), change it)
    with random weights and data from ``seed``: (state, batch
    dict with a leading accumulation axis, text table, medium matrix, hard
    matrix, step function).  The segmentation holds ``present`` labels: up
    to 78 (128 contrast members with the 50 distractors) the packed CE
    branch runs, beyond it the full-table one.  ``pixel_sampler`` is the
    loss's (``HybridLossConfig.pixel_sampler``)."""
    import numpy as np

    from rangeclip_tpu_torch.losses.hybrid import HybridLossConfig
    from rangeclip_tpu_torch.models.clip.crops import prepare_image_crops
    from rangeclip_tpu_torch.models.clip.provider import (
        HashImageEmbedder,
        HashTextEmbedder,
    )
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNetConfig,
        norm_fields,
    )
    from rangeclip_tpu_torch.training.state import create_train_state
    from rangeclip_tpu_torch.training.train_step import make_train_step

    cfg = DepthUNetConfig(unet_type=unet_type, **norm_fields(norm),
                          dtype=torch.bfloat16 if bf16 else None)
    state = create_train_state(cfg, device, 1e-4, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    shape = (accum, batch, res, res)
    seg = torch.randint(1, present + 1, shape, device=device, generator=gen,
                        dtype=torch.int32)
    images = torch.rand(accum * batch, res, res, 3, device=device,
                        generator=gen)
    box = [res // 16, res // 8, res * 25 // 32, res * 15 // 16]
    boxes = torch.tensor([box] * (accum * batch),
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
    step = make_train_step(HybridLossConfig(pixel_sampler=pixel_sampler),
                           accum)
    return state, data, text, medium, hard, step


def train_call(config: str) -> Callable[[], object]:
    """One train step of a configuration of TRAIN_CONFIGS per call, on the
    GPU."""
    from rangeclip_tpu_torch.cli.common import set_precision

    batch, bf16, present, unet_type = TRAIN_CONFIGS[config]
    set_precision(bf16)
    state, data, text, medium, hard, step = train_setup(
        torch.device("cuda"), batch=batch, bf16=bf16, present=present,
        unet_type=unet_type)

    def call():
        return step(state, data, (0, state.step), 1e-4, 0.0, 0.75, text,
                    medium, hard)

    return call


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", nargs="+",
                        choices=sorted(CONFIGS) + sorted(TRAIN_CONFIGS)
                        + list(KERNEL_CONFIGS),
                        default=["bench_unfolded"])
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--host", type=int, default=0,
                        help="also print this many host operators by their "
                             "own CPU time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: CUDA is not available")
    for config in args.config:
        call = (train_call(config) if config in TRAIN_CONFIGS
                else kernel_call(config) if config in KERNEL_CONFIGS
                else predict_call(config))
        result = profile(call, args.calls)
        print(f"{config} on {torch.cuda.get_device_name(0)}, {args.calls} "
              f"calls: host clock {result['host_ms']:.3f} ms/call unprofiled, "
              f"wall {result['wall_ms']:.3f} ms/call, device events "
              f"{result['device_ms']:.4f} ms/call "
              f"({result['device_events']:g} a call), busy "
              f"{result['busy_ms']:.3f} ms/call, busy share "
              f"{result['busy_share']:.3f}, {result['traces']} trace(s)",
              flush=True)
        if config in TRAIN_CONFIGS:
            ce_ms = sum(ms for name, ms in result["events"]
                        if re.search(CE_EVENTS, name))
            print(f"  CE kernels {ce_ms:.4f} ms/call, "
                  f"{ce_ms / result['device_ms']:.1%} of the device events",
                  flush=True)
        for name, ms in result["events"][:25]:
            print(f"  {ms:9.4f} ms  {ms / result['device_ms']:6.1%}  "
                  f"{name[:110]}", flush=True)
        for name, ms, count in result["host_events"][:args.host]:
            print(f"  host {ms:9.4f} ms  {count:7.1f} calls  {name[:90]}",
                  flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
