"""Benchmark CLI (``rangeclip_tpu/cli/benchmark.py``): throughput, the
robustness sweep, the host loader and a profile, on one GPU (``--device
cuda``, the default; ``--device cpu`` runs the kernels' plain versions and
measures the CPU, never the card).

``throughput`` times the 256^2 inference path (maps/s) at each
``--batch_sizes`` x precision through ``--predict_path`` (``auto`` folds as
``models/depth_unet.folded_is_profitable`` and ``fused_head_ok`` decide),
and the contrastive train step at each ``--train_configs`` ``AxB``
(accumulation x microbatch), with ``--with_image_tower`` also with the
window's ViT-B/32 image tower (random weights, real shapes) in the timed
loop.  Times are the best of ``--rounds``, the device synchronised.  FLOPs
are ``torch.utils.flop_counter``'s count over one call, the port's
operators counted by ``utils/roofline.OP_COSTS`` whether the kernel or its
plain version runs.  One JSON line per row:

  inference:  mode, precision, predict_path, batch, resolution,
              maps_per_sec, ms_per_batch, gflop_per_map, tflops, pct_peak,
              device
  train_step: mode, precision, pixel_sampler, image_tower, accum,
              microbatch, resolution, s_per_step, maps_per_sec,
              gflop_per_map, tflops, pct_peak, device

``pct_peak`` is against the card's peak for the precision
(``utils/roofline.PEAK_FLOPS``: bf16 989, f32 67 TFLOP/s), null on the
CPU; a row above 100 aborts the run (``bench.py``'s integrity gate).  The
JAX rows' ``hlo_gb_per_step`` and ``hlo_bytes_vs_hbm_pct`` read compiled
HLO, which the port does not have, so they are not printed; ``profile``
gives bytes per interval instead.  ``--pixel_sampler auto multinomial``
times each train config with each sampler (the histogram of uniform draws,
the multinomial counts by binomial splitting).

``robustness`` runs the brightness/saturation sweep (``benchmark/
robustness.py``) over the validation split: ``--subject depth`` with the
newest checkpoint of ``--checkpoint_dir`` (``training/checkpoint``; the
model's widths read from its weights) through ``DepthUNet.predict`` over
each batch's GT labels plus 20 distractors, ``--subject clipseg`` with HF
CLIPSeg from local files (``benchmark/clipseg.py``).

``loader`` measures the host data pipeline (decode + transform + batch):
the ``native-c++`` row (the C++ PNG decoder and transforms, ``native``;
``pil_files`` counts the PNGs the decoder handed to PIL), then the
``numpy`` row (``RANGECLIP_NATIVE=off``: PIL and numpy), as JAX prints
them.

``profile`` runs ``--steps`` calls of the predict or train program under
``torch.profiler`` (``utils/profiling.profile``: device events of the
window only), prints the ``--top`` device events by time, then the
interval table of ``utils/roofline`` over encoder, decoder, head/selection,
CE, TV, normalisation and other.  ``--trace_dir`` keeps the Chrome trace.
With ``--device cpu`` it reads the CPU operators' own time instead.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time
from typing import Callable, Dict, List, Optional

import torch

EMBEDDING_DIM = 512  # the JAX CLI's fixed D


def _sync(device: torch.device) -> Callable[[], None]:
    return ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))


def best_of(fn: Callable[[], object], rounds: int, iters: int,
            device: torch.device) -> float:
    """Seconds per call: the best of ``rounds`` runs of ``iters`` calls,
    each run ended by a device synchronise."""
    sync = _sync(device)
    best = float("inf")
    for _ in range(rounds):
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def count_flops(fn: Callable[[], object]) -> float:
    from rangeclip_tpu_torch.utils.roofline import flop_counter

    with flop_counter() as counter:
        fn()
    return float(counter.get_total_flops())


def device_peak(device: torch.device, bf16: bool) -> Optional[float]:
    """The card's FLOP/s peak for the precision; None off the card."""
    from rangeclip_tpu_torch.utils.roofline import PEAK_FLOPS

    if device.type != "cuda":
        return None
    return PEAK_FLOPS["bf16" if bf16 else "f32"]


def rate_fields(flops: float, seconds: float, maps: int,
                peak: Optional[float]) -> Dict:
    """gflop_per_map, tflops and pct_peak of ``flops`` done in ``seconds``
    over ``maps`` maps; aborts where the rate passes the peak."""
    rate = flops / seconds
    row = {"gflop_per_map": round(flops / maps / 1e9, 3),
           "tflops": round(rate / 1e12, 3),
           "pct_peak": None if peak is None else round(100 * rate / peak, 2)}
    if row["pct_peak"] is not None and row["pct_peak"] > 100:
        raise SystemExit(
            f"integrity gate: {row['tflops']} TFLOP/s implied, "
            f"{row['pct_peak']}% of the card's peak: the timing or the FLOP "
            "count is wrong")
    return row


def cmd_throughput(args) -> List[Dict]:
    from rangeclip_tpu_torch.cli.common import set_precision, use_folded
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        build_candidate_mask,
        predict_folded,
    )
    from rangeclip_tpu_torch.utils.device import (
        describe_device,
        resolve_device,
    )
    from rangeclip_tpu_torch.utils.profiling import train_setup

    device = resolve_device(args.device)
    name = describe_device(device)
    res, C, D = args.resolution, args.num_classes, EMBEDDING_DIM
    results = []
    for bf16 in ([False, True] if args.both_precisions else [args.bf16]):
        set_precision(bf16)
        precision = "bf16" if bf16 else "fp32"
        dtype = torch.bfloat16 if bf16 else torch.float32
        peak = device_peak(device, bf16)
        model = DepthUNet(
            DepthUNetConfig(unet_type=args.unet_architecture,
                            dtype=torch.bfloat16 if bf16 else None),
            device=device, generator=torch.Generator().manual_seed(0)).eval()
        for batch in args.batch_sizes:
            gen = torch.Generator(device=device).manual_seed(1)
            depth = torch.randn(batch, res, res, 1, device=device,
                                generator=gen)
            text = torch.randn(C, D, device=device, generator=gen)
            seg = torch.randint(0, 40, (batch, res, res), device=device,
                                generator=gen)
            cand = build_candidate_mask(
                seg, C, 300, generator=torch.Generator().manual_seed(3))
            folded = use_folded(args.predict_path, C, D, batch, dtype,
                                device)

            @torch.inference_mode()
            def predict():
                if folded:
                    return predict_folded(model, depth, text,
                                          candidate_mask=cand, top_k=5)
                return model.predict(depth, text, cand, 5,
                                     return_embeddings=False)[0]

            predict()
            flops = count_flops(predict)
            dt = best_of(predict, args.rounds, args.iters, device)
            results.append({
                "mode": "inference", "precision": precision,
                "predict_path": "folded" if folded else "default",
                "batch": batch, "resolution": res,
                "maps_per_sec": round(batch / dt, 2),
                "ms_per_batch": round(1e3 * dt, 3),
                **rate_fields(flops, dt, batch, peak), "device": name})
        del model

        for config, sampler in [(c, s) for c in args.train_configs
                                for s in args.pixel_sampler]:
            A, B = (int(v) for v in config.split("x"))
            state, data, text, medium, hard, step = train_setup(
                device, batch=B, bf16=bf16, accum=A, res=res, num_classes=C,
                unet_type=args.unet_architecture, pixel_sampler=sampler)
            tower_step = None
            if args.with_image_tower:
                from rangeclip_tpu_torch.models.clip.crops import (
                    prepare_image_crops,
                )
                from rangeclip_tpu_torch.models.clip.provider import (
                    get_image_provider,
                )

                # the window's tower call as the trainer dispatches it:
                # crops of the window's images, one call, device-resident
                tower = get_image_provider("random", dim=D, device=device)
                tgen = torch.Generator(device=device).manual_seed(9)
                images = torch.rand(A * B, res, res, 3, device=device,
                                    generator=tgen)
                xy = torch.randint(0, res // 2, (A * B, 2), device=device,
                                   generator=tgen)
                size = torch.randint(res // 16, res // 2, (A * B, 2),
                                     device=device, generator=tgen)
                boxes = torch.cat([xy, xy + size], dim=1).int()
                tower_step = lambda: tower(  # noqa: E731
                    prepare_image_crops(images, boxes)).reshape(A, B, -1)
            for use_tower in ([False, True] if tower_step else [False]):
                def run(_tower=use_tower):
                    batch_data = data
                    if _tower:
                        batch_data = dict(data,
                                          image_embeddings=tower_step())
                    return step(state, batch_data, (0, state.step), 1e-4,
                                0.25, 0.5, text, medium, hard)

                run()
                flops = count_flops(run)
                dt = best_of(run, args.rounds, max(args.iters // 4, 2),
                             device)
                results.append({
                    "mode": "train_step", "precision": precision,
                    "pixel_sampler": sampler, "image_tower": use_tower,
                    "accum": A, "microbatch": B, "resolution": res,
                    "s_per_step": round(dt, 5),
                    "maps_per_sec": round(A * B / dt, 2),
                    **rate_fields(flops, dt, A * B, peak), "device": name})
            del state, step
    for row in results:
        print(json.dumps(row), flush=True)
    return results


def cmd_robustness(args) -> List[Dict]:
    import numpy as np

    from rangeclip_tpu_torch.benchmark.robustness import (
        format_results_table,
        robustness_sweep,
    )
    from rangeclip_tpu_torch.data.labels import (
        build_equivalence_class_map,
        build_equivalence_tensor,
        load_equivalence_dict,
    )
    from rangeclip_tpu_torch.data.loader import setup_dataloaders
    from rangeclip_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    _, val_loader, _, _, labels = setup_dataloaders(
        args.labeled_metadata_path, args.labels_path,
        (args.n_height, args.n_width), args.batch_size, n_epoch=1)
    num_classes = len(labels)
    eq = build_equivalence_tensor(
        load_equivalence_dict(args.equivalence_dict_path), num_classes)
    eq_map = build_equivalence_class_map(eq)

    if args.subject == "clipseg":
        # the reference's own subject (segclip.py:342-344): HF CLIPSeg
        # scoring each sample's GT + distractor prompts on the perturbed
        # RGB; BASELINE.md's rows with CIDAS/clipseg-rd64-refined's weights
        from rangeclip_tpu_torch.benchmark.clipseg import (
            hf_clipseg_logits_fn,
            make_clipseg_predict_fn,
        )

        predict_fn = make_clipseg_predict_fn(
            hf_clipseg_logits_fn(args.clipseg_path, device=device), labels,
            num_distractors=20)
    else:
        if not args.checkpoint_dir:
            raise SystemExit("--subject depth requires --checkpoint_dir")
        from rangeclip_tpu_torch.cli.common import label_table, set_precision
        from rangeclip_tpu_torch.models.depth_unet import (
            DepthUNet,
            DepthUNetConfig,
            build_candidate_mask,
        )
        from rangeclip_tpu_torch.models.interop import (
            load_reference_pth,
            widths_from_state_dict,
        )
        from rangeclip_tpu_torch.training.checkpoint import (
            CheckpointManager,
        )

        set_precision(False)
        manager = CheckpointManager(args.checkpoint_dir)
        step = manager.latest_step()
        if step is None:
            raise SystemExit(f"no checkpoint in {args.checkpoint_dir}")
        state_dict = load_reference_pth(manager.model_path(step))
        widths = widths_from_state_dict(state_dict)
        if args.embedding_dim not in (None, widths["embedding_dim"]):
            raise SystemExit(
                f"--embedding_dim {args.embedding_dim} does not match the "
                f"checkpoint's {widths['embedding_dim']}")
        model = DepthUNet(DepthUNetConfig(**widths), device=device)
        model.load_state_dict(state_dict, strict=True)
        model.eval()
        # the text provider must match training: a real-CLIP checkpoint
        # scored against the hash stub gives near-random rows that look
        # like a valid sweep
        table = label_table(args, labels, device, widths["embedding_dim"])

        def predict_fn(generator, batch, _enhanced_image):
            seg = torch.from_numpy(np.asarray(batch["segmentation"])).to(
                device)
            cand = build_candidate_mask(seg, num_classes, 20,
                                        generator=generator)
            depth = torch.from_numpy(np.asarray(batch["depth"])).to(device)
            return model.predict(depth, table, cand, 5,
                                 return_embeddings=False)[0]

    results = robustness_sweep(
        lambda: val_loader, predict_fn, eq, eq_map, num_classes,
        brightness_levels=args.brightness_levels,
        saturation_levels=args.saturation_levels)
    print(format_results_table(results))
    if args.plot_out:
        from rangeclip_tpu_torch.benchmark.robustness import plot_results

        print(f"Plot: {plot_results(results, args.plot_out)}")
    return results


def cmd_loader(args) -> List[Dict]:
    """Host data-pipeline throughput: decode + transform + batch, through
    the native C++ path, then through numpy and PIL."""
    from rangeclip_tpu_torch import native
    from rangeclip_tpu_torch.data.loader import setup_dataloaders

    def run(path: str) -> Dict:
        train_loader, _, _, _, _ = setup_dataloaders(
            args.labeled_metadata_path, args.labels_path,
            (args.n_height, args.n_width), args.batch_size, n_epoch=1)
        train_loader.num_workers = args.num_workers
        native.pil_fallbacks.reset()
        n_maps = 0
        t0 = time.perf_counter()
        for batch in train_loader:
            n_maps += int(batch["sample_valid"].sum())
        dt = time.perf_counter() - t0
        row = {"mode": "loader", "path": path, "workers": args.num_workers,
               "resolution": f"{args.n_height}x{args.n_width}",
               "maps_per_sec": round(n_maps / dt, 2)}
        if path == "native-c++":
            row["pil_files"] = native.pil_fallbacks.value
        print(json.dumps(row), flush=True)
        return row

    rows = []
    if native.lib() is not None:  # raises if the library cannot be built
        rows.append(run("native-c++"))
    saved = os.environ.get("RANGECLIP_NATIVE")
    os.environ["RANGECLIP_NATIVE"] = "off"
    try:
        rows.append(run("numpy"))
    finally:
        if saved is None:
            del os.environ["RANGECLIP_NATIVE"]
        else:
            os.environ["RANGECLIP_NATIVE"] = saved
    return rows


def cpu_profile(fn: Callable[[], object], calls: int):
    """``torch.profiler`` (CPU activity, shapes recorded) over ``calls``
    calls of ``fn`` inside ``utils/profiling``'s window range, after one
    unprofiled call."""
    from rangeclip_tpu_torch.utils.profiling import WINDOW

    fn()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        with torch.profiler.record_function(WINDOW):
            for _ in range(calls):
                fn()
    return prof


def cmd_profile(args) -> Dict:
    from rangeclip_tpu_torch.cli.common import set_precision
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        build_candidate_indices,
        folded_is_profitable,
        fused_head_ok,
        predict_folded,
    )
    from rangeclip_tpu_torch.utils import roofline
    from rangeclip_tpu_torch.utils.device import (
        describe_device,
        resolve_device,
    )
    from rangeclip_tpu_torch.utils.profiling import profile, train_setup

    device = resolve_device(args.device)
    set_precision(args.bf16)
    res, C, D = args.resolution, args.num_classes, EMBEDDING_DIM
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.mode == "predict":
        B = args.batch_size or 128
        model = DepthUNet(
            DepthUNetConfig(unet_type=args.unet_architecture,
                            dtype=torch.bfloat16 if args.bf16 else None),
            device=device, generator=torch.Generator().manual_seed(1)).eval()
        gen = torch.Generator(device=device).manual_seed(0)
        depth = torch.randn(B, res, res, 1, device=device, generator=gen)
        text = torch.randn(C, D, device=device, generator=gen)
        seg = torch.randint(0, 40, (B, res, res), device=device,
                            generator=gen)
        cand = build_candidate_indices(
            seg, C, 300, 384, generator=torch.Generator().manual_seed(4))
        folded = args.predict_path == "folded" or (
            args.predict_path == "auto" and folded_is_profitable(
                384, D, fused_ok=fused_head_ok(B, 384, dtype, device)))

        @torch.inference_mode()
        def fn():
            # what is not the encoder's or the decoder's is the head's
            with torch.profiler.record_function("head"):
                if folded:
                    return predict_folded(model, depth, text, top_k=5,
                                          candidate_indices=cand)
                return model.predict(depth, text, None, 5,
                                     return_embeddings=False,
                                     candidate_indices=cand)[0]
    else:
        B = args.batch_size or 32
        state, data, text, medium, hard, step = train_setup(
            device, batch=B, bf16=args.bf16, accum=args.accumulation_steps,
            res=res, num_classes=C, unet_type=args.unet_architecture)
        model = state.model

        def fn():
            return step(state, data, (0, state.step), 1e-4, 0.25, 0.5, text,
                        medium, hard)

    with roofline.CostRecorder() as recorder:  # one call: the op costs
        fn()
    with roofline.label_modules({"encoder": model.encoder,
                                 "decoder": model.decoder}):
        if device.type == "cuda":
            result = profile(fn, calls=args.steps, record_shapes=True)
            prof, window_ms = result["profiler"], result["device_ms"]
        else:
            prof, window_ms = cpu_profile(fn, args.steps), None
    trace_rows, instrs = roofline.records_from_profile(
        prof, calls=args.steps, op_costs=recorder.costs, device=device.type)
    total_ms = sum(ms for _, ms, _ in trace_rows)
    kind = "device" if device.type == "cuda" else "CPU operator"
    print(f"# {args.mode} on {describe_device(device)}, "
          f"{'bf16' if args.bf16 else 'fp32'}, batch {B}, {res}^2, "
          f"C={C}: {kind} time {total_ms:.4f} ms per step over "
          f"{args.steps} steps, {len(trace_rows) / args.steps:g} events a "
          "step")
    by_name = collections.Counter()
    for key, ms, _ in trace_rows:
        by_name[key.rsplit("#", 1)[0]] += ms
    for name, ms in by_name.most_common(args.top):
        print(f"  {ms:9.4f} ms  {ms / total_ms:6.1%}  {name[:110]}")
    rows = roofline.roofline_rows(
        trace_rows, instrs, roofline.PEAK_FLOPS["bf16" if args.bf16
                                                else "f32"],
        roofline.PEAK_BYTES_PER_S)
    buckets = roofline.bucket_rows(rows, roofline.BUCKETS)
    print(roofline.format_interval_table(buckets, total_ms))
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, f"{args.mode}.json")
        prof.export_chrome_trace(path)
        print(f"# raw trace: {path}")
    return {"total_ms": total_ms, "window_ms": window_ms,
            "buckets": buckets, "events": by_name.most_common(args.top)}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("throughput")
    t.add_argument("--resolution", type=int, default=256)
    t.add_argument("--unet_architecture", choices=["resnet", "mit"],
                   default="resnet")
    t.add_argument("--batch_sizes", nargs="*", type=int, default=[1, 8, 32])
    t.add_argument("--train_configs", nargs="*", default=["8x4"],
                   metavar="AxB",
                   help="train-step configs as '<accum>x<microbatch>' "
                        "(e.g. 8x4 1x32), timed in one process")
    t.add_argument("--num_classes", type=int, default=512)
    t.add_argument("--predict_path", choices=("auto", "folded", "default"),
                   default="auto")
    t.add_argument("--iters", type=int, default=20)
    t.add_argument("--rounds", type=int, default=3)
    t.add_argument("--bf16", action="store_true")
    t.add_argument("--both_precisions", action="store_true")
    t.add_argument("--with_image_tower", action="store_true",
                   help="also time the train step with the window's "
                        "ViT-B/32 image tower (random weights, real "
                        "shapes) in the loop")
    t.add_argument("--pixel_sampler", nargs="+",
                   choices=["auto", "multinomial"], default=["auto"],
                   help="'auto': the histogram of uniform draws; "
                        "'multinomial': counts by binomial splitting; "
                        "each train config runs with each")
    t.set_defaults(fn=cmd_throughput)

    r = sub.add_parser("robustness")
    r.add_argument("--labeled_metadata_path", required=True)
    r.add_argument("--labels_path", required=True)
    r.add_argument("--equivalence_dict_path", required=True)
    r.add_argument("--subject", choices=["depth", "clipseg"], default="depth")
    r.add_argument("--checkpoint_dir", default=None,
                   help="required for --subject depth")
    r.add_argument("--clipseg_path", default="CIDAS/clipseg-rd64-refined",
                   help="local HF path (or cached id) for --subject clipseg")
    r.add_argument("--batch_size", type=int, default=8)
    r.add_argument("--n_height", type=int, default=224)
    r.add_argument("--n_width", type=int, default=224)
    r.add_argument("--embedding_dim", type=int, default=None,
                   help="the checkpoint's embedding dim (default: read "
                        "from the checkpoint)")
    r.add_argument("--clip_checkpoint_path", default=None,
                   help="CLIP weights for the text provider — must match "
                        "what the checkpoint was trained against")
    r.add_argument("--clip_vocab_path", default=None)
    r.add_argument("--clip_merges_path", default=None)
    r.add_argument("--brightness_levels", nargs="+", type=float,
                   default=[1.0, 0.5, 0.2, 0.1, 0.05, 0.02, 0.01])
    r.add_argument("--saturation_levels", nargs="+", type=float,
                   default=[1.0])
    r.add_argument("--plot_out", default=None,
                   help="write metric-vs-brightness curves to this PNG "
                        "(needs matplotlib)")
    r.set_defaults(fn=cmd_robustness)

    p = sub.add_parser("profile")
    p.add_argument("--mode", choices=("predict", "train"), default="predict")
    p.add_argument("--batch_size", type=int, default=None,
                   help="default: 128 for predict, 32 for train")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--num_classes", type=int, default=512)
    p.add_argument("--accumulation_steps", type=int, default=1)
    p.add_argument("--unet_architecture", choices=["resnet", "mit"],
                   default="resnet")
    p.add_argument("--predict_path", choices=("auto", "folded", "default"),
                   default="auto")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--trace_dir", default=None,
                   help="write the Chrome trace here")
    p.set_defaults(fn=cmd_profile)

    lo = sub.add_parser("loader")
    lo.add_argument("--labeled_metadata_path", required=True)
    lo.add_argument("--labels_path", required=True)
    lo.add_argument("--batch_size", type=int, default=16)
    lo.add_argument("--n_height", type=int, default=224)
    lo.add_argument("--n_width", type=int, default=224)
    lo.add_argument("--num_workers", type=int, default=4)
    lo.set_defaults(fn=cmd_loader)

    for command in (t, r, p):
        command.add_argument("--device", default="cuda",
                             help="cuda (the kernels) or cpu (their plain "
                                  "versions)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
