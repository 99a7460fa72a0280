"""Drive the PyTorch/CUDA port's inference and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py

Full width: the ResNet-18 UNet with embedding dim 512 and filters 32..512
at 256x256, a label table of C=512 (hash-stub text embeddings) and random
weights made from a seed, saved to and reloaded from a reference ``.pth``;
phase 11 adds the ViT-B/32 CLIP towers, the MiT UNet (stage widths
64..512) and the ResNet-50 UNet at the same widths.
Phases (any failure raises; nothing is caught):

1. Build the CUDA kernels from ``rangeclip_tpu_torch/csrc/``; print the
   registers, shared memory and spills (``ptxas -v``) of the sources with
   tensor-core kernels (pixel_text_topk's bf16 path, conv_score_topk,
   pixel_text_ce, pixel_text_ce_slots and head_topk's bf16 path) and with
   the redesigned CUDA-core ones (pixel_text_topk's fp32 path, pixel_text_ce's member-only forward and
   backward, the live_rows gather, tv_rowtile, head_topk's CUDA-core
   route, masked_pooling, tv_loss); require that the fp32 kernel's SASS
   holds no tensor-core instruction.
2. Hold each kernel against its plain PyTorch version at the shapes the
   main paths give it, and time both and, where one PyTorch call computes
   the same function, that call; each row's bound is the larger of its
   bytes over 3.35 TB/s and its operations over the peak rate of its input
   type (989 TFLOP/s bf16, 67 TFLOP/s f32), from the H100 SXM data sheet;
   a masked top-k counts only the classes that can win, a CE over the full
   table only its contrast members (a non-member's exp term is 0).  Beside
   the tensor-core kernels and the fp32 CUDA-core kernels of
   pixel_text_topk and pixel_text_ce, their product stage alone through
   cuBLAS (torch.matmul, TF32 off for f32; the CE's over its members, the
   backward's two products in f32) and cuDNN (F.conv2d) at their shapes,
   printed on a line of its own: a yardstick, not the same function.
   pixel_text_ce runs bf16 packed (its tensor-core kernels, also timed
   alone) at D = 512 and 768, bf16 over the full table (overflow, 200
   members) and fp32 with 90 and with all 512 classes members (its
   member-only kernels), then bf16 with 16 label slots at the MiT step's
   shape ([16, 64, 64, 512], 138 of 512 members, the flag at 0: the
   tensor-core pair past 4 slots, pixel_text_ce_slots.cu).  live_rows, the gather of those kernels' table,
   bit-equal to its plain version at the overflow branch's shape.
   tv_rowtile's forward is timed as the operator call and, read with
   torch.profiler, as its kernels alone, which must be its only device
   events.
   masked_pooling and tv_loss run on a bf16 field of the flagship train
   native shape [32, 128, 128, 512]; masked_pooling under uniform labels
   (its row), then under spatially coherent labels (8 Voronoi regions an
   image, all 256 ids present) and uniform labels over all 256 ids (every
   id in every chunk: its workspace's worst case), each exact in its
   counts, within 1e-5 of the summed magnitudes and bit-equal run to run,
   each timed against its plain version and index_add_; tv_loss on that
   field (its rows) and on its values in f32 (beside them in the rows),
   the forward bit-equal across two calls.
   head_topk's tensor-core route at the bench configuration, its CUDA-core
   route on the fp32 serve model's features at the serve shape (batch 8,
   C = 512 all live, top-1; then the bench candidate mask, 340 live, top-5,
   against its plain version too),
   each with its product stage alone (cuDNN's F.conv2d to D = 512 and
   cuBLAS over the live classes; TF32 off in f32).
   class_presence runs at the bench shape and at the main paths' label
   counts (2,097,152, 1,048,576, 524,288), with a validity vector and
   without (the labels-only route), and histogram at the flagship shape;
   each must be one device event a call.  Every row's ``ms`` is a
   CUDA-event loop of calls of the operator; beside it ``device_ms`` and
   ``device_events`` are its device time and events per call read with
   torch.profiler (for a call of a few microseconds the loop measures the
   host's launch rate, the device time the kernel), and ``device_traces``
   the traces the profiler took for them (more than 1 where a trace lost a
   launch's kernel).
3. Serve: the port's ``cli/serve`` engine and HTTP server in this process,
   four POSTed depth maps per configuration: default flags (fp32, batch 8,
   top-1, --predict_path auto: folded), --bf16, --predict_path default in
   fp32 and bf16, and --predict_path auto over a 1000-class label file
   (unfolded).  fp32 labels are checked against the same model on the CPU.
4. The bench configuration: bf16 batch 128 over 384 candidate slots drawn
   by build_candidate_indices, through predict_folded and through the
   unfolded DepthUNet.predict, each run twice with identical checksums;
   maps/s of both and their top-1 agreement.  Then predict_topk_fused over
   the full table under the bench candidate mask (head_topk's tensor-core
   kernel), its labels against DepthUNet.predict up to near-ties, and its
   maps/s; and the fp32 serve model through predict_topk_fused at the
   serve shape (batch 8, C = 512, top-1: the CUDA-core kernel), against
   its DepthUNet.predict up to near-ties.
5. cli/infer over 20 16-bit depth PNGs (batch 8, a padded tail,
   --predict_path default), and cli/export --predict_path default
   --text_as_input --verify, then the .pt2 loaded and run once.
6. Gradient: forward_native in bf16 at batch 8, then backward.  Then, on
   the flagship train batch (bf16, batch 32): masked_average_pooling over
   forward_native's field against its use_pallas='never' path, and
   forward_native + fused_tv_loss + backward.
7. Train: the flagship train step (bf16, accumulation 1 x batch 32 at
   256^2, C=512 with 40 labels present so the packed CE runs, the full
   hybrid loss with hash-stub image embeddings), 3 steps: finite losses,
   changed parameters, ms/step and maps/s.  Then cli/train's default
   precision at its microbatch (fp32, batch 16, 40 labels present: the
   member-only CE kernels over 90 members) and a bf16 batch-32 step whose
   contrast set overflows the capacity (150 labels present: 200 members),
   3 steps each, ms/step and their pixel_text_ce[bwd] launches.  Then the
   kernel step against the same step through the plain versions with the
   same draws, in fp32 at batch 8, in bf16 at batch 32, and in bf16 at
   batch 32 overflowing.
8. cli/train --bf16 on a synthetic 256^2 dataset: 2 optimizer steps of
   accumulation 8 x batch 4, validating at step 2 ([Val] lines and best
   results in its log); its checkpoint loads strictly and predicts.  Then
   cli/validate --baselines from that checkpoint (fp32, full width), and
   validation maps/s over 16 passes of its split after a warm one.  Then
   pixel_text_topk[fp32] at the validation pass's own shape: the candidate
   masks validate_model draws for the split, the model's field, top-5.
9. One val step of the flagship batch (bf16, batch 32) through the kernels,
   twice (identical metrics), and through the plain versions with the same
   draws: ids up to near-ties, metrics, loss parts within 2e-3 relative.
10. D % 8 != 0, which the wrappers zero-pad to a multiple of 8.  D = 100
   after the model, which takes only embedding_dim % 32 == 0 (GroupNorm(32),
   as in JAX): the flagship step's hybrid loss and its gradient on a random
   [32, 128, 128, 100] field in fp32 and bf16, and validation's scoring of
   8 maps, each against the plain versions, each launching the CE (the
   scoring the top-k) kernels.  Then the four padding wrappers
   (pixel_text_ce, pixel_text_topk, masked_pooling, tv_loss) at D = 20 and
   100 on main-path row counts, masked_pooling also at D = 2056 (two column
   chunks), each launching its kernel.

11. The modules of the frozen-encoder finetune, the CLIP towers and the
   other encoders, at full width (none of them holds a kernel; the paths
   they open run the kernels above).  (a) cli/train --bf16, accumulation
   1 x 32 at 256^2 on phase 8's dataset, 3 steps, with both CLIP towers
   converted from a random full-width ViT-B/32 checkpoint in HF's layout
   written as .safetensors, and a synthetic byte-level vocab.json /
   merges.txt: finite losses, the text tower called once per 128 labels,
   the image tower once per window; then the text precompute of the 512
   labels and the image tower on a window of 32 crops at 224^2, timed
   alone, the latter's device time beside that of phase 7's flagship step
   (torch.profiler, both).  (b) cli/train
   --restore_path_encoder from phase 8's checkpoint, 2 steps: every
   encoder parameter and BatchNorm statistic bit-equal to the restored
   ones, the decoder moved.  (c) cli/train --bf16 --unet_architecture mit,
   2 steps; the first step's CE operands (16 label slots on the H/4 field)
   recorded, and pixel_text_ce held on them, packed as the step passed
   them, with the flag set and over the full table, against its plain
   versions at phase 2's tolerances and timed, each form on the
   tensor-core pair past 4 slots alone (the step too: never the
   member-only kernels); its checkpoint through predict_folded at the
   bench configuration twice (identical checksums, maps/s),
   conv_score_topk on its features and folded head against its plain
   version, and its fp32 labels at batch 8 against the same model on the
   CPU up to near-ties.  (d) a ResNet-50 UNet (random weights from a seed)
   through the same but the CE.  (e)
   evaluate_mask_clip's prediction on one batch of the split at 224^2 with
   the random full-width vision tower: the card's ids against the CPU's up
   to near-ties, then the evaluator over that batch.

12. The measurement and evaluation tools, each through its entry point at
   full width: ``cli.benchmark throughput`` in fp32 and bf16 at batch 128,
   256^2, C = 512 through --predict_path auto and default, and a bf16 1 x
   32 train config with and without the ViT-B/32 image tower (every row's
   pct_peak in (0, 100], finite times); ``cli.benchmark profile`` of the
   predict and train programs with their interval tables, whose intervals
   must add up to the window's device time within 1%; ``cli.benchmark
   robustness --subject depth`` over phase 8's split and checkpoint at two
   brightness levels (finite rows, equal at both: the depth model never
   sees the RGB, and each batch's candidate draw is keyed by the seed and
   the batch); ``cli.convert`` from phase 8's checkpoint to a ``.pth`` and
   back, bit-equal; ``cli/train --profile_dir``, 4 steps, a Chrome trace
   holding kernel events.

13. The offline data-prep CLI, the native data path, the multinomial
   sampler and the block library (none holds a CUDA kernel): (a)
   ``cli.setup similarity-sets`` over the 512 labels with phase 11's
   ViT-B/32 checkpoint and vocabulary, ``--device cuda`` and then
   ``--device cpu``, timed: the same sets but for pairs within 1e-5 of a
   threshold; (b) the native library built from its sources (seconds
   logged), phase 8's PNGs decoded byte-identical to PIL, the native depth
   transform within one ulp of the numpy one; (c) ``cli.benchmark loader``
   over phase 8's split, its native-c++ and numpy rows; (d) every host
   subcommand of ``cli.setup`` on synthetic 480x640 fixtures (the h5py ones
   where h5py is installed), after which pandas must never have been
   imported; (e) the flagship bf16 train step with
   ``pixel_sampler="multinomial"``, 3 steps, finite, launching the CE, TV,
   l2_normalize and class_presence kernels and not the histogram, each
   image's counts summing to its draws, and the sampler's device time
   beside the histogram sampler's; (f) the ten library blocks in f32 on
   the card against the CPU at the UNet's widths, eval and train mode.

14. Multi-GPU on this one card (``parallel/``): (a) the class-sharded,
   data-parallel predict on grids naming the card several times, bf16 at
   the bench configuration over C = 512 (batch 256 on 2 x 2 and 128 on 1 x
   2 folded: the fused conv_score_topk in every cell; 128 on 2 x 2 folded:
   conv + score_topk[packed]; 256 on 2 x 2 default: pixel_text_topk[bf16])
   and f32 folded at the serve batch 8 on 2 x 1, each against
   single-device predict (f32 labels equal; bf16 labels equal or
   near-ties) with maps/s of both by the host clock; (b) two spawned gloo
   ranks on the card, each a full-width ddp_parity step in bf16 and f32,
   against the per-rank simulation in this process with the same draws,
   the ranks bit-equal; (c) cli/train --distributed --ddp_parity over NCCL
   at world 1 (torchrun's environment), 2 steps, bit-equal to --ddp_parity
   alone; (d) dryrun_multichip(4, backend="gloo") on JAX's dry-run layout
   of four devices, a 1 x 2 x 2 data x spatial x model grid (the global
   step with model-sharded class tables, the grid's predict against the
   data x model predict, the C = 2048 packed-CE step against its
   data-only run); (h) one spawn of four gloo ranks on the card for the
   'spatial' axis at full width, for the ResNet-18 UNet and the MiT
   (stage widths 64-512; its attention's K and V gathered over the row
   shards): the grid predict ('default', top-5, C = 512, batch 8 at
   256^2) in f32 and bf16 on 1 x 2 x 1 and 1 x 2 x 2 grids, each rank its
   block of rows (halo rows from its neighbour), against single-device
   predict (f32 labels equal but for near-ties within 1e-5 of the cosine;
   bf16 held as (a)); grid validation on 1 x 2 x 1 in f32 (two batches of
   8 images, 50 negatives) against single-device validate_model (held as
   (f)), the ranks' results equal; and the global-batch step on a 1 x 2 x
   1 grid, each rank 128 of the 256 rows of a 32-image batch, in bf16 and
   f32 against the single-device step, held as (e), the two ranks
   bit-equal.  Each rank must launch pixel_text_topk, validation's
   pixel_text_topk[fp32] and class_presence[labels], and the step's CE
   (the MiT's: in bf16 the tensor-core pair past 4 slots and never the
   member-only kernels, in f32 the member-only 16-slot instances),
   class_presence,
   histogram and (bf16) l2_normalize kernels, and not tv_rowtile (the
   plain TV with a halo row, as in JAX).

Each path of phases 3-8, of phase 11's (a)-(d), of phase 12, of phase 13's
(e) and of phase 14 runs with the launch counts set to 0 just before it and
read just after (phases 9-10 compare, and count nothing; phase 14's
spawned ranks each set and read their own, summed here); each must launch
the kernels it is built on, and every kernel must be launched by some
path.

The second-to-last line is a JSON object with each kernel's launches, error
against its plain version, times and device time; the last line names the
device.  The
script exits non-zero without printing them when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import dataclasses
import http.client
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from rangeclip_tpu_torch.utils.ce_rounding import bf16_ulp, within_bf16_ulp

SEED = 0
RES = 256
NUM_CLASSES = 512
BENCH_BATCH = 128
BENCH_SLOTS = 384
BENCH_NEGATIVES = 300
BENCH_TOP_K = 5
SERVE_BATCH = 8
LARGE_TABLE = 1000  # a label file that --predict_path auto does not fold
INFER_MAPS = 20
VAL_PASSES = 16  # timed passes over the 21-map synthetic val split

KERNEL_ROWS = {
    "score_topk[knockout]": ("rangeclip_tpu_torch/csrc/score_topk.cu",
                             "rangeclip_tpu/ops/pallas/score_topk.py:91"),
    "score_topk[packed]": ("rangeclip_tpu_torch/csrc/score_topk.cu",
                           "rangeclip_tpu/ops/pallas/score_topk.py:126"),
    "conv_score_topk": ("rangeclip_tpu_torch/csrc/conv_score_topk.cu",
                        "rangeclip_tpu/ops/pallas/conv_score_topk.py:60"),
    "class_presence": ("rangeclip_tpu_torch/csrc/class_presence.cu",
                       "rangeclip_tpu/ops/pallas/class_presence.py:21"),
    "class_presence[labels]": ("rangeclip_tpu_torch/csrc/class_presence.cu",
                               "rangeclip_tpu/ops/pallas/class_presence.py:21"),
    "pixel_text_topk[bf16]": ("rangeclip_tpu_torch/csrc/pixel_text_topk.cu",
                              "rangeclip_tpu/ops/pallas/pixel_text_topk.py:79"),
    "pixel_text_topk[fp32]": ("rangeclip_tpu_torch/csrc/pixel_text_topk.cu",
                              "rangeclip_tpu/ops/pallas/pixel_text_topk.py:79"),
    "l2_normalize[fwd]": ("rangeclip_tpu_torch/csrc/l2_normalize.cu",
                          "rangeclip_tpu/ops/pallas/l2_normalize.py:154"),
    "l2_normalize[bwd]": ("rangeclip_tpu_torch/csrc/l2_normalize.cu",
                          "rangeclip_tpu/ops/pallas/l2_normalize.py:164"),
    "histogram": ("rangeclip_tpu_torch/csrc/histogram.cu",
                  "rangeclip_tpu/ops/pallas/histogram.py:44"),
    # no TPU kernel of its own: the JAX package gathers the contrast
    # members in XLA (pack_contrast_set)
    "live_rows": ("rangeclip_tpu_torch/csrc/live_rows.cu",
                  "rangeclip_tpu/losses/infonce.py:311"),
    "pixel_text_ce[fwd]": ("rangeclip_tpu_torch/csrc/pixel_text_ce.cu",
                           "rangeclip_tpu/ops/pallas/pixel_text_ce.py:96"),
    "pixel_text_ce[bwd]": ("rangeclip_tpu_torch/csrc/pixel_text_ce.cu",
                           "rangeclip_tpu/ops/pallas/pixel_text_ce.py:124"),
    "pixel_text_ce_tc[fwd]": ("rangeclip_tpu_torch/csrc/pixel_text_ce.cu",
                              "rangeclip_tpu/ops/pallas/pixel_text_ce.py:96"),
    "pixel_text_ce_tc[bwd]": ("rangeclip_tpu_torch/csrc/pixel_text_ce.cu",
                              "rangeclip_tpu/ops/pallas/pixel_text_ce.py:124"),
    "pixel_text_ce_slots[fwd]": (
        "rangeclip_tpu_torch/csrc/pixel_text_ce_slots.cu",
        "rangeclip_tpu/ops/pallas/pixel_text_ce.py:96"),
    "pixel_text_ce_slots[bwd]": (
        "rangeclip_tpu_torch/csrc/pixel_text_ce_slots.cu",
        "rangeclip_tpu/ops/pallas/pixel_text_ce.py:124"),
    "tv_rowtile[fwd]": ("rangeclip_tpu_torch/csrc/tv_rowtile.cu",
                        "rangeclip_tpu/ops/pallas/tv_rowtile.py:100"),
    "tv_rowtile[bwd]": ("rangeclip_tpu_torch/csrc/tv_rowtile.cu",
                        "rangeclip_tpu/ops/pallas/tv_rowtile.py:131"),
    "masked_pooling": ("rangeclip_tpu_torch/csrc/masked_pooling.cu",
                       "rangeclip_tpu/ops/pallas/masked_pooling.py:26"),
    "head_topk[bf16]": ("rangeclip_tpu_torch/csrc/head_topk.cu",
                        "rangeclip_tpu/ops/pallas/head_topk.py:72"),
    "head_topk[fp32]": ("rangeclip_tpu_torch/csrc/head_topk.cu",
                        "rangeclip_tpu/ops/pallas/head_topk.py:72"),
    "tv_loss[fwd]": ("rangeclip_tpu_torch/csrc/tv_loss.cu",
                     "rangeclip_tpu/ops/pallas/tv_loss.py:35"),
    "tv_loss[bwd]": ("rangeclip_tpu_torch/csrc/tv_loss.cu",
                     "rangeclip_tpu/ops/pallas/tv_loss.py:55"),
}
TRAIN_KERNELS = ["histogram", "class_presence", "live_rows",
                 "pixel_text_ce[fwd]", "pixel_text_ce[bwd]",
                 "pixel_text_ce_tc[fwd]", "pixel_text_ce_tc[bwd]",
                 "tv_rowtile[fwd]", "tv_rowtile[bwd]", "l2_normalize[fwd]",
                 "l2_normalize[bwd]"]
TRAIN_BATCH = 32
TRAIN_PRESENT = 40  # labels in the segmentation: the packed CE branch
OVERFLOW_PRESENT = 150  # with 50 distractors past the capacity: full table
CLI_TRAIN_BATCH = 16  # cli/train's default --batch_size
POOL_OBJECTS = 256  # object ids of masked_average_pooling (masked_pooling.py:8)
VAL_KERNELS = ["pixel_text_topk[fp32]", "class_presence",
               "class_presence[labels]", "histogram",
               "live_rows", "pixel_text_ce[fwd]"]
CAPACITY = 128
# class_presence's label counts: the bench shape (128 x 256^2, the kernels
# line's row), then the flagship step's contrast set (32 x 256^2), the fp32
# step's (16 x 256^2) and validation's candidate mask (8 x 256^2)
PRESENCE_SHAPES = (BENCH_BATCH * RES * RES, 32 * RES * RES, 16 * RES * RES,
                   8 * RES * RES)
# phase 10's padded bf16 CE: d samples within this share of its norm, and
# at most ce_pad_rows(rows of exactly rounded logits) rows past the
# per-row check
CE_PAD_NORM = 2e-4


def ce_pad_rows(exact_rows: int) -> int:
    return 2 * exact_rows + 8
# Beside the tensor-core kernels and pixel_text_topk[fp32]: their product
# stage alone through cuBLAS / cuDNN at their shapes (ms), printed before
# the kernels line.
PRODUCT_ONLY_MS = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_pair(kernel, plain, iters: int, plain_iters: int):
    """(kernel ms, plain ms), timed in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, plain_iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_fields(fn, calls: int = 10) -> dict:
    """The kernels line's ``device_ms``, ``device_events`` and
    ``device_traces``: the device time and events per call of ``fn`` by
    torch.profiler, and the traces it took (more than 1 where one lost a
    launch's kernel), beside ``ms``, the CUDA-event loop of the same call
    (which for a call of a few microseconds measures the host's launch
    rate)."""
    from rangeclip_tpu_torch.utils.profiling import profile

    result = profile(fn, calls=calls)
    return {"device_ms": result["device_ms"],
            "device_events": result["device_events"],
            "device_traces": result["traces"]}


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of ``kind`` (the
    card's peaks: ``utils/roofline.py``)."""
    from rangeclip_tpu_torch.utils.roofline import (
        PEAK_BYTES_PER_S,
        PEAK_FLOPS,
    )

    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def check_exact(name, got, want) -> float:
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]), f"{name}: ids differ")
    require(torch.equal(got[1], want[1]), f"{name}: values differ")
    return max_abs_err(got[1], want[1])


def ptxas_summary(text: str):
    """One line per kernel entry of ``nvcc -Xptxas -v`` output: its
    registers, static shared memory and spills."""
    import re

    lines, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"([a-z_]+_kernel)I((?:Li\d+E|Lb[01]E|f|"
                          r"13__nv_bfloat16)+)E", name)
            if k:
                args = re.findall(r"Li(\d+)E|Lb([01])E|(f)|(13__nv_bfloat16)",
                                  k.group(2))
                name = k.group(1).lstrip("_") + "<" + ", ".join(
                    n or ("true" if b == "1" else "false") if n or b else
                    ("f32" if f else "bf16") for n, b, f, _ in args) + ">"
            else:  # a kernel that is no template: its bare name
                k = re.search(r"\d+([a-z_]+_kernel)E", name)
                name = k.group(1) if k else name
            spill = ""
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spill = (f"stack {m.group(1)} B, spill stores {m.group(2)} B, "
                     f"spill loads {m.group(3)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{name}: {m.group(1)} registers, static smem "
                         f"{smem.group(1) if smem else 0} B, {spill}")
            name = None
    return lines


def sass_counts(library_path, kernel: str) -> dict:
    """Per instance of ``kernel`` in the built library's SASS
    (``cuobjdump -sass``): its tensor-core instructions (HMMA, HGMMA, IMMA)
    and its FFMA count."""
    import re
    from pathlib import Path

    from rangeclip_tpu_torch.ops.kernels import _lib

    tool = Path(_lib._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name, text = body.split("\n", 1)
        if kernel in name:
            counts[name.strip()] = (
                len(re.findall(r"\b(?:HMMA|HGMMA|IMMA)\b", text)),
                len(re.findall(r"\bFFMA\b", text)))
    return counts


def phase_kernels(device, bench_model, bench_depth, text, cand, stats):
    from rangeclip_tpu_torch.ops.kernels.class_presence import (
        class_presence,
        class_presence_plain,
        launch_name,
    )
    from rangeclip_tpu_torch.ops.kernels.conv_score_topk import (
        conv_score_topk,
        conv_score_topk_plain,
    )
    from rangeclip_tpu_torch.ops.kernels.score_topk import (
        score_topk,
        score_topk_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 1)

    # score_topk at the serve shape: N = 8 * 128 * 128 pixels, S = 512
    N, S = SERVE_BATCH * (RES // 2) ** 2, NUM_CLASSES
    field = torch.randn(N, S, device=device, generator=gen)
    ids = torch.arange(S, dtype=torch.int32, device=device)
    for dtype, selector in ((torch.float32, "knockout"),
                            (torch.bfloat16, "packed")):
        name = f"score_topk[{selector}]"
        scores = field.to(dtype)
        packed = selector == "packed"
        err = 0.0
        for k in (1, 5):
            got = score_topk(scores, ids, k, True, selector, max_id=S - 1)
            want = score_topk_plain(scores, ids, k, packed)
            err = max(err, check_exact(f"{name} k={k}", got, want))
            ms, plain_ms = time_pair(
                lambda: score_topk(scores, ids, k, False, selector,
                                   max_id=S - 1),
                lambda: score_topk_plain(scores, ids, k, packed), 20, 3)
            log(f"  {name} N={N} S={S} k={k} {dtype}: bit-equal; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
            if k == 1:  # the serve path's k
                library_ms = cuda_ms(lambda: torch.topk(scores, 1, dim=1),
                                     20)
                stats[name] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms,
                    **bound(scores.numel() * scores.element_size() + N * 4,
                            0, "f32"),
                    **device_fields(lambda: score_topk(
                        scores, ids, k, False, selector, max_id=S - 1)))
                log(f"  {name}: torch.topk k=1 {library_ms:.4f} ms")
        stats[name]["max_abs_err"] = err
    del field

    # class_presence at the bench shape (N = 128 * 256^2 labels, C = 512)
    # and at the main paths' shapes: the flagship step's contrast set (32 *
    # 256^2), the fp32 step's (16 * 256^2) and validation's candidate mask
    # (8 * 256^2); with a validity vector, and without (every label valid:
    # the candidate mask's route, the labels only)
    for n in PRESENCE_SHAPES:
        labels = torch.randint(0, 40, (n,), device=device, generator=gen,
                               dtype=torch.int32)
        labels[::977] = torch.randint(-5, NUM_CLASSES + 5, labels[::977].shape,
                                      device=device, generator=gen,
                                      dtype=torch.int32)
        valid = (torch.rand(labels.shape, device=device, generator=gen)
                 > 0.1).float()
        for v in (valid, None):
            name = launch_name(v)
            got = class_presence(labels, v, NUM_CLASSES)
            want = class_presence_plain(labels, v, NUM_CLASSES)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"{name} N={n} differs")
            ms, plain_ms = time_pair(
                lambda: class_presence(labels, v, NUM_CLASSES),
                lambda: class_presence_plain(labels, v, NUM_CLASSES), 50, 5)
            row = dict(
                max_abs_err=max_abs_err(got.int(), want.int()), ms=ms,
                plain_ms=plain_ms, library_ms=None,
                **bound(n * (4 if v is None else 8) + NUM_CLASSES, 0, "f32"),
                **device_fields(
                    lambda: class_presence(labels, v, NUM_CLASSES), 20))
            events, dev_ms = row["device_events"], row["device_ms"]
            require(events == 1, f"{name}: {events} device events a call")
            log(f"  {name} N={n} C={NUM_CLASSES}: bit-equal "
                f"({int(got.sum())} present), {events:g} device event a "
                f"call; kernel {ms:.4f} ms a call in a loop of calls (CUDA "
                f"events), {dev_ms:.4f} ms device time (torch.profiler), "
                f"plain {plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_ms'] / dev_ms:.0%} of the device time)")
            if n == PRESENCE_SHAPES[0]:  # the kernels line: the bench shape
                stats[name] = row
    del labels, valid

    # conv_score_topk at the bench shape: B=128, h=w=128, C_in=32, S=384
    B, h, w, c_in = BENCH_BATCH, RES // 2, RES // 2, 32
    q = lambda *shape: (torch.randint(-8, 9, shape, device=device,
                                      generator=gen) / 4).to(torch.bfloat16)
    feats, rows = q(B, h, w, c_in), q(BENCH_SLOTS, 9 * c_in)
    slot_ids = cand.to(torch.int32)
    got = conv_score_topk(feats, rows, slot_ids, BENCH_TOP_K, True)
    want = conv_score_topk_plain(feats, rows, slot_ids, BENCH_TOP_K)
    err = check_exact("conv_score_topk (quantised inputs)", got, want)
    log(f"  conv_score_topk B={B} h=w={h} C_in={c_in} S={BENCH_SLOTS} "
        f"k={BENCH_TOP_K}, quantised-exact inputs: bit-equal")
    # real features: the bench model's pre-head features and folded head
    feats, rows, real_err = hold_conv_score_topk(
        "decoder features", bench_model, bench_depth, text, cand)
    err = max(err, real_err)
    ms, plain_ms = time_pair(
        lambda: conv_score_topk(feats, rows, slot_ids, BENCH_TOP_K),
        lambda: conv_score_topk_plain(feats, rows, slot_ids, BENCH_TOP_K),
        5, 2)
    log(f"  conv_score_topk: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    # the product stage alone through cuDNN: the bf16 SAME conv of the
    # features (channels_last) with the folded weights (a yardstick)
    x_nchw = feats.permute(0, 3, 1, 2)
    w_conv = rows.reshape(BENCH_SLOTS, 3, 3, c_in).permute(0, 3, 1, 2).to(
        memory_format=torch.channels_last)
    product_ms = cuda_ms(
        lambda: torch.nn.functional.conv2d(x_nchw, w_conv, padding=1), 5)
    PRODUCT_ONLY_MS["conv_score_topk"] = product_ms
    log(f"  conv_score_topk, product only (cuDNN F.conv2d bf16 [{B}, {c_in}, "
        f"{h}, {w}] * [{BENCH_SLOTS}, {c_in}, 3, 3]): {product_ms:.4f} ms")
    n_pix = B * h * w
    n_live = int((slot_ids >= 0).sum())  # the slots that can win
    stats["conv_score_topk"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(feats.numel() * 2 + n_live * 9 * c_in * 2
                + n_pix * BENCH_TOP_K * 4,
                2.0 * n_pix * 9 * c_in * n_live, "bf16"),
        **device_fields(lambda: conv_score_topk(feats, rows, slot_ids,
                                                BENCH_TOP_K)))


def hold_conv_score_topk(name, model, depth, text, cand):
    """conv_score_topk on a bf16 model's pre-head features and its head
    folded with the candidates' rows (as predict_folded folds it) against
    its plain version: ids agree at >= 0.999 and every mismatch is a tie
    within one bf16 ulp.  Returns (features, rows, largest value error)."""
    from rangeclip_tpu_torch.ops.kernels.conv_score_topk import (
        conv_score_topk,
        conv_score_topk_plain,
        fold_to_rows,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    slot_ids = cand.to(torch.int32)
    with torch.inference_mode():
        feats = model.decode_features(depth).contiguous()
        table = l2_normalize(text[cand.clamp_min(0).long()].float(), dim=-1)
        W = model.decoder.output_conv.conv.weight.float()
        rows = fold_to_rows(torch.einsum("diyx,sd->siyx", W, table).to(
            torch.bfloat16))
    got = conv_score_topk(feats, rows, slot_ids, BENCH_TOP_K, True)
    want = conv_score_topk_plain(feats, rows, slot_ids, BENCH_TOP_K)
    torch.cuda.synchronize()
    agree = got[0] == want[0]
    rate = float(agree.float().mean())
    v_got, v_want = got[1][~agree], want[1][~agree]
    ulp = bf16_ulp(torch.maximum(v_got.abs(), v_want.abs()))
    ties = bool(((v_got - v_want).abs() <= ulp).all())
    log(f"  conv_score_topk, {name} (bf16 {list(feats.shape)}, "
        f"{rows.shape[0]} slots): id agreement {rate:.6f}, "
        f"{int((~agree).sum())} mismatches, all within one bf16 ulp: {ties}")
    require(rate >= 0.999,
            f"conv_score_topk {name}: id agreement {rate} < 0.999")
    require(ties, f"conv_score_topk {name}: mismatch beyond a one-ulp tie")
    return feats, rows, max_abs_err(got[1], want[1])


def sparse_signs(rows: int, dim: int, nonzero: int, gen, device):
    """[rows, dim] f32 rows of +-1 in ``nonzero`` evenly spaced places at a
    random offset: norms are powers of two, so normalised values and every
    score sum are exact in f32 and bf16."""
    step = dim // nonzero
    at = (torch.randint(0, step, (rows, 1), device=device, generator=gen)
          + step * torch.arange(nonzero, device=device))
    signs = torch.randint(0, 2, (rows, nonzero), device=device,
                          generator=gen).float() * 2 - 1
    return torch.zeros(rows, dim, device=device).scatter_(1, at, signs)


def near_tie_check(name, got, want, field, table, slot_ids=None,
                   tol: float = 1e-5, min_rate: float = 0.999) -> float:
    """Id agreement of two top-k results on a real field; every mismatch
    must be a near-tie: f32 score gap <= ``tol`` under the plain scoring,
    and the agreement at least ``min_rate``.  ``slot_ids`` maps the table's
    rows to the global ids in the results (the gathered form); default: row
    i is id i."""
    from rangeclip_tpu_torch.ops.kernels.pixel_text_topk import (
        normalize_rows_rsqrt,
    )

    torch.cuda.synchronize()
    agree = got[0] == want[0]
    rate = float(agree.float().mean())
    rows = (~agree).any(dim=1).nonzero()[:, 0]
    gap = 0.0
    if rows.numel():
        scores = (normalize_rows_rsqrt(field[rows]).float()
                  @ table.float().T)
        if slot_ids is not None:  # slot scores -> global-id columns
            live = slot_ids >= 0
            full = scores.new_full((rows.numel(), int(slot_ids.max()) + 1),
                                   float("-inf"))
            full[:, slot_ids[live].long()] = scores[:, live]
            scores = full
        pick = lambda idx: scores.gather(1, idx[rows].clamp_min(0).long())
        gap = float((pick(got[0]) - pick(want[0]))[~agree[rows]].abs().max())
    log(f"  {name}: id agreement {rate:.6f}, {int((~agree).sum())} "
        f"mismatches, largest f32 score gap {gap:.3g}")
    require(rate >= min_rate, f"{name}: id agreement {rate} < {min_rate}")
    require(gap <= tol, f"{name}: a mismatch beyond a near-tie ({gap})")
    return rate


def vjp_scale(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per row, the largest |g| / max(||x||, eps): the size of the
    l2_normalize VJP's first term, which its second term can cancel."""
    n = torch.linalg.vector_norm(x.double(), dim=-1, keepdim=True)
    return g.double().abs().amax(dim=-1, keepdim=True) / n.clamp_min(1e-12)


def phase_unfolded_kernels(device, bench_model, serve_model, depths, text,
                           cand, stats):
    from rangeclip_tpu_torch.ops.kernels.l2_normalize import (
        l2_normalize_backward_op,
        l2_normalize_op,
        l2_normalize_plain,
        l2_normalize_rows,
    )
    from rangeclip_tpu_torch.ops.kernels.pixel_text_topk import (
        normalize_rows_rsqrt,
        pixel_text_topk,
        pixel_text_topk_plain,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    D = 512

    def live_ids(mask, ids=None):
        """The plain version's ids: -1 where the mask is off."""
        if ids is None:
            ids = torch.arange(mask.shape[0], dtype=torch.int32,
                               device=device)
        return torch.where(mask, ids, -1)

    def check_topk(name, field, table, mask, k, ids=None):
        got = pixel_text_topk(field, table, mask, k, True, ids)
        want = pixel_text_topk_plain(field, table, live_ids(mask, ids), k)
        return got, check_exact(name, got, want)

    # serve shape: N = 8 * 128^2 pixels, a full table of 512 with some
    # classes masked, fp32 and bf16, quantised-exact inputs
    N, C = SERVE_BATCH * (RES // 2) ** 2, NUM_CLASSES
    q_field = sparse_signs(N, D, 16, gen, device) * torch.exp2(
        torch.randint(-3, 4, (N, 1), device=device, generator=gen).float())
    q_table = sparse_signs(C, D, 4, gen, device) / 2
    mask = torch.rand(C, device=device, generator=gen) > 0.1
    two = torch.zeros(C, dtype=torch.bool, device=device)
    two[[5, 77]] = True
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        field, table = q_field.to(dtype), q_table.to(dtype)
        err = 0.0
        for k in (1, 5):
            err = max(err, check_topk(f"pixel_text_topk {dtype} k={k}",
                                      field, table, mask, k)[1])
            ms, plain_ms = time_pair(
                lambda: pixel_text_topk(field, table, mask, k, False),
                lambda: pixel_text_topk_plain(field, table, live_ids(mask),
                                              k), 10, 3)
            log(f"  pixel_text_topk N={N} D={D} C={C} k={k} {dtype}, "
                f"quantised-exact: bit-equal; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms")
            if k == 1 and dtype == torch.float32:  # the fp32 serve shape
                # masked classes cannot change the answer: the live ones
                n_live = int(mask.sum())
                stats["pixel_text_topk[fp32]"] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=None,
                    **bound(field.numel() * 4 + n_live * D * 4 + N * 4,
                            2.0 * N * D * n_live, "f32"),
                    **device_fields(lambda: pixel_text_topk(
                        field, table, mask, k, False)))
                log(f"  pixel_text_topk[fp32] serve shape: {n_live} of {C} "
                    f"classes live, bound "
                    f"{stats['pixel_text_topk[fp32]']['bound_ms']:.4f} ms")
        # an exhausted candidate set: 2 candidates, top-5
        got, e = check_topk(f"pixel_text_topk exhausted {dtype}", field,
                            table, two, 5)
        require(bool((got[0][:, 2:] == -1).all()
                     and (got[1][:, 2:] == -1e30).all()
                     and ((got[0][:, :2] == 5) | (got[0][:, :2] == 77)).all()),
                "pixel_text_topk: exhausted set not (-1, -1e30)")
        errs[dtype] = max(err, e)
    stats["pixel_text_topk[fp32]"]["max_abs_err"] = errs[torch.float32]
    err = errs[torch.bfloat16]
    log("  pixel_text_topk exhausted set (2 candidates, k=5): bit-equal, "
        "(-1, -1e30) past the candidates")
    field, table = q_field, q_table  # f32
    # the product stage alone through cuBLAS, TF32 off: the normalised f32
    # field by the table's transpose (a yardstick, not the same function)
    normed = normalize_rows_rsqrt(field)
    product_ms = cuda_ms(lambda: torch.matmul(normed, table.T), 10)
    PRODUCT_ONLY_MS["pixel_text_topk[fp32]"] = product_ms
    log(f"  pixel_text_topk[fp32] serve shape, product only (cuBLAS "
        f"torch.matmul [{N}, {D}] x [{D}, {C}] f32, TF32 off): "
        f"{product_ms:.4f} ms")
    del normed
    del q_field, field

    # real fp32 decoder field at the serve shape, the full table
    with torch.inference_mode():
        field = serve_model.native_field(depths[0][:SERVE_BATCH],
                                         normalize=False)
        table = l2_normalize(text.float(), dim=-1)
    flat = field.reshape(-1, D)
    for k in (1, 5):
        got = pixel_text_topk(flat, table, mask, k, True)
        want = pixel_text_topk_plain(flat, table, live_ids(mask), k)
        near_tie_check(f"pixel_text_topk fp32 decoder field k={k}", got, want,
                       flat, table)

    # l2_normalize on the serve-size f32 field: rtol 1e-6, grads 1e-5
    g = torch.randn(flat.shape, device=device, generator=gen)
    l2_errs = check_l2(flat, g, l2_normalize_rows, l2_normalize_plain, 1e-6,
                       1e-5)
    del field, flat, g

    # bench shape: bf16 N = 128 * 128^2, 384 candidate slots, k = 5
    N = BENCH_BATCH * (RES // 2) ** 2
    slot_ids = cand.to(torch.int32)
    q_table = (sparse_signs(BENCH_SLOTS, D, 4, gen, device) / 2).to(
        torch.bfloat16)
    field = (sparse_signs(N, D, 16, gen, device)
             * torch.exp2(torch.randint(-3, 4, (N, 1), device=device,
                                        generator=gen).float())
             ).to(torch.bfloat16)
    slot_mask = slot_ids >= 0
    err = max(err, check_topk("pixel_text_topk bench shape", field, q_table,
                              slot_mask, BENCH_TOP_K, slot_ids)[1])
    log(f"  pixel_text_topk N={N} D={D} S={BENCH_SLOTS} k={BENCH_TOP_K} "
        "bf16, quantised-exact: bit-equal")
    live = live_ids(slot_mask, slot_ids)
    ms, plain_ms = time_pair(
        lambda: pixel_text_topk(field, q_table, slot_mask, BENCH_TOP_K,
                                False, slot_ids),
        lambda: pixel_text_topk_plain(field, q_table, live, BENCH_TOP_K),
        3, 1)
    log(f"  pixel_text_topk bench shape: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    n_live = int(slot_mask.sum())  # the slots that can win
    stats["pixel_text_topk[bf16]"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(field.numel() * 2 + n_live * D * 2 + N * BENCH_TOP_K * 4,
                2.0 * N * D * n_live, "bf16"),
        **device_fields(lambda: pixel_text_topk(
            field, q_table, slot_mask, BENCH_TOP_K, False, slot_ids)))
    # the product stage alone through cuBLAS: the normalised bf16 field by
    # the table's transpose (a yardstick, not the same function)
    normed = normalize_rows_rsqrt(field)
    product_ms = cuda_ms(lambda: torch.matmul(normed, q_table.T), 5)
    PRODUCT_ONLY_MS["pixel_text_topk[bf16]"] = product_ms
    log(f"  pixel_text_topk bench shape, product only (cuBLAS torch.matmul "
        f"[{N}, {D}] x [{D}, {BENCH_SLOTS}] bf16): {product_ms:.4f} ms")
    del field, normed
    torch.cuda.empty_cache()

    # the bench model's real bf16 decoder field, gathered table
    with torch.inference_mode():
        field = bench_model.native_field(depths[0], normalize=False)
        table = l2_normalize(text[cand.clamp_min(0).long()].float(),
                             dim=-1).to(torch.bfloat16)
    flat = field.reshape(-1, D)
    got = pixel_text_topk(flat, table, slot_mask, BENCH_TOP_K, True,
                          slot_ids)
    want = pixel_text_topk_plain(flat, table, live, BENCH_TOP_K)
    near_tie_check("pixel_text_topk bf16 decoder field (bench)", got, want,
                   flat, table, slot_ids)
    del got, want
    torch.cuda.empty_cache()

    # l2_normalize on the bench field [128, 128, 128, 512] bf16
    g = torch.randn(flat.shape, device=device, generator=gen).to(
        torch.bfloat16)
    l2_errs = [max(a, b) for a, b in zip(l2_errs, check_l2(
        flat, g, l2_normalize_rows, l2_normalize_plain, None, None))]
    ms, plain_ms = time_pair(lambda: l2_normalize_op(flat),
                             lambda: l2_normalize_plain(flat), 20, 5)
    log(f"  l2_normalize[fwd] [{N}, {D}] bf16: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    library_ms = cuda_ms(
        lambda: torch.nn.functional.normalize(flat, dim=-1), 20)
    log(f"  l2_normalize[fwd]: F.normalize {library_ms:.4f} ms")
    stats["l2_normalize[fwd]"] = dict(
        max_abs_err=l2_errs[0], ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, **bound(2 * flat.numel() * 2, 0, "bf16"),
        **device_fields(lambda: l2_normalize_op(flat)))
    xp = flat.detach().clone().requires_grad_()
    yp = l2_normalize_plain(xp)
    ms, plain_ms = time_pair(
        lambda: l2_normalize_backward_op(flat, g),
        lambda: torch.autograd.grad(yp, xp, g, retain_graph=True), 20, 5)
    log(f"  l2_normalize[bwd] [{N}, {D}] bf16: kernel {ms:.4f} ms, plain "
        f"(autograd backward) {plain_ms:.4f} ms")
    stats["l2_normalize[bwd]"] = dict(
        max_abs_err=l2_errs[1], ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(3 * flat.numel() * 2, 0, "bf16"),
        **device_fields(lambda: l2_normalize_backward_op(flat, g)))
    del field, flat, g, xp, yp
    torch.cuda.empty_cache()


def check_l2(x, g, kernel, plain, rtol, grad_rtol) -> float:
    """Forward and backward of the kernels against autograd of the plain
    version on the same rows: f32 within rtol (values) and grad_rtol
    (gradients); bf16 (rtol None) values within one bf16 ulp, gradients
    within one bf16 ulp plus 2^-16 of the row's VJP scale (dx is a
    difference of two terms, each rounded in f32).  Returns the largest
    absolute differences of the values and of the gradients."""
    xk = x.detach().clone().requires_grad_()
    y = kernel(xk)
    (dx,) = torch.autograd.grad(y, xk, g)
    xp = x.detach().clone().requires_grad_()
    y_plain = plain(xp)
    (dx_plain,) = torch.autograd.grad(y_plain, xp, g)
    torch.cuda.synchronize()
    errs = []
    for what, got, want, tol, slack in (
            ("values", y, y_plain, rtol, 0.0),
            ("gradients", dx, dx_plain, grad_rtol,
             vjp_scale(x, g) * 2.0 ** -16)):
        got, want = got.detach(), want.detach()
        require(bool(torch.isfinite(got).all()), f"l2_normalize {what} "
                "not finite")
        if tol is None:
            require(within_bf16_ulp(got, want, slack),
                    f"l2_normalize bf16 {what} beyond the bf16 tolerance")
        else:
            torch.testing.assert_close(got.double(), want.double(),
                                       rtol=tol, atol=1e-6)
        errs.append(max_abs_err(got, want))
    log(f"  l2_normalize {x.dtype} [{x.shape[0]}, {x.shape[1]}] forward and "
        f"backward within {'one bf16 ulp (+2^-16 VJP scale)' if rtol is None else f'rtol {rtol}/{grad_rtol}'}"
        f" of autograd on the plain version (max |diff| values {errs[0]:.3g}"
        f", gradients {errs[1]:.3g})")
    return errs


def write_labels(path: str, num_classes: int = NUM_CLASSES) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["label", "index"])
        for i in range(1, num_classes):  # + the dummy class 0
            writer.writerow([f"class {i:03d}", i])


def phase_serve(tmp: str, bf16: bool, device, predict_path: str = "auto",
                labels_file: str = "labels.csv",
                num_classes: int = NUM_CLASSES) -> bool:
    """Serve four POSTed maps; returns whether the engine took the folded
    path.  fp32 labels are checked against the CPU plain path."""
    from rangeclip_tpu_torch.cli import common, serve
    from rangeclip_tpu_torch.data.transforms import depth_transform
    from rangeclip_tpu_torch.models.clip.provider import HashTextEmbedder

    args = serve.parse_args(
        ["--checkpoint_path", os.path.join(tmp, "model.pth"),
         "--labels_path", os.path.join(tmp, labels_file)]
        + (["--bf16"] if bf16 else [])
        + (["--predict_path", predict_path] if predict_path != "auto"
           else []))
    require(args.device == "cuda" and args.batch_size == SERVE_BATCH
            and args.top_k == 1 and args.predict_path == predict_path,
            "serve defaults changed")
    t0 = time.perf_counter()
    predict, model, labels, dev = serve.build_engine(args)
    require(len(labels) == num_classes, f"{len(labels)} labels")
    folded = common.use_folded(args.predict_path, len(labels),
                               args.embedding_dim, args.batch_size,
                               model.compute_dtype, dev)
    size = (args.height, args.width)
    engine = serve.Engine(predict, args.batch_size, size)
    server = ThreadingHTTPServer(
        ("127.0.0.1", 0), serve.make_handler(engine, labels, size, dev))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    rng = np.random.default_rng(SEED + 2)
    depths = [(rng.random((480, 640)) * 4 + 0.5).astype(np.float32)
              for _ in range(4)]
    results = [None] * len(depths)

    def post(i):
        buf = io.BytesIO()
        np.save(buf, depths[i])
        results[i] = request("POST", "/segment", buf.getvalue())

    try:
        status, body = request("GET", "/healthz")
        health = json.loads(body)
        require(status == 200 and "cuda" in health["device"],
                f"/healthz: {status} {health}")
        posters = [threading.Thread(target=post, args=(i,))
                   for i in range(len(depths))]
        for p in posters:
            p.start()
        for p in posters:
            p.join(300)
        served = []
        for status, body in results:
            out = json.loads(body)
            require(status == 200, f"POST /segment: {status} {out}")
            top1 = np.asarray(out["top1"])
            require(top1.shape == size, f"top-1 shape {top1.shape}")
            require(((top1 >= 0) & (top1 < num_classes)).all(),
                    f"top-1 ids outside [0, {num_classes})")
            served.append(top1)
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
    thread.join(30)
    mode = (f"{'bf16' if bf16 else 'fp32'} --predict_path {predict_path} "
            f"({'folded' if folded else 'unfolded'}, C={num_classes})")
    log(f"  serve {mode}: /healthz device {health['device']}; 4 POSTs -> "
        f"200, [{RES}, {RES}] top-1, ids in [0, {num_classes}) "
        f"({time.perf_counter() - t0:.1f} s with engine start)")
    if bf16:
        return folded
    # fp32: the same model and requests through the plain versions on the
    # CPU (no TF32 on the card), labels equal up to near-ties
    cpu_model = copy.deepcopy(model).cpu()
    batch = torch.from_numpy(np.stack([depth_transform(d, size)
                                       for d in depths]))
    table = torch.from_numpy(HashTextEmbedder(dim=args.embedding_dim)(labels))
    with torch.inference_mode():
        want = common.make_predict(cpu_model, 1, folded)(batch, table)
    rate = float((torch.from_numpy(np.stack(served)) == want[..., 0])
                 .float().mean())
    log(f"  serve {mode} labels vs the CPU plain path: agreement {rate:.6f}")
    require(rate >= 0.999, f"fp32 serve agreement {rate} < 0.999")
    return folded


def phase_bench(device, model, depths, text, seg, card: str):
    """The bench configuration through predict_folded, then through the
    unfolded DepthUNet.predict; returns (folded, unfolded) checksums."""
    from rangeclip_tpu_torch.models.depth_unet import (
        build_candidate_indices,
        predict_folded,
    )

    gen = torch.Generator().manual_seed(SEED + 4)
    cand = build_candidate_indices(seg, NUM_CLASSES, BENCH_NEGATIVES,
                                   BENCH_SLOTS, generator=gen)

    def folded(depth):
        with torch.inference_mode():
            return predict_folded(model, depth, text, top_k=BENCH_TOP_K,
                                  candidate_indices=cand)

    def unfolded(depth):
        with torch.inference_mode():
            return model.predict(depth, text, None, BENCH_TOP_K,
                                 return_embeddings=False,
                                 candidate_indices=cand)[0]

    tops, sums = {}, {}
    for name, run in (("predict_folded", folded),
                      ("DepthUNet.predict", unfolded)):
        runs = []
        for _ in range(2):
            topk = run(depths[0])
            require(topk.shape == (BENCH_BATCH, RES, RES, BENCH_TOP_K),
                    f"bench output shape {tuple(topk.shape)}")
            require(bool(((topk >= 0) & (topk < NUM_CLASSES)).all()),
                    "bench ids outside [0, 512)")
            runs.append(int(topk.long().sum()))
        require(runs[0] == runs[1], f"{name} checksums differ: {runs}")
        tops[name], sums[name] = topk[..., 0], runs[0]
        iters = 6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            run(depths[i % len(depths)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        log(f"  bench {name} bf16 batch {BENCH_BATCH} @ {RES}^2, "
            f"{BENCH_SLOTS} slots, top-{BENCH_TOP_K}: checksum {runs[0]} "
            f"twice; {BENCH_BATCH * iters / seconds:.1f} maps/s "
            f"({1e3 * seconds / iters:.2f} ms/batch, host clock) on {card}")
    agree = float((tops["predict_folded"] == tops["DepthUNet.predict"])
                  .float().mean())
    log(f"  bench folded vs unfolded top-1 agreement {agree:.6f} (they rank "
        "the same up to bf16 near-ties)")
    require(agree >= 0.95, f"folded vs unfolded top-1 agreement {agree}")
    return sums["predict_folded"], sums["DepthUNet.predict"]


def write_depth_pngs(directory: str, count: int):
    """16-bit depth PNGs (millimetres) of two sizes; returns the paths."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 6)
    paths = []
    for i in range(count):
        shape = (480, 640) if i % 2 else (240, 320)
        depth = rng.integers(500, 8000, shape).astype(np.uint16)
        paths.append(os.path.join(directory, f"map{i:02d}.png"))
        Image.fromarray(depth).save(paths[-1])
    return paths


def phase_infer(tmp: str, device, totals) -> None:
    """cli/infer over the PNGs (the path whose launches count), then its
    files and ids checked against a direct predict of the same maps."""
    from PIL import Image

    from rangeclip_tpu_torch.cli import common, infer
    from rangeclip_tpu_torch.data.dataset import open_gray
    from rangeclip_tpu_torch.data.labels import load_candidate_labels
    from rangeclip_tpu_torch.data.transforms import depth_transform
    from rangeclip_tpu_torch.models.clip.provider import HashTextEmbedder

    depth_dir = os.path.join(tmp, "depth")
    out_dir = os.path.join(tmp, "infer")
    os.makedirs(depth_dir)
    paths = write_depth_pngs(depth_dir, INFER_MAPS)
    argv = ["--checkpoint_path", os.path.join(tmp, "model.pth"),
            "--depth_glob", os.path.join(depth_dir, "*.png"),
            "--labels_path", os.path.join(tmp, "labels.csv"),
            "--output_dir", out_dir, "--batch_size", str(SERVE_BATCH),
            "--height", str(RES), "--width", str(RES),
            "--predict_path", "default", "--save_preview"]
    written, _ = run_path("infer", ["pixel_text_topk[fp32]"],
                          lambda: infer.main(argv), totals)
    require(written == INFER_MAPS, "infer did not write every map")
    got = []
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0]
        topk = np.load(os.path.join(out_dir, f"{name}_topk.npy"))
        require(topk.shape == (RES, RES, 5) and topk.dtype == np.int32,
                f"{name}_topk.npy: {topk.shape} {topk.dtype}")
        top1 = np.asarray(Image.open(os.path.join(out_dir,
                                                  f"{name}_labels.png")))
        require(np.array_equal(top1, topk[..., 0]), f"{name}_labels.png")
        require(os.path.exists(os.path.join(out_dir, f"{name}_preview.png")),
                f"{name}_preview.png missing")
        got.append(topk)
    got = np.stack(got)
    require(bool(((got >= 0) & (got < NUM_CLASSES)).all()),
            "infer ids outside [0, 512)")
    # the same maps through the same model and path, called directly
    args = infer.parse_args(argv)
    model = common.load_model(args, device)
    labels = load_candidate_labels(args.labels_path)
    table = torch.from_numpy(HashTextEmbedder(dim=512)(labels)).to(device)
    batch = torch.from_numpy(np.stack([
        depth_transform(open_gray(p).astype(np.float32), (RES, RES))
        for p in paths])[..., None]).to(device)
    with torch.inference_mode():
        want = torch.cat([common.make_predict(model, 5, False)(
            batch[i:i + SERVE_BATCH], table) for i in range(0, INFER_MAPS,
                                                            SERVE_BATCH)])
    rate = float((torch.from_numpy(got) == want.cpu()).float().mean())
    log(f"  infer: {INFER_MAPS} maps at batch {SERVE_BATCH} (padded tail), "
        f"--predict_path default: _topk.npy [{RES}, {RES}, 5], _labels.png = "
        f"top-1, previews; ids vs a direct predict: agreement {rate:.6f}")
    require(rate >= 0.999, f"infer agreement {rate} < 0.999")


def phase_export(tmp: str, device) -> None:
    from rangeclip_tpu_torch.cli import export

    output = os.path.join(tmp, "model.pt2")
    t0 = time.perf_counter()
    sidecar = export.main([
        "--checkpoint_path", os.path.join(tmp, "model.pth"),
        "--labels_path", os.path.join(tmp, "labels.csv"), "--output", output,
        "--height", str(RES), "--width", str(RES),
        "--predict_path", "default", "--text_as_input", "--verify"])
    require(sidecar["device"] == "cuda"
            and sidecar["predict_path"] == "default", f"sidecar {sidecar}")
    program = torch.export.load(output)
    ops = sorted({str(n.target) for n in program.graph.nodes
                  if "rangeclip" in str(n.target)})
    require(ops == ["rangeclip.pixel_text_topk.default"],
            f"custom ops in the program: {ops}")
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    depth = torch.randn(SERVE_BATCH, RES, RES, 1, device=device,
                        generator=gen)
    text = torch.randn(NUM_CLASSES, 512, device=device, generator=gen)
    with torch.no_grad():
        ids = program.module()(depth, text)
    torch.cuda.synchronize()
    require(tuple(ids.shape) == (SERVE_BATCH, RES, RES, 5)
            and ids.dtype == torch.int32
            and bool(((ids >= 0) & (ids < NUM_CLASSES)).all()),
            f"loaded program output {tuple(ids.shape)} {ids.dtype}")
    log(f"  export --predict_path default --text_as_input --verify: "
        f"{sidecar['bytes'] / 1e6:.1f} MB .pt2 with {ops}, loaded and run: "
        f"[{SERVE_BATCH}, {RES}, {RES}, 5] int32 "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_gradient(device) -> None:
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
    )

    model = DepthUNet(DepthUNetConfig(dtype=torch.bfloat16), device=device,
                      generator=torch.Generator().manual_seed(SEED + 8))
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    depth = torch.randn(SERVE_BATCH, RES, RES, 1, device=device,
                        generator=gen)
    field, _, _ = model.forward_native(depth)
    require(tuple(field.shape) == (SERVE_BATCH, RES // 2, RES // 2, 512)
            and field.dtype == torch.bfloat16, f"field {field.shape}")
    field.float().sum().backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    torch.cuda.synchronize()
    require(len(grads) > 0 and all(bool(torch.isfinite(g).all())
                                   for g in grads), "gradients not finite")
    log(f"  forward_native bf16 batch {SERVE_BATCH} + backward: "
        f"{len(grads)} finite parameter gradients")


def contrast_set(gen, device, members: int):
    """A [C] contrast mask of ``members`` random classes and their ids."""
    perm = torch.randperm(NUM_CLASSES, device=device, generator=gen)
    mask = torch.zeros(NUM_CLASSES, dtype=torch.bool, device=device)
    mask[perm[:members]] = True
    return mask, perm[:members].sort().values.int()


def tc_alone(flat, temp, g, labels, valid, ptable, pmask, pids, flag):
    """(fwd ms, bwd ms) of pixel_text_ce's tensor-core kernels launched
    directly, without the CUDA-core kernel the operators launch beside
    them."""
    from rangeclip_tpu_torch.ops.kernels import _lib
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import (
        transposed_table,
    )

    lib, stream = _lib.library(), _lib.stream_of(flat)
    N, D = flat.shape
    S, K = labels.shape[0], ptable.shape[0]
    ce = torch.empty(N, device=flat.device)
    dx, dtau = torch.empty_like(flat), torch.empty(N, device=flat.device)
    ptable_t = transposed_table(ptable)
    coeff = g.float().reshape(())
    fwd = lambda: lib.rc_pixel_text_ce_tc_fwd(  # noqa: E731
        flat.data_ptr(), temp.data_ptr(), labels.data_ptr(),
        valid.data_ptr(), S, N, D, ptable.data_ptr(), pmask.data_ptr(),
        pids.data_ptr(), K, flag.data_ptr(), ce.data_ptr(), None, stream)
    bwd = lambda: lib.rc_pixel_text_ce_tc_bwd(  # noqa: E731
        flat.data_ptr(), temp.data_ptr(), coeff.data_ptr(),
        labels.data_ptr(), valid.data_ptr(), S, N, D, ptable.data_ptr(),
        ptable_t.data_ptr(), pmask.data_ptr(), pids.data_ptr(), K,
        flag.data_ptr(), dx.data_ptr(), dtau.data_ptr(), stream)
    require(fwd() == 0 and bwd() == 0, "pixel_text_ce_tc launch failed")
    return cuda_ms(fwd, 10), cuda_ms(bwd, 10)


def phase_train_kernels(device, stats):
    """histogram, pixel_text_ce and tv_rowtile at the flagship train shapes
    (bf16 [32, 128, 128, 512] native field, 32 x 45,875 draws into 65,536
    bins, C = 512, S = 4 label slots, capacity 128)."""
    from rangeclip_tpu_torch.losses.infonce import n_draws, pack_contrast_set
    from rangeclip_tpu_torch.ops.kernels.histogram import (
        histogram,
        histogram_plain,
    )
    from rangeclip_tpu_torch.ops.kernels.live_rows import live_table
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import (
        ce_operands,
        member_table,
        pixel_text_ce_backward_op,
        pixel_text_ce_backward_plain,
        pixel_text_ce_op,
        pixel_text_ce_plain,
        tc_route,
    )
    from rangeclip_tpu_torch.ops.kernels.tv_rowtile import (
        tv_grad,
        tv_rowtile,
        tv_rowtile_backward_op,
        tv_rowtile_op,
        tv_rowtile_plain,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize
    from rangeclip_tpu_torch.utils.profiling import profile

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    B, h, D = TRAIN_BATCH, RES // 2, 512

    # histogram: bit-equal
    n, bins = n_draws(RES, RES), RES * RES
    idx = torch.randint(0, bins, (B, n), device=device, generator=gen,
                        dtype=torch.int32)
    got = histogram(idx, bins)
    want = histogram_plain(idx, bins)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "histogram differs from its plain version")
    ms, plain_ms = time_pair(lambda: histogram(idx, bins),
                             lambda: histogram_plain(idx, bins), 50, 10)
    offsets = (idx.long() + bins * torch.arange(B, device=device)[:, None]
               ).reshape(-1)
    library_ms = cuda_ms(lambda: torch.bincount(offsets, minlength=B * bins),
                         50)
    row = stats["histogram"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(idx.numel() * 4 + B * bins * 4, 0, "f32"),
        **device_fields(lambda: histogram(idx, bins), 20))
    require(row["device_events"] == 1,
            f"histogram: {row['device_events']} device events a call")
    log(f"  histogram [{B}, {n}] -> [{B}, {bins}]: bit-equal; kernel "
        f"{ms:.4f} ms a call in a loop of calls (CUDA events), "
        f"{row['device_ms']:.4f} ms device time (torch.profiler) in 1 "
        f"device event a call, bound {row['bound_ms']:.4f} ms; plain "
        f"{plain_ms:.4f} ms, torch.bincount over row-offset draws "
        f"{library_ms:.4f} ms")
    del idx, offsets, got, want

    # pixel_text_ce: bf16 packed (the tensor-core kernels), bf16 overflowing
    # K (full C) and fp32 full C (CUDA cores) at D = 512, then bf16 packed
    # at D = 768, then fp32 full C with every class a member (each its own
    # table, drawn after the others' data)
    text = l2_normalize(torch.randn(NUM_CLASSES, D, device=device,
                                    generator=gen), dim=-1)

    # live_rows: the member-only kernels' table at the overflow branch's
    # shape (the bf16 table of 512 and the packed one of 128, 200 members,
    # the flag at 0), bit-equal to live_table over the rows in the order
    # the kernel gathers them (the selected table first)
    mask, _ = contrast_set(torch.Generator(device=device).manual_seed(
        SEED + 19), device, 200)
    pids, ptable, pmask = pack_contrast_set(mask, text, CAPACITY)
    flag = (mask.sum() <= CAPACITY).int().reshape(1)
    tb, ptb = text.to(torch.bfloat16), ptable.to(torch.bfloat16)
    mask_i, pmask_i, pids_i = mask.int(), pmask.int(), pids.int()
    arange = torch.arange(NUM_CLASSES, dtype=torch.int32, device=device)
    on = bool(flag)
    order = [(ptb, pids_i, pmask_i != 0), (tb, arange, mask_i != 0)]
    order = order if on else order[::-1]
    plain_rows = torch.cat([order[0][0], order[1][0]])
    plain_ids = torch.cat([order[0][1], order[1][1]])
    plain_live = torch.cat([order[0][2], torch.zeros_like(order[1][2])])

    def gather():
        return member_table(tb, mask_i, ptb, pmask_i, pids_i, flag)

    def gather_plain():
        return live_table(plain_rows, plain_ids, plain_live)

    got, want = gather(), gather_plain()
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "live_rows differs from live_table")
    ms, plain_ms = time_pair(gather, gather_plain, 50, 20)
    rows_n = plain_rows.shape[0]
    log(f"  live_rows bf16 [{NUM_CLASSES} + {CAPACITY}, {D}] -> [{D}, "
        f"{got[0].shape[1]}] f32, {int(got[2])} live: bit-equal to "
        f"live_table; kernel {ms:.4f} ms (one launch), plain {plain_ms:.4f} "
        f"ms")
    stats["live_rows"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(rows_n * D * 2 + rows_n * 8 + got[0].numel() * 4
                + rows_n * 4 + 4, 0, "bf16"),
        **device_fields(gather))
    del got, want, plain_rows
    rows = {}
    for case, dtype, batch, members, width in (
            ("bf16 packed", torch.bfloat16, B, 90, D),
            ("bf16 overflow (full C)", torch.bfloat16, B, 200, D),
            ("fp32 full C", torch.float32, 8, 90, D),
            ("bf16 packed D=768", torch.bfloat16, B, 90, 768),
            ("fp32 full C, all members", torch.float32, 8, NUM_CLASSES, D)):
        N = batch * h * h
        if width != text.shape[1]:
            text = l2_normalize(torch.randn(NUM_CLASSES, width,
                                            device=device, generator=gen),
                                dim=-1)
        samples = torch.randn(N, width, device=device,
                              generator=gen).to(dtype)
        mask, members_ids = contrast_set(gen, device, members)
        pick = torch.randint(0, members, (4, N), device=device, generator=gen)
        labels = members_ids[pick]
        valid = torch.randint(0, 3, (4, N), device=device,
                              generator=gen).float()
        temp = torch.tensor(0.07, device=device)
        table = text.to(dtype)
        packed = None
        if dtype == torch.bfloat16:
            ids, ptable, pmask = pack_contrast_set(mask, text, CAPACITY)
            packed = (ptable.to(dtype), pmask, ids,
                      mask.sum() <= CAPACITY)
        args = ce_operands(samples, temp, labels, valid, table, mask,
                               packed)
        flat, lab, val, msk, pt, pm, pi, flag = args
        op_args = (flat, temp, lab, val, table, msk, pt, pm, pi, flag)
        plain_args = (flat, temp, lab, val, table, msk)
        plain_packed = None if pt is None else (pt, pm, pi, flag)
        g = torch.tensor(1.0 / N, device=device)
        got, row_stats = pixel_text_ce_op(*op_args)
        want = pixel_text_ce_plain(*plain_args, packed=plain_packed)
        dx, dt = pixel_text_ce_backward_op(g, row_stats, *op_args)
        dx_p, dt_p = pixel_text_ce_backward_plain(g, *plain_args,
                                                  packed=plain_packed)
        torch.cuda.synchronize()
        # tolerances: f32 summation order and the online max over class
        # tiles (rtol 2e-5 on the summed CE and d tau); d samples within one
        # bf16 ulp plus 2^-10 of the row's largest entry (bf16), or 1e-4 of
        # it (f32)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=0.0)
        torch.testing.assert_close(dt, dt_p, rtol=2e-5, atol=1e-6)
        scale = dx_p.double().abs().amax(dim=-1, keepdim=True)
        err = (dx.double() - dx_p.double()).abs()
        if dtype == torch.bfloat16:
            require(within_bf16_ulp(dx, dx_p, scale * 2.0 ** -10),
                    f"pixel_text_ce[bwd] {case} beyond one bf16 ulp")
        else:
            require(bool((err <= 1e-4 * scale + 1e-12).all()),
                    f"pixel_text_ce[bwd] {case}: {float(err.max())}")
        fwd = time_pair(lambda: pixel_text_ce_op(*op_args),
                        lambda: pixel_text_ce_plain(
                            *plain_args, packed=plain_packed), 5, 2)
        bwd = time_pair(lambda: pixel_text_ce_backward_op(g, row_stats,
                                                          *op_args),
                        lambda: pixel_text_ce_backward_plain(
                            g, *plain_args, packed=plain_packed), 5, 2)
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        # the packed cases run on the tensor cores; on overflow (the flag
        # at 0) the tensor-core kernels return at once and the member-only
        # kernels score the full table's members
        tc = case.startswith("bf16 packed")
        require(tc_route(flat, pt) == (pt is not None),
                f"pixel_text_ce {case}: route")
        # a non-member's logit is -1e30 and its exp term exactly 0: the
        # function needs the members only (the packed table holds them)
        classes = CAPACITY if tc else int(mask.sum())
        if tc:
            tc_ms = tc_alone(flat, temp, g, lab, val, pt, pm, pi, flag)
            log(f"  pixel_text_ce {case}: the tensor-core kernels alone "
                f"(without the CUDA-core launch that returns at once) fwd "
                f"{tc_ms[0]:.4f} ms, bwd {tc_ms[1]:.4f} ms")
        if case == "bf16 packed":
            emb = l2_normalize(flat.float(), dim=-1).to(dtype)
            PRODUCT_ONLY_MS["pixel_text_ce (bf16 [N, 512] x [512, 128])"] = (
                cuda_ms(lambda: torch.matmul(emb, pt.T), 20))
            del emb
        if not tc:  # the member-only kernels' products alone, TF32 off (main)
            emb = l2_normalize(flat.float(), dim=-1)
            rows_t = table[mask].float().contiguous()
            m_ = rows_t.shape[0]
            if dtype == torch.float32:
                PRODUCT_ONLY_MS[
                    f"pixel_text_ce[fwd] (f32 [N, {width}] x [{width}, "
                    f"{m_} members])"] = cuda_ms(
                        lambda: torch.matmul(emb, rows_t.T), 10)
            PRODUCT_ONLY_MS[
                f"pixel_text_ce[bwd] {case} (f32 [{N}, {width}] x "
                f"[{width}, {m_}], then [{N}, {m_}] x [{m_}, {width}])"] = (
                    cuda_ms(lambda: torch.matmul(torch.matmul(emb, rows_t.T),
                                                 rows_t), 5))
            del emb, rows_t
        esize = flat.element_size()
        io = flat.numel() * esize + lab.numel() * 8 + classes * width * esize
        flops = 2.0 * N * classes * width
        rows[case] = dict(
            fwd=dict(max_abs_err=max_abs_err(got, want), ms=fwd[0],
                     plain_ms=fwd[1], library_ms=None,
                     **bound(io, flops, kind),
                     **device_fields(lambda: pixel_text_ce_op(*op_args))),
            bwd=dict(max_abs_err=float(err.max()), ms=bwd[0],
                     plain_ms=bwd[1], library_ms=None,
                     **bound(io + flat.numel() * esize, 2 * flops, kind),
                     **device_fields(lambda: pixel_text_ce_backward_op(
                         g, row_stats, *op_args))))
        log(f"  pixel_text_ce {case} "
            f"({'tensor cores' if tc else 'member-only, CUDA cores'}), "
            f"N={N} D={width} S=4 "
            f"({int(mask.sum())} members): CE {float(got):.6g} vs plain "
            f"{float(want):.6g}, d tau {float(dt):.6g} vs {float(dt_p):.6g}, "
            f"max |d samples diff| {float(err.max()):.3g}; fwd kernel "
            f"{fwd[0]:.4f} ms (plain {fwd[1]:.4f}), bwd kernel {bwd[0]:.4f} "
            f"ms (plain {bwd[1]:.4f}); bound fwd "
            f"{rows[case]['fwd']['bound_ms']:.4f} ms, bwd "
            f"{rows[case]['bwd']['bound_ms']:.4f} ms")
        del samples, flat, dx, dx_p, err, op_args, plain_args
        torch.cuda.empty_cache()
    # the rows: the tensor-core kernels at the flagship packed shape, the
    # member-only kernels at fp32 full C with 90 members (the route of fp32
    # validation and of cli/train's default precision)
    for name, case in (("pixel_text_ce_tc", "bf16 packed"),
                       ("pixel_text_ce", "fp32 full C")):
        tc = name.endswith("_tc")
        for key in ("fwd", "bwd"):
            stats[f"{name}[{key}]"] = dict(rows[case][key], max_abs_err=max(
                r[key]["max_abs_err"] for c, r in rows.items()
                if c.startswith("bf16 packed") == tc))

    # tv_rowtile: bf16, upsample 2, one sample weight 0
    x = (torch.randint(-6, 7, (B, h, h, D), device=device, generator=gen) / 4
         + torch.randn(B, h, h, D, device=device, generator=gen)
         ).to(torch.bfloat16)
    w = torch.ones(B, device=device)
    w[-1] = 0.0
    xk = x.clone().requires_grad_()
    value = tv_rowtile(xk, w, 2)
    value.backward()
    xp = x.clone().requires_grad_()
    want = tv_rowtile_plain(xp, w, 2)
    want.backward()
    torch.cuda.synchronize()
    # the forward differs by f32 summation order; the backward is bit-equal
    torch.testing.assert_close(value.detach(), want.detach(), rtol=1e-5,
                               atol=0.0)
    require(torch.equal(xk.grad, xp.grad),
            "tv_rowtile[bwd] is not bit-equal to the plain VJP")
    g = torch.tensor(1.0, device=device)
    xw = x * w.to(x.dtype)[:, None, None, None]
    fwd = time_pair(lambda: tv_rowtile_op(x, w, 2),
                    lambda: tv_rowtile_plain(x, w, 2), 20, 5)
    bwd = time_pair(lambda: tv_rowtile_backward_op(x, w, g, 2),
                    lambda: tv_grad(xw, g, 2), 20, 5)
    # the forward's device events per operator call, read with the profiler:
    # its kernels alone, and nothing else on the device
    fwd_prof = profile(lambda: tv_rowtile_op(x, w, 2), calls=20)
    events, alone = fwd_prof["events"], fwd_prof["device_ms"]
    require(all("tv_fwd" in name for name, _ in events),
            f"tv_rowtile[fwd]: device events other than its kernels: "
            f"{events}")
    log(f"  tv_rowtile [{B}, {h}, {h}, {D}] bf16, upsample 2, one weight 0: "
        f"value {float(value.detach()):.6g} vs plain "
        f"{float(want.detach()):.6g}, backward "
        f"bit-equal; fwd operator call {fwd[0]:.4f} ms (plain "
        f"{fwd[1]:.4f}), fwd kernels alone (torch.profiler) {alone:.4f} "
        f"ms: {', '.join(f'{n} {ms:.4f}' for n, ms in events)}; bwd kernel "
        f"{bwd[0]:.4f} ms (plain {bwd[1]:.4f})")
    stats["tv_rowtile[fwd]"] = dict(
        max_abs_err=max_abs_err(value.detach(), want.detach()), ms=fwd[0],
        plain_ms=fwd[1], library_ms=None, **bound(x.numel() * 2, 0, "bf16"),
        device_ms=alone, device_events=fwd_prof["device_events"],
        device_traces=fwd_prof["traces"])
    stats["tv_rowtile[bwd]"] = dict(
        max_abs_err=max_abs_err(xk.grad, xp.grad), ms=bwd[0],
        plain_ms=bwd[1], library_ms=None,
        **bound(2 * x.numel() * 2, 0, "bf16"),
        **device_fields(lambda: tv_rowtile_backward_op(x, w, g, 2)))
    del x, xk, xp, xw
    torch.cuda.empty_cache()


MIT_CE_MEMBERS = 138  # the contrast set of phase 11's MiT step


def mit_slot_labels(gen, device, member_ids, batch: int, res: int):
    """[16, batch * (res/4)^2] labels as the MiT step slots them: a
    segmentation at res^2 of 16 x 16-pixel regions of member classes, each
    H/4 pixel's 4 x 4 block its 16 slots."""
    coarse = member_ids[torch.randint(
        0, member_ids.numel(), (batch, res // 16, res // 16), device=device,
        generator=gen)]
    seg = coarse.repeat_interleave(16, 1).repeat_interleave(16, 2)
    blocks = seg.reshape(batch, res // 4, 4, res // 4, 4)
    return blocks.permute(2, 4, 0, 1, 3).reshape(16, -1).int().contiguous()


def phase_slot_ce_kernels(device, stats) -> None:
    """pixel_text_ce past 4 slots (the tensor-core pair) at the MiT step's
    shape: bf16 [16, 64, 64, 512], N = 65,536, 16 slots, 138 of C = 512
    members, the packed table of 128 with the flag at 0 (the contrast set
    overflows it, as in phase 11's MiT step), against its plain versions at
    the flagship check's tolerances, each direction timed in alternation
    with its plain version."""
    from rangeclip_tpu_torch.losses.infonce import pack_contrast_set
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import (
        ce_operands,
        pixel_text_ce_backward_plain,
        pixel_text_ce_plain,
        pixel_text_ce_slots_backward_op,
        pixel_text_ce_slots_op,
        slots_route,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    B, h, D = CLI_TRAIN_BATCH, RES // 4, 512
    N = B * h * h
    text = l2_normalize(torch.randn(NUM_CLASSES, D, device=device,
                                    generator=gen), dim=-1)
    mask, members = contrast_set(gen, device, MIT_CE_MEMBERS)
    labels = mit_slot_labels(gen, device, members, B, RES)
    valid = torch.randint(0, 3, (16, N), device=device, generator=gen).float()
    samples = torch.randn(N, D, device=device, generator=gen).bfloat16()
    temp = torch.tensor(0.07, device=device)
    ids, ptable, pmask = pack_contrast_set(mask, text, CAPACITY)
    packed = (ptable.bfloat16(), pmask, ids, mask.sum() <= CAPACITY)
    flat, lab, val, msk, pt, pm, pi, flag = ce_operands(
        samples, temp, labels, valid, text.bfloat16(), mask, packed)
    require(slots_route(flat, 16) and not bool(flag),
            "pixel_text_ce_slots: the MiT case's route or flag")
    op_args = (flat, temp, lab, val, text.bfloat16(), msk, pt, pm, pi, flag)
    plain_args = (flat, temp, lab, val, text.bfloat16(), msk)
    plain_packed = (pt, pm, pi, flag)
    g = torch.tensor(1.0 / N, device=device)
    got, row_stats = pixel_text_ce_slots_op(*op_args)
    want = pixel_text_ce_plain(*plain_args, packed=plain_packed)
    dx, dt = pixel_text_ce_slots_backward_op(g, row_stats, *op_args)
    dx_p, dt_p = pixel_text_ce_backward_plain(g, *plain_args,
                                              packed=plain_packed)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=0.0)
    torch.testing.assert_close(dt, dt_p, rtol=2e-5, atol=1e-6)
    scale = dx_p.double().abs().amax(dim=-1, keepdim=True)
    require(within_bf16_ulp(dx, dx_p, scale * 2.0 ** -10),
            "pixel_text_ce_slots[bwd] beyond one bf16 ulp")
    fwd = time_pair(lambda: pixel_text_ce_slots_op(*op_args),
                    lambda: pixel_text_ce_plain(*plain_args,
                                                packed=plain_packed), 10, 3)
    bwd = time_pair(lambda: pixel_text_ce_slots_backward_op(g, row_stats,
                                                            *op_args),
                    lambda: pixel_text_ce_backward_plain(
                        g, *plain_args, packed=plain_packed), 10, 3)
    # the bound over the selected table's members (a non-member's exp term
    # is 0): the field, labels and weights, the members read once; d
    # samples written once; 2 N D members operations forward, twice that
    # backward
    members_n = int(mask.sum())
    io = flat.numel() * 2 + lab.numel() * 8 + members_n * D * 2
    flops = 2.0 * N * members_n * D
    stats["pixel_text_ce_slots[fwd]"] = dict(
        max_abs_err=max_abs_err(got, want), ms=fwd[0], plain_ms=fwd[1],
        library_ms=None, **bound(io, flops, "bf16"),
        **device_fields(lambda: pixel_text_ce_slots_op(*op_args)))
    stats["pixel_text_ce_slots[bwd]"] = dict(
        max_abs_err=max_abs_err(dx, dx_p), ms=bwd[0], plain_ms=bwd[1],
        library_ms=None, **bound(io + flat.numel() * 2, 2 * flops, "bf16"),
        **device_fields(lambda: pixel_text_ce_slots_backward_op(
            g, row_stats, *op_args)))
    f, b = stats["pixel_text_ce_slots[fwd]"], stats["pixel_text_ce_slots[bwd]"]
    log(f"  pixel_text_ce past 4 slots (tensor cores), bf16 N={N} D={D} "
        f"S=16 ({members_n} members of {NUM_CLASSES}, flag 0): CE "
        f"{float(got):.6g} vs plain {float(want):.6g}, d tau {float(dt):.6g} "
        f"vs {float(dt_p):.6g}, max |d samples diff| "
        f"{b['max_abs_err']:.3g}; fwd kernel {fwd[0]:.4f} ms (plain "
        f"{fwd[1]:.4f}), device {f['device_ms']:.4f} ms in "
        f"{f['device_events']:g} events; bwd kernel {bwd[0]:.4f} ms (plain "
        f"{bwd[1]:.4f}), device {b['device_ms']:.4f} ms in "
        f"{b['device_events']:g} events; bound fwd {f['bound_ms']:.4f} ms, "
        f"bwd {b['bound_ms']:.4f} ms")
    del samples, flat, dx, dx_p
    torch.cuda.empty_cache()


def bench_mask(seg: torch.Tensor) -> torch.Tensor:
    """The bench configuration's candidate mask over the full table: the 40
    labels present plus 300 drawn negatives (340 of C = 512)."""
    from rangeclip_tpu_torch.models.depth_unet import build_candidate_mask

    return build_candidate_mask(
        seg, NUM_CLASSES, BENCH_NEGATIVES,
        generator=torch.Generator().manual_seed(SEED + 14))


def pool_objects(device) -> torch.Tensor:
    """256 object ids: 0..254 (the labels present among them, the rest
    absent) and a duplicate of 3."""
    return torch.cat([torch.arange(POOL_OBJECTS - 1, device=device),
                      torch.tensor([3], device=device)]).to(torch.int32)


def region_labels(batch: int, h: int, per_image: int, gen, device
                  ) -> torch.Tensor:
    """[batch * h * h] int32 labels, spatially coherent: each image's h x h
    pixels split into ``per_image`` Voronoi regions about distinct seed
    pixels (so none is empty), image b's regions numbered b * per_image +
    0 .. per_image - 1."""
    seeds = torch.stack([torch.randperm(h * h, device=device, generator=gen)
                         [:per_image] for _ in range(batch)])
    pix = torch.arange(h * h, device=device)
    dy = pix[None, :, None] // h - seeds[:, None, :] // h
    dx = pix[None, :, None] % h - seeds[:, None, :] % h
    region = (dy * dy + dx * dx).argmin(dim=-1)  # [batch, h * h]
    base = torch.arange(batch, device=device)[:, None] * per_image
    return (region + base).reshape(-1).to(torch.int32)


def phase_eval_kernels(device, bench_model, serve_model, depths, text, seg,
                       stats):
    """masked_pooling and tv_loss on a bf16 field of the flagship train
    native shape [32, 128, 128, 512]; head_topk's tensor-core route at the
    bench configuration, its CUDA-core route on the fp32 serve model at the
    serve shape."""
    from rangeclip_tpu_torch.ops.kernels.head_topk import (
        fused_head_score_topk,
        head_field,
        head_topk_plain,
        weight_rows,
    )
    from rangeclip_tpu_torch.ops.kernels.masked_pooling import (
        fused_masked_pooling,
        masked_pooling_plain,
    )
    from rangeclip_tpu_torch.ops.kernels.tv_loss import (
        fused_tv_loss,
        tv_loss_backward_op,
        tv_loss_grad,
        tv_loss_op,
        tv_loss_value,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    B, h, D = TRAIN_BATCH, RES // 2, 512
    x = (torch.randint(-6, 7, (B, h, h, D), device=device, generator=gen) / 4
         + torch.randn(B, h, h, D, device=device, generator=gen)
         ).to(torch.bfloat16)

    # masked_pooling: labels 0..39 with -1 padding, 256 ids (the 40
    # present, a duplicate, absent ones); sums within 1e-5 of the sum of
    # |x| over each object's pixels (f32 sums in another order), counts
    # and a second run bit-equal
    emb = x.reshape(-1, D)
    labels = torch.randint(0, TRAIN_PRESENT, (emb.shape[0],), device=device,
                           generator=gen, dtype=torch.int32)
    labels[::101] = -1
    obj = pool_objects(device)

    def pool_check(name, labels, obj):
        sums, counts = fused_masked_pooling(emb, labels, obj)
        again = fused_masked_pooling(emb, labels, obj)[0]
        want, want_counts = masked_pooling_plain(emb, labels, obj)
        scale = masked_pooling_plain(emb.abs(), labels, obj)[0]
        torch.cuda.synchronize()
        require(torch.equal(counts, want_counts),
                f"masked_pooling ({name}) counts differ")
        require(bool(((sums - want).abs() <= 1e-5 * scale + 1e-6).all()),
                f"masked_pooling ({name}) sums beyond 1e-5 of the summed "
                f"magnitudes")
        require(torch.equal(sums, again),
                f"masked_pooling ({name}) is not deterministic")
        return sums, counts, want

    sums, counts, want = pool_check("uniform, 40 labels", labels, obj)
    ms, plain_ms = time_pair(lambda: fused_masked_pooling(emb, labels, obj),
                             lambda: masked_pooling_plain(emb, labels, obj),
                             20, 3)
    # the library yardstick: index_add_ of an f32 copy of the field over a
    # precomputed pixel-to-row map (the ids unique: the duplicate dropped,
    # unmatched pixels sent to a spare row)
    rowmap = torch.where(labels >= 0, labels, POOL_OBJECTS - 1).long()
    emb32 = emb.float()
    library_ms = cuda_ms(lambda: torch.zeros(
        POOL_OBJECTS, D, device=device).index_add_(0, rowmap, emb32), 20)
    log(f"  masked_pooling [{emb.shape[0]}, {D}] bf16, {POOL_OBJECTS} ids "
        f"({int((counts[:-1] > 0).sum())} present, a duplicate): counts "
        f"exact, "
        f"sums within 1e-5 of the summed magnitudes (max |diff| "
        f"{max_abs_err(sums, want):.3g}), deterministic; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, index_add_ (f32 copy, unique ids) "
        f"{library_ms:.4f} ms")
    pool_bytes = (emb.numel() * 2 + labels.numel() * 4 + obj.numel() * 4
                  + POOL_OBJECTS * (D + 1) * 4)
    stats["masked_pooling"] = dict(
        max_abs_err=max_abs_err(sums, want), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, **bound(pool_bytes, emb.numel(), "f32"),
        **device_fields(lambda: fused_masked_pooling(emb, labels, obj)))
    del emb32, rowmap

    # the same field under spatially coherent labels (each image's 128^2
    # in 8 Voronoi regions about distinct seed pixels, image b's ids 8 b ..
    # 8 b + 7: all 256 present, a few in each chunk) and under the worst
    # case for the workspace (uniform over the 256 ids: every id in every
    # chunk)
    every_id = torch.arange(POOL_OBJECTS, dtype=torch.int32, device=device)
    pool_gen = torch.Generator(device=device).manual_seed(SEED + 16)
    for name, case_labels in (
            ("regions", region_labels(B, h, POOL_OBJECTS // B, pool_gen,
                                      device)),
            ("uniform, 256 labels",
             torch.randint(0, POOL_OBJECTS, (emb.shape[0],), device=device,
                           generator=pool_gen, dtype=torch.int32))):
        sums, counts, want = pool_check(name, case_labels, every_id)
        require(bool((counts > 0).all()),
                f"masked_pooling ({name}): an id is absent")
        case_ms, case_plain_ms = time_pair(
            lambda: fused_masked_pooling(emb, case_labels, every_id),
            lambda: masked_pooling_plain(emb, case_labels, every_id), 20, 3)
        # every id once in the list and every label an id: index_add_
        # over the labels themselves
        case_rows = case_labels.long()
        emb32 = emb.float()
        case_library_ms = cuda_ms(lambda: torch.zeros(
            POOL_OBJECTS, D, device=device).index_add_(0, case_rows, emb32),
            20)
        del emb32, case_rows
        log(f"  masked_pooling [{emb.shape[0]}, {D}] bf16, {name}: "
            f"{int((counts > 0).sum())} ids present, counts exact, sums "
            f"within 1e-5 of the summed magnitudes (max |diff| "
            f"{max_abs_err(sums, want):.3g}), deterministic; kernel "
            f"{case_ms:.4f} ms (bound "
            f"{bound(pool_bytes, 0, 'f32')['bound_ms']:.4f} ms), plain "
            f"{case_plain_ms:.4f} ms, index_add_ (f32 copy) "
            f"{case_library_ms:.4f} ms")

    # tv_loss in bf16 (its row) and in f32 (the same values widened, beside
    # it in the row): ties from the quarter grid (sign(0) = 0); the forward
    # within rtol 1e-5 (f32 summation order) and bit-equal across calls,
    # the backward bit-equal
    g = torch.tensor(1.0, device=device)
    for xt in (x, x.float()):
        kind = "bf16" if xt.dtype == torch.bfloat16 else "f32"
        xk = xt.clone().requires_grad_()
        value = fused_tv_loss(xk)
        value.backward()
        again = fused_tv_loss(xt)
        want = tv_loss_value(xt)
        want_grad = tv_loss_grad(xt, g)
        torch.cuda.synchronize()
        torch.testing.assert_close(value.detach(), want, rtol=1e-5, atol=0.0)
        require(torch.equal(again, value.detach()),
                f"tv_loss[fwd] {kind}: two calls differ")
        require(torch.equal(xk.grad, want_grad),
                f"tv_loss[bwd] {kind} is not bit-equal to the plain VJP")
        fwd = time_pair(lambda: tv_loss_op(xt, D), lambda: tv_loss_value(xt),
                        20, 5)
        bwd = time_pair(lambda: tv_loss_backward_op(xt, g, D),
                        lambda: tv_loss_grad(xt, g), 20, 5)
        rows = {
            "tv_loss[fwd]": dict(
                max_abs_err=max_abs_err(value.detach(), want), ms=fwd[0],
                plain_ms=fwd[1], library_ms=None,
                **bound(xt.numel() * xt.element_size(), 0, kind),
                **device_fields(lambda: tv_loss_op(xt, D))),
            "tv_loss[bwd]": dict(
                max_abs_err=max_abs_err(xk.grad, want_grad), ms=bwd[0],
                plain_ms=bwd[1], library_ms=None,
                **bound(2 * xt.numel() * xt.element_size(), 0, kind),
                **device_fields(lambda: tv_loss_backward_op(xt, g, D)))}
        for name, row in rows.items():
            log(f"  {name} [{B}, {h}, {h}, {D}] {kind}: kernel "
                f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms in "
                f"{row['device_events']:g} events, bound "
                f"{row['bound_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
                + (f"; value {float(value.detach()):.7g} vs plain "
                   f"{float(want):.7g}, deterministic" if "fwd" in name
                   else "; bit-equal"))
            if kind == "bf16":
                stats[name] = row
            else:  # beside the bf16 row
                stats[name]["f32"] = row
        del xk, want_grad
    del x, emb, labels
    torch.cuda.empty_cache()

    # head_topk at the bench configuration: the bench model's pre-head
    # features, its output conv and the full table under the bench mask;
    # ids against the plain version up to near-ties: the bf16 embedding
    # rounds after an f32 conv summed in another order, and one component
    # rounded the other way by one bf16 ulp (2^-8 of up to ~0.2) moves a
    # score by up to a few 1e-4 against table entries of ~0.1
    with torch.inference_mode():
        feats = bench_model.decode_features(depths[0]).contiguous()
    rows = weight_rows(bench_model.decoder.output_conv.conv.weight.detach())
    table = l2_normalize(text.float(), dim=-1)
    mask = bench_mask(seg)
    rows_b, table_b, mask_i = (rows.to(torch.bfloat16),
                               table.to(torch.bfloat16), mask.int())
    got = fused_head_score_topk(feats, rows, table, mask, BENCH_TOP_K)
    want = head_topk_plain(feats, rows_b, table_b, mask_i, BENCH_TOP_K)
    field = head_field(feats, rows_b)
    near_tie_check("head_topk bf16 bench vs plain", got, want, field, table_b,
                   tol=1e-3, min_rate=0.9999)
    # where the ids agree, the values are the same score up to that
    # rounding of the embedding
    same = got[0] == want[0]
    err = max_abs_err(got[1][same], want[1][same])
    require(err <= 1e-3, f"head_topk values beyond 1e-3 of the plain "
                         f"version where the ids agree ({err})")
    del field, got, want, same
    torch.cuda.empty_cache()
    ms, plain_ms = time_pair(
        lambda: fused_head_score_topk(feats, rows, table, mask, BENCH_TOP_K),
        lambda: head_topk_plain(feats, rows_b, table_b, mask_i, BENCH_TOP_K),
        3, 1)
    n_pix, c_in = feats.shape[0] * h * h, feats.shape[-1]
    live = int(mask.sum())  # masked classes cannot change the answer
    # the product stage alone, a yardstick: cuDNN's conv to D = 512, then
    # cuBLAS over the live classes
    conv = torch.nn.functional.conv2d
    conv_w = bench_model.decoder.output_conv.conv.weight.detach().to(
        torch.bfloat16, memory_format=torch.channels_last)
    x_nchw = feats.permute(0, 3, 1, 2)
    conv_ms = cuda_ms(lambda: conv(x_nchw, conv_w, padding=1), 3)
    emb = conv(x_nchw, conv_w, padding=1).permute(0, 2, 3, 1).reshape(-1, D)
    live_table = table_b[mask]
    mm_ms = cuda_ms(lambda: emb @ live_table.T, 3)
    PRODUCT_ONLY_MS["head_topk[bf16]"] = conv_ms + mm_ms
    del emb
    torch.cuda.empty_cache()
    log(f"  head_topk B={feats.shape[0]} h=w={h} C_in={c_in} D={D} "
        f"C={NUM_CLASSES} ({live} live) k={BENCH_TOP_K} bf16: values within "
        f"{err:.3g} of plain where the ids agree; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms; product only {conv_ms + mm_ms:.4f} ms (cuDNN "
        f"conv {conv_ms:.4f}, cuBLAS over the live classes {mm_ms:.4f})")
    stats["head_topk[bf16]"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(feats.numel() * 2 + rows.numel() * 2 + table.numel() * 2
                + n_pix * BENCH_TOP_K * 8,
                2.0 * n_pix * (9 * c_in * D + D * live), "bf16"),
        **device_fields(lambda: fused_head_score_topk(feats, rows, table,
                                                      mask, BENCH_TOP_K)))
    del feats, x_nchw
    torch.cuda.empty_cache()

    # head_topk's CUDA-core route: the fp32 serve model's pre-head features
    # at the serve shape, the full table all live (serve's mask), top-1;
    # ids against the plain version up to f32 near-ties (the conv sums in
    # another order)
    with torch.inference_mode():
        feats = serve_model.decode_features(
            depths[0][:SERVE_BATCH]).contiguous()
    rows = weight_rows(serve_model.decoder.output_conv.conv.weight.detach())
    every = torch.ones(NUM_CLASSES, dtype=torch.bool, device=device)
    got = fused_head_score_topk(feats, rows, table, every, 1)
    want = head_topk_plain(feats, rows, table, every.int(), 1)
    near_tie_check("head_topk fp32 serve vs plain", got, want,
                   head_field(feats, rows), table)
    same = got[0] == want[0]
    err = max_abs_err(got[1][same], want[1][same])
    require(err <= 1e-5, f"head_topk fp32 values beyond 1e-5 of the plain "
                         f"version where the ids agree ({err})")
    ms, plain_ms = time_pair(
        lambda: fused_head_score_topk(feats, rows, table, every, 1),
        lambda: head_topk_plain(feats, rows, table, every.int(), 1), 10, 3)
    n_pix, c_in = feats.shape[0] * h * h, feats.shape[-1]
    # the product stage alone, a yardstick: cuDNN's f32 conv to D = 512,
    # then cuBLAS over the live classes (TF32 off for both)
    conv = torch.nn.functional.conv2d
    conv_w = serve_model.decoder.output_conv.conv.weight.detach()
    x_nchw = feats.permute(0, 3, 1, 2)
    conv_ms = cuda_ms(lambda: conv(x_nchw, conv_w, padding=1), 10)
    emb = conv(x_nchw, conv_w, padding=1).permute(0, 2, 3, 1).reshape(-1, D)
    mm_ms = cuda_ms(lambda: emb @ table.T, 10)
    PRODUCT_ONLY_MS["head_topk[fp32]"] = conv_ms + mm_ms
    log(f"  head_topk B={feats.shape[0]} h=w={h} C_in={c_in} D={D} "
        f"C={NUM_CLASSES} (all live) k=1 fp32: values within {err:.3g} of "
        f"plain where the ids agree; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms; product only {conv_ms + mm_ms:.4f} ms (cuDNN "
        f"conv {conv_ms:.4f}, cuBLAS over the {NUM_CLASSES} classes "
        f"{mm_ms:.4f})")
    stats["head_topk[fp32]"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(feats.numel() * 4 + rows.numel() * 4 + table.numel() * 4
                + n_pix * 8,
                2.0 * n_pix * (9 * c_in * D + D * NUM_CLASSES), "f32"),
        **device_fields(lambda: fused_head_score_topk(feats, rows, table,
                                                      every, 1)))

    # the same features under the bench candidate mask (340 live), top-5:
    # scoring over the live classes only
    mask = bench_mask(seg)
    live = int(mask.sum())
    got = fused_head_score_topk(feats, rows, table, mask, BENCH_TOP_K)
    want = head_topk_plain(feats, rows, table, mask.int(), BENCH_TOP_K)
    near_tie_check(f"head_topk fp32 serve shape, {live} live, "
                   f"k={BENCH_TOP_K} vs plain", got, want,
                   head_field(feats, rows), table)
    same = got[0] == want[0]
    err = max_abs_err(got[1][same], want[1][same])
    require(err <= 1e-5, f"head_topk fp32 ({live} live) values beyond 1e-5 "
                         f"of the plain version where the ids agree ({err})")
    masked_ms, masked_plain_ms = time_pair(
        lambda: fused_head_score_topk(feats, rows, table, mask, BENCH_TOP_K),
        lambda: head_topk_plain(feats, rows, table, mask.int(), BENCH_TOP_K),
        10, 3)
    live_table = table[mask]
    masked_mm_ms = cuda_ms(lambda: emb @ live_table.T, 10)
    masked_bound = bound(
        feats.numel() * 4 + rows.numel() * 4 + table.numel() * 4
        + n_pix * BENCH_TOP_K * 8,
        2.0 * n_pix * (9 * c_in * D + D * live), "f32")
    log(f"  head_topk fp32 serve shape, {live} live, k={BENCH_TOP_K}: "
        f"values within {err:.3g} of plain where the ids agree; kernel "
        f"{masked_ms:.4f} ms (bound {masked_bound['bound_ms']:.4f} ms), "
        f"plain {masked_plain_ms:.4f} ms; product only "
        f"{conv_ms + masked_mm_ms:.4f} ms (cuBLAS over the {live} live "
        f"{masked_mm_ms:.4f})")
    del emb, x_nchw, live_table
    del feats, got, want, same
    torch.cuda.empty_cache()


def phase_fused_head(device, model, serve_model, depths, text, seg, card,
                     totals):
    """predict_topk_fused at the bench configuration (the path whose
    launches count: head_topk's tensor-core kernel), then its labels
    against DepthUNet.predict with the pixel_text_topk kernel, up to
    near-ties under f32 scoring of the f32 conv: the fused head rounds the
    normalised embedding to bf16 once, predict rounds the conv output and
    then the normalised field.  Then the fp32 serve model through
    predict_topk_fused at the serve shape (batch 8, C = 512 all live,
    top-1: the CUDA-core kernel), its labels against its DepthUNet.predict
    up to f32 near-ties."""
    from rangeclip_tpu_torch.models.depth_unet import predict_topk_fused
    from rangeclip_tpu_torch.ops.kernels.head_topk import (
        head_field,
        weight_rows,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    mask = bench_mask(seg)
    iters = 3

    def drive():
        with torch.inference_mode():
            ids = predict_topk_fused(model, depths[0], text, mask,
                                     BENCH_TOP_K)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                predict_topk_fused(model, depths[i % len(depths)], text, mask,
                                   BENCH_TOP_K)
            torch.cuda.synchronize()
        return ids, time.perf_counter() - t0

    (fused, seconds), counts = run_path("predict_topk_fused (bench)",
                                        ["head_topk[bf16]"], drive, totals)
    require(counts["head_topk[fp32]"] == 0,
            "predict_topk_fused (bench) took the CUDA-core head_topk")
    require(tuple(fused.shape) == (BENCH_BATCH, RES, RES, BENCH_TOP_K)
            and bool(((fused >= 0) & (fused < NUM_CLASSES)).all()),
            f"predict_topk_fused output {tuple(fused.shape)}")
    with torch.inference_mode():
        ref = model.predict(depths[0], text, mask, BENCH_TOP_K,
                            scoring="pallas", return_embeddings=False)[0]
        feats = model.decode_features(depths[0]).contiguous()
    rows_b = weight_rows(model.decoder.output_conv.conv.weight.detach()).to(
        torch.bfloat16)
    table_b = l2_normalize(text.float(), dim=-1).to(torch.bfloat16)
    field = head_field(feats, rows_b)
    native = lambda ids: (ids[:, ::2, ::2].reshape(-1, ids.shape[-1]),)  # noqa
    rate = near_tie_check("predict_topk_fused vs DepthUNet.predict (bench)",
                          native(fused), native(ref), field, table_b,
                          tol=1e-3, min_rate=0.95)
    top1 = float((fused[..., 0] == ref[..., 0]).float().mean())
    log(f"  predict_topk_fused bf16 batch {BENCH_BATCH} @ {RES}^2, "
        f"{int(mask.sum())} candidates, top-{BENCH_TOP_K}: "
        f"{BENCH_BATCH * iters / seconds:.1f} maps/s "
        f"({1e3 * seconds / iters:.2f} ms/batch, host clock) on {card}; "
        f"ids vs predict {rate:.6f} (top-1 {top1:.6f})")
    del field, feats, fused, ref
    torch.cuda.empty_cache()

    depth = depths[0][:SERVE_BATCH]
    every = torch.ones(NUM_CLASSES, dtype=torch.bool, device=device)

    def drive_fp32():
        with torch.inference_mode():
            return predict_topk_fused(serve_model, depth, text, every, 1)

    fused, counts = run_path("predict_topk_fused fp32 (serve shape)",
                             ["head_topk[fp32]"], drive_fp32, totals)
    require(counts["head_topk[bf16]"] == 0,
            "predict_topk_fused fp32 took the tensor-core head_topk")
    require(tuple(fused.shape) == (SERVE_BATCH, RES, RES, 1),
            f"predict_topk_fused fp32 output {tuple(fused.shape)}")
    with torch.inference_mode():
        ref = serve_model.predict(depth, text, every, 1, scoring="pallas",
                                  return_embeddings=False)[0]
        feats = serve_model.decode_features(depth).contiguous()
    rows = weight_rows(serve_model.decoder.output_conv.conv.weight.detach())
    table = l2_normalize(text.float(), dim=-1)
    rate = near_tie_check("predict_topk_fused fp32 vs DepthUNet.predict "
                          "(serve shape)", native(fused), native(ref),
                          head_field(feats, rows), table)
    log(f"  predict_topk_fused fp32 batch {SERVE_BATCH} @ {RES}^2, all "
        f"{NUM_CLASSES} classes, top-1: ids vs predict {rate:.6f}")
    del feats, fused, ref
    torch.cuda.empty_cache()


def phase_pool_tv(device, totals):
    """masked_average_pooling over forward_native's field of the flagship
    train batch (bf16, batch 32), its segmentation taken nearest at the
    field's 128^2; then forward_native + fused_tv_loss + backward."""
    from rangeclip_tpu_torch.losses.pooling import masked_average_pooling
    from rangeclip_tpu_torch.ops.kernels.tv_loss import fused_tv_loss
    from rangeclip_tpu_torch.ops.resize import resize_nearest
    from rangeclip_tpu_torch.utils.profiling import train_setup

    state, data, _, _, _, _ = train_setup(
        device, batch=TRAIN_BATCH, bf16=True, present=TRAIN_PRESENT,
        seed=SEED + 15)
    model = state.model.eval()
    depth, seg = data["depth"][0], data["segmentation"][0]
    with torch.inference_mode():
        field, _, _ = model.forward_native(depth)
    seg_native = resize_nearest(seg[..., None], tuple(field.shape[1:3]))[..., 0]
    obj = pool_objects(device)
    pooled, _ = run_path(
        f"masked_average_pooling (forward_native field, bf16 batch "
        f"{TRAIN_BATCH})",
        ["masked_pooling"],
        lambda: masked_average_pooling(field, seg_native, obj), totals)
    want = masked_average_pooling(field, seg_native, obj, use_pallas="never")
    torch.cuda.synchronize()
    present = int((pooled[:-1].abs().sum(dim=1) > 0).sum())
    torch.testing.assert_close(pooled, want, rtol=1e-5, atol=1e-6)
    require(torch.equal(pooled[3], pooled[-1]) and present == TRAIN_PRESENT,
            f"masked_average_pooling: {present} non-zero rows")
    log(f"  masked_average_pooling {list(field.shape)} bf16, "
        f"{POOL_OBJECTS} ids: {present} present rows, within rtol 1e-5 of "
        f"use_pallas='never' (max |diff| {max_abs_err(pooled, want):.3g})")

    model.train()

    def drive():
        field, _, _ = model.forward_native(depth)
        loss = fused_tv_loss(field)
        loss.backward()
        return float(loss.detach())

    value, _ = run_path("forward_native + fused_tv_loss + backward (bf16)",
                        ["tv_loss[fwd]", "tv_loss[bwd]"], drive, totals)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    require(len(grads) > 0 and np.isfinite(value)
            and all(bool(torch.isfinite(g).all()) for g in grads),
            "fused_tv_loss backward not finite")
    log(f"  forward_native + fused_tv_loss + backward, bf16 batch "
        f"{TRAIN_BATCH}: TV {value:.6g}, {len(grads)} finite gradients")
    del state, data, field, model
    torch.cuda.empty_cache()


def plain_pixel_text_topk(field, text, candidate_mask=None, top_k=5,
                          want_values=True, candidate_ids=None):
    """``pixel_text_topk`` through its plain version, on any device."""
    from rangeclip_tpu_torch.ops.kernels.pixel_text_topk import (
        pixel_text_topk_plain,
    )

    C = text.shape[0]
    ids = (torch.arange(C, dtype=torch.int32, device=field.device)
           if candidate_ids is None else candidate_ids)
    if candidate_mask is not None:
        ids = torch.where(candidate_mask != 0, ids, -1)
    idx, val = pixel_text_topk_plain(field.reshape(-1, field.shape[-1]),
                                     text.to(field.dtype), ids, top_k)
    return idx, (val if want_values else None)


@contextlib.contextmanager
def packed_flags(flags: list):
    """Within the block, each CE call's device flag (n_contrast <= the
    packed capacity) is appended to ``flags``; calls without a packed table
    append nothing."""
    from rangeclip_tpu_torch.parallel import kernel_shard

    inner = kernel_shard.fused_pixel_text_ce

    def recording(*args, **kwargs):
        packed = args[6] if len(args) > 6 else kwargs.get("packed")
        if packed is not None:
            flags.append(packed[3])
        return inner(*args, **kwargs)

    kernel_shard.fused_pixel_text_ce = recording
    try:
        yield
    finally:
        kernel_shard.fused_pixel_text_ce = inner


class plain_versions:
    """Within the block, the losses, the decoder's normalisation and
    predict's candidate mask and scoring call the kernels' plain versions
    on CUDA tensors (the reference a kernel step is held against)."""

    def __enter__(self):
        from rangeclip_tpu_torch.losses import smoothness
        from rangeclip_tpu_torch.models import depth_unet
        from rangeclip_tpu_torch.ops.kernels import class_presence as cp
        from rangeclip_tpu_torch.ops.kernels import histogram as hist
        from rangeclip_tpu_torch.ops.kernels import pixel_text_ce as ce
        from rangeclip_tpu_torch.parallel import kernel_shard

        never = lambda *args: False  # noqa: E731
        self.saved = [
            (kernel_shard, "histogram", hist.histogram_plain),
            (kernel_shard, "class_presence", cp.class_presence_plain),
            (kernel_shard, "fused_pixel_text_ce",
             ce.pixel_text_ce_reference),
            (smoothness, "kernel_applicable", never),
            (depth_unet, "field_kernel_applicable", never),
            (depth_unet, "class_presence", cp.class_presence_plain),
            (depth_unet, "pixel_text_topk", plain_pixel_text_topk),
        ]
        self.saved = [(m, a, getattr(m, a), v) for m, a, v in self.saved]
        for module, attr, _, value in self.saved:
            setattr(module, attr, value)

    def __exit__(self, *exc):
        for module, attr, old, _ in self.saved:
            setattr(module, attr, old)


def compare_train_step(device, batch: int, bf16: bool,
                       present: int = TRAIN_PRESENT):
    """One kernel step and one plain step from the same weights, data and
    draws; returns the (kernel, plain) infos."""
    from rangeclip_tpu_torch.losses.hybrid import Draws
    from rangeclip_tpu_torch.losses.infonce import draw_pixels, sample_gumbel
    from rangeclip_tpu_torch.ops.kernels import _lib
    from rangeclip_tpu_torch.training.optim import make_optimizer
    from rangeclip_tpu_torch.utils.profiling import train_setup

    state, data, text, medium, hard, step = train_setup(
        device, batch=batch, bf16=bf16, present=present, seed=SEED + 10)
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    draws = [Draws(draw_pixels(batch, RES, RES, 0.7, gen, device),
                   (sample_gumbel(NUM_CLASSES, gen, device),
                    sample_gumbel(NUM_CLASSES, gen, device)))]
    plain_state = copy.deepcopy(state)
    plain_state.optimizer = make_optimizer(plain_state.model.parameters(),
                                           1e-4)
    args = (data, (0, 0), 1e-4, 0.0, 0.75, text, medium, hard, draws)
    _lib.reset_launch_counts()
    _, info = step(state, *args)
    launched = sum(_lib.launch_counts.values())
    _lib.reset_launch_counts()
    with plain_versions():
        _, plain_info = step(plain_state, *args)
    torch.cuda.synchronize()
    require(launched > 0 and sum(_lib.launch_counts.values()) == 0,
            "the plain step launched a kernel, or the kernel step none")
    return info, plain_info


def phase_train(device, card: str, totals):
    """The flagship train step, 3 steps; cli/train's fp32 microbatch and a
    bf16 step overflowing the contrast capacity, 3 steps each; then kernel
    vs plain steps.  Returns the flagship step's device time (ms a step,
    torch.profiler)."""
    from rangeclip_tpu_torch.utils.profiling import train_setup

    state, data, text, medium, hard, step = train_setup(
        device, batch=TRAIN_BATCH, bf16=True, present=TRAIN_PRESENT,
        seed=SEED + 12)
    before = {k: v.detach().clone() for k, v in
              state.model.state_dict().items() if v.is_floating_point()}
    times, losses = [], []

    def drive():
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = step(state, data, (SEED, i), 1e-4, 0.0, 0.75, text,
                           medium, hard)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append({k: float(v) for k, v in info.items()})

    run_path("train step (bf16, 1 x 32 at 256^2)", TRAIN_KERNELS, drive,
             totals)
    after = state.model.state_dict()
    changed = sum(not torch.equal(before[k], after[k]) for k in before)
    require(all(np.isfinite(list(l.values())).all() for l in losses),
            f"non-finite train info: {losses}")
    require(changed > 0, "no parameter changed")
    step_s = sum(times[1:]) / len(times[1:])
    flagship_ms = device_fields(lambda: step(
        state, data, (SEED, 3), 1e-4, 0.0, 0.75, text, medium, hard),
        calls=3)["device_ms"]
    log(f"  train: losses {[round(l['total_loss'], 4) for l in losses]}, "
        f"grad_norm {[round(l['grad_norm'], 4) for l in losses]}; "
        f"{changed} of {len(before)} float tensors changed; "
        f"{1e3 * step_s:.2f} ms/step (steps 2-3, host clock, synchronised; "
        f"first step {1e3 * times[0]:.1f} ms), {TRAIN_BATCH / step_s:.1f} "
        f"maps/s; {flagship_ms:.2f} ms of device time a step "
        f"(torch.profiler, 3 more steps) on {card}")
    del state, data
    torch.cuda.empty_cache()

    # cli/train's default precision at its microbatch (fp32, batch 16: the
    # member-only CE kernels over 90 members), and a bf16 step whose
    # contrast set overflows the capacity (200 members: the tensor-core CE
    # kernels return at once, the member-only ones write)
    for name, batch, bf16, present, expect in (
            (f"fp32 batch {CLI_TRAIN_BATCH}, 90 members", CLI_TRAIN_BATCH,
             False, TRAIN_PRESENT, ["pixel_text_ce[fwd]",
                                    "pixel_text_ce[bwd]", "live_rows"]),
            (f"bf16 batch {TRAIN_BATCH}, {OVERFLOW_PRESENT + 50} members "
             f"(overflow)", TRAIN_BATCH, True, OVERFLOW_PRESENT,
             ["pixel_text_ce[fwd]", "pixel_text_ce[bwd]",
              "pixel_text_ce_tc[fwd]", "pixel_text_ce_tc[bwd]",
              "live_rows"])):
        state, data, text, medium, hard, step = train_setup(
            device, batch=batch, bf16=bf16, present=present, seed=SEED + 14)
        times, flags = [], []

        def drive():
            with packed_flags(flags):
                for i in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, info = step(state, data, (SEED, i), 1e-4, 0.0, 0.75,
                                   text, medium, hard)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    require(np.isfinite(float(info["total_loss"])),
                            f"train step ({name}): loss {info}")

        _, counts = run_path(f"train step ({name})", expect, drive, totals)
        # the CE's branch: the flag (n_contrast <= capacity) of each call
        require(all(not bool(f) for f in flags) if bf16 else not flags,
                f"train step ({name}): packed flags {flags}")
        step_s = sum(times[1:]) / len(times[1:])
        log(f"  train step ({name}): {1e3 * step_s:.2f} ms/step (steps 2-3, "
            f"host clock, synchronised; first step {1e3 * times[0]:.1f} "
            f"ms), {counts['pixel_text_ce[bwd]'] / 3:g} pixel_text_ce[bwd] "
            f"launches a step, {len(flags)} CE calls with the full-table "
            f"flag on {card}")
        del state, data
        torch.cuda.empty_cache()

    # kernel step vs the same step through the plain versions: fp32 at
    # batch 8 (TF32 off; f32 summation orders: loss rtol 1e-4, grad_norm
    # 1e-3), bf16 at batch 32 and bf16 at batch 32 overflowing the contrast
    # capacity (the kernels round the bf16 pixel and the CE delta where the
    # plain versions do, but sum in other orders: loss rtol 2e-3, grad_norm
    # 2e-2)
    for batch, bf16, present, rtol_loss, rtol_norm in (
            (8, False, TRAIN_PRESENT, 1e-4, 1e-3),
            (TRAIN_BATCH, True, TRAIN_PRESENT, 2e-3, 2e-2),
            (TRAIN_BATCH, True, OVERFLOW_PRESENT, 2e-3, 2e-2)):
        info, plain = compare_train_step(device, batch, bf16, present)
        for key, rtol in (("total_loss", rtol_loss),
                          ("text_contrastive_loss", rtol_loss),
                          ("smoothness_loss", rtol_loss),
                          ("grad_norm", rtol_norm)):
            got, want = float(info[key]), float(plain[key])
            require(abs(got - want) <= rtol * abs(want),
                    f"train step {'bf16' if bf16 else 'fp32'} {key}: kernel "
                    f"{got} vs plain {want} (rtol {rtol})")
        log(f"  train step {'bf16' if bf16 else 'fp32'} batch {batch}, "
            f"{present} labels present, "
            f"kernels vs plain versions, same draws: loss "
            f"{float(info['total_loss']):.6f} vs "
            f"{float(plain['total_loss']):.6f}, grad_norm "
            f"{float(info['grad_norm']):.6f} vs {float(plain['grad_norm']):.6f}")
        torch.cuda.empty_cache()
    return flagship_ms


def compare_val_step(device) -> None:
    """One val step of the flagship batch (bf16, batch 32 at 256^2, C = 512)
    through the kernels, twice, and through the plain versions, with the
    same candidate-mask noise and loss draws: the two kernel passes give
    identical metrics; against the plain pass, top-k ids agree up to
    near-ties, the metrics within 4x the share of differing ids, the loss
    parts within 2e-3 relative."""
    from rangeclip_tpu_torch.evals.metrics import (
        metrics_finalize,
        metrics_init,
    )
    from rangeclip_tpu_torch.evals.validate import make_val_step
    from rangeclip_tpu_torch.losses.hybrid import Draws
    from rangeclip_tpu_torch.losses.infonce import draw_pixels, sample_gumbel
    from rangeclip_tpu_torch.ops.kernels import _lib
    from rangeclip_tpu_torch.utils.profiling import train_setup

    state, data, text, medium, hard, _ = train_setup(
        device, batch=TRAIN_BATCH, bf16=True, present=TRAIN_PRESENT,
        seed=SEED + 16)
    model = state.model.eval()
    batch = {k: v[0] for k, v in data.items()}
    images = batch.pop("image_embeddings")
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    gumbel = sample_gumbel(NUM_CLASSES, gen, device)
    draws = Draws(draw_pixels(TRAIN_BATCH, RES, RES, 0.7, gen, device),
                  (sample_gumbel(NUM_CLASSES, gen, device),
                   sample_gumbel(NUM_CLASSES, gen, device)))
    # equivalences: class c and c + 1 for odd c < 40, the rest alone
    eq = torch.eye(NUM_CLASSES, dtype=torch.bool, device=device)
    for c in range(1, TRAIN_PRESENT, 2):
        eq[c, c + 1] = eq[c + 1, c] = True
    ecm = eq.int().argmax(dim=1)
    step = make_val_step()

    def run():
        _lib.reset_launch_counts()
        acc, parts, pred = step(model, batch, (0, 0), 0.0, 0.75, text, medium,
                                hard, eq, ecm, images,
                                metrics_init(NUM_CLASSES, device),
                                candidate_gumbel=gumbel, draws=draws)
        torch.cuda.synchronize()
        return (metrics_finalize(acc), parts, pred,
                sum(_lib.launch_counts.values()))

    first, second = run(), run()
    require(first[0] == second[0], "two kernel val passes: metrics differ")
    with plain_versions():
        plain = run()
    require(first[3] > 0 and plain[3] == 0,
            "the plain val step launched a kernel, or the kernel step none")
    agree = float((first[2] == plain[2]).float().mean())
    require(agree >= 0.999, f"val step ids: agreement {agree}")
    diffs = {k: abs(first[0][k] - plain[0][k]) for k in first[0]}
    require(all(d <= 4 * (1 - agree) + 1e-6 for d in diffs.values()),
            f"val metrics differ beyond the differing ids: {diffs}")
    names = ("total", "text", "image", "smoothness")
    for name, got, want in zip(names, first[1].tolist(), plain[1].tolist()):
        require(abs(got - want) <= 2e-3 * abs(want),
                f"val loss part {name}: kernel {got} vs plain {want}")
    log(f"  val step bf16 batch {TRAIN_BATCH}, kernels (twice: identical "
        f"metrics, loss parts equal {torch.equal(first[1], second[1])}) vs "
        f"plain versions, same draws: id agreement {agree:.6f}, largest "
        f"metric difference {max(diffs.values()):.3g}; mIoU_tk "
        f"{first[0]['mIoU_tk']:.6f} vs {plain[0]['mIoU_tk']:.6f}; loss parts "
        f"{[round(v, 6) for v in first[1].tolist()]} vs "
        f"{[round(v, 6) for v in plain[1].tolist()]}")
    del state, data, model
    torch.cuda.empty_cache()


def phase_dim100(device) -> None:
    """The train step's loss and validation's scoring at D = 100, which the
    CE and top-k wrappers zero-pad to 104.  The model takes only
    embedding_dim % 32 == 0 (its ASPP's GroupNorm(32), as in the JAX
    package), so no model path reaches such a width; the layers after the
    model do.  The hybrid loss (the flagship step's: labels at 256^2 with
    40 present, label_upsample 2, capacity 128) runs on a random normalised
    [32, 128, 128, 100] field in fp32 and in bf16 with its gradient, and
    validation's scoring (build_candidate_mask with 50 negatives, then
    pixel_text_topk at k = 5, fp32) on 8 maps of it; each against the same
    call through the plain versions with the same draws."""
    from rangeclip_tpu_torch.losses.hybrid import Draws, compute_hybrid_loss
    from rangeclip_tpu_torch.losses.infonce import draw_pixels, sample_gumbel
    from rangeclip_tpu_torch.models.clip.provider import HashTextEmbedder
    from rangeclip_tpu_torch.models.depth_unet import build_candidate_mask
    from rangeclip_tpu_torch.ops.kernels.pixel_text_topk import (
        pixel_text_topk,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    D, h = 100, RES // 2
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    text = torch.from_numpy(HashTextEmbedder(D)(
        [f"class {i:03d}" for i in range(NUM_CLASSES)])).to(device)
    rng = np.random.default_rng(SEED + 22)
    medium, hard = (torch.from_numpy(rng.random((NUM_CLASSES, NUM_CLASSES))
                                     < 3 / NUM_CLASSES).to(device)
                    for _ in range(2))
    seg = torch.randint(1, TRAIN_PRESENT + 1, (TRAIN_BATCH, RES, RES),
                        device=device, generator=gen, dtype=torch.int32)
    base = l2_normalize(torch.randn(TRAIN_BATCH, h, h, D, device=device,
                                    generator=gen), dim=-1)
    draws = Draws(draw_pixels(TRAIN_BATCH, RES, RES, 0.7, gen, device),
                  (sample_gumbel(NUM_CLASSES, gen, device),
                   sample_gumbel(NUM_CLASSES, gen, device)))
    temp = torch.tensor(0.07, device=device)

    # the loss and its gradient: loss parts as the train step comparisons
    # hold them (fp32 rtol 1e-4, bf16 2e-3), the gradient's norm as their
    # grad_norm (fp32 1e-3, bf16 2e-2)
    for dtype, rtol_loss, rtol_norm, expect in (
            (torch.float32, 1e-4, 1e-3,
             ["pixel_text_ce[fwd]", "pixel_text_ce[bwd]", "live_rows"]),
            (torch.bfloat16, 2e-3, 2e-2,
             ["pixel_text_ce_tc[fwd]", "pixel_text_ce_tc[bwd]"])):
        def loss_and_grad():
            field = base.to(dtype).clone().requires_grad_()
            total, info = compute_hybrid_loss(
                field, seg, text, medium, hard, temp, temp, 0.0, 0.75,
                label_upsample=2, draws=draws)
            total.backward()
            return {k: v.detach() for k, v in info.items()}, field.grad

        (info, grad), launched = launched_by(loss_and_grad)
        with plain_versions():
            (plain, plain_grad), plain_launched = launched_by(loss_and_grad)
        require(not plain_launched, f"plain loss launched {plain_launched}")
        expect = expect + ["histogram", "class_presence"]
        require(all(launched.get(k) for k in expect),
                f"loss D={D} {dtype}: launches {launched}, expected {expect}")
        for key in ("total_loss", "text_contrastive_loss", "smoothness_loss"):
            got, want = float(info[key]), float(plain[key])
            require(abs(got - want) <= rtol_loss * abs(want),
                    f"loss D={D} {dtype} {key}: kernel {got} vs plain {want}")
        norm, plain_norm = float(grad.float().norm()), float(
            plain_grad.float().norm())
        require(abs(norm - plain_norm) <= rtol_norm * plain_norm,
                f"loss D={D} {dtype}: gradient norm {norm} vs {plain_norm}")
        log(f"  hybrid loss {dtype} [{TRAIN_BATCH}, {h}, {h}, {D}]: "
            f"text loss {float(info['text_contrastive_loss']):.6f} vs plain "
            f"{float(plain['text_contrastive_loss']):.6f}, gradient norm "
            f"{norm:.6g} vs {plain_norm:.6g}; launches {launched}")
        del grad, plain_grad
        torch.cuda.empty_cache()

    # validation's scoring of 8 maps (fp32)
    field = base[:8]
    gumbel = sample_gumbel(NUM_CLASSES, gen, device)
    table = l2_normalize(text.float(), dim=-1)

    def score(topk):
        mask = build_candidate_mask(seg[:8], NUM_CLASSES, 50, gumbel=gumbel)
        return topk(field, table, mask, 5)

    got, launched = launched_by(lambda: score(pixel_text_topk))
    with plain_versions():
        want, plain_launched = launched_by(
            lambda: score(plain_pixel_text_topk))
    require(not plain_launched, f"plain scoring launched {plain_launched}")
    expect = ["class_presence[labels]", "pixel_text_topk[fp32]", "live_rows"]
    require(all(launched.get(k) for k in expect),
            f"scoring D={D}: launches {launched}, expected {expect}")
    near_tie_check(f"validation scoring fp32 D={D}", got, want,
                   field.reshape(-1, D), table)
    log(f"  validation scoring fp32 [8, {h}, {h}, {D}], k=5: launches "
        f"{launched}")
    del base, field
    torch.cuda.empty_cache()


def phase_cli_train(tmp: str, device, totals) -> None:
    """cli/train --bf16 on a synthetic 256^2 dataset, validating at step 2;
    its checkpoint loaded strictly and run through predict; then
    cli/validate --baselines from that checkpoint.  Returns the dataset's
    paths (phase 11 trains on it and restores from the checkpoint)."""
    from rangeclip_tpu_torch.cli import train, validate
    from rangeclip_tpu_torch.data.labels import load_candidate_labels
    from rangeclip_tpu_torch.data.synthetic import write_synthetic_dataset
    from rangeclip_tpu_torch.evals.validate import validate_model
    from rangeclip_tpu_torch.models.clip.provider import HashTextEmbedder
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
    )
    from rangeclip_tpu_torch.models.interop import load_reference_pth

    t0 = time.perf_counter()
    data = write_synthetic_dataset(os.path.join(tmp, "synthetic"),
                                   n_samples=107, shape=(RES, RES),
                                   num_classes=NUM_CLASSES)
    log(f"  wrote 107 synthetic {RES}^2 samples in "
        f"{time.perf_counter() - t0:.1f} s")
    ckpt = os.path.join(tmp, "train")
    argv = ["--labeled_metadata_path", data["metadata"],
            "--labels_path", data["labels"],
            "--equivalence_dict_path", data["similarity"],
            "--checkpoint_path", ckpt, "--unet_architecture", "resnet",
            "--batch_size", "4", "--accumulation_steps", "8",
            "--n_height", str(RES), "--n_width", str(RES),
            "--learning_rates", "1e-4", "--learning_schedule", "1",
            "--max_steps", "2", "--n_step_per_summary", "1",
            "--n_step_per_checkpoint", "2",
            "--validation_start_step", "2", "--bf16"]
    require(train.build_parser().parse_args(argv).device == "cuda",
            "cli/train does not default to cuda")
    t0 = time.perf_counter()
    best, _ = run_path("cli/train (validating at step 2)",
                       [k for k in TRAIN_KERNELS
                        if not k.startswith("l2_normalize")]
                       + ["pixel_text_topk[bf16]"], lambda: train.main(argv),
                       totals)
    seconds = time.perf_counter() - t0
    results = open(os.path.join(ckpt, "results.txt")).read()
    val_lines = [line for line in results.splitlines()
                 if line.startswith("[Val]") or line.startswith("Best")]
    require(best.get("step") == 2 and len(val_lines) >= 6,
            f"cli/train validation: best {best}, log {val_lines}")
    for line in val_lines:
        log(f"    {line}")
    path = os.path.join(ckpt, "checkpoints",
                        "depth_segmentation_model-2.pth")
    require(os.path.exists(path), "cli/train wrote no step-2 checkpoint")
    model = DepthUNet(DepthUNetConfig(), device=device)
    model.load_state_dict(load_reference_pth(path), strict=True)
    labels = load_candidate_labels(data["labels"])
    table = torch.from_numpy(HashTextEmbedder(512)(labels)).to(device)
    depth = torch.randn(2, RES, RES, 1, device=device,
                        generator=torch.Generator(device=device).manual_seed(
                            SEED + 13))
    with torch.inference_mode():
        ids, _, _ = model.eval().predict(depth, table, None, 5)
    torch.cuda.synchronize()
    require(tuple(ids.shape) == (2, RES, RES, 5)
            and bool(((ids >= 0) & (ids < len(labels))).all()),
            f"predict with the trained checkpoint: {tuple(ids.shape)}")
    log(f"  cli/train --bf16, 2 steps of 8 x 4 at {RES}^2 and a validation: "
        f"{seconds:.1f} s with start-up; best results {best}; step-2 .pth "
        f"loads strictly and predicts [2, {RES}, {RES}, 5] ids in range")

    vargv = ["--labeled_metadata_path", data["metadata"],
             "--labels_path", data["labels"],
             "--equivalence_dict_path", data["similarity"],
             "--checkpoint_dir", os.path.join(ckpt, "checkpoints"),
             "--n_height", str(RES), "--n_width", str(RES), "--baselines"]
    require(validate.build_parser().parse_args(vargv).device == "cuda",
            "cli/validate does not default to cuda")
    out, _ = run_path("cli/validate --baselines", VAL_KERNELS,
                      lambda: validate.main(vargv), totals)
    require(out["step"] == 2 and np.isfinite(out["best"]["mIoU_tk"])
            and "majority" in out and "random" in out,
            f"cli/validate: {out}")
    log(f"  cli/validate --baselines (fp32, ResNet-18 UNet, D=512, "
        f"C={NUM_CLASSES}, step-2 checkpoint): mIoU_tk "
        f"{out['best']['mIoU_tk']:.4f}, majority pixel accuracy "
        f"{out['majority']['pixel_accuracy_t1']:.4f}, random "
        f"{out['random']['pixel_accuracy_t1']:.4f}")

    # validation throughput: cli/validate's model, loader and inputs; one
    # warm pass, then VAL_PASSES timed passes over the split (the loader
    # reads and decodes the PNGs anew each pass)
    _, step, model, loader, inputs = validate.load_validation(
        validate.build_parser().parse_args(vargv))

    def one_pass():
        with contextlib.redirect_stdout(io.StringIO()):
            validate_model(model, loader, step=step, best_results={},
                           **inputs)

    one_pass()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(VAL_PASSES):
        one_pass()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_maps = VAL_PASSES * len(loader.indices)
    log(f"  validation throughput (fp32, batch 8, {RES}^2, C={NUM_CLASSES}, "
        f"after a warm pass): {n_maps} maps in {seconds:.3f} s, "
        f"{n_maps / seconds:.1f} maps/s (host clock, loading included)")
    val_shape_topk(device, model, loader, inputs["text_table"])
    return data


def val_shape_topk(device, model, loader, text_table) -> None:
    """pixel_text_topk[fp32] at the validation pass's own shape: the
    candidate masks that validate_model draws for the split's batches (the
    present classes and 50 negatives, batch i keyed (VAL_SEED, i)), the
    model's fp32 field of the first batch, top-5; held to the plain version
    up to near-ties and timed, its bound from the live classes."""
    from rangeclip_tpu_torch.evals.validate import VAL_SEED, batch_to_device
    from rangeclip_tpu_torch.models.depth_unet import build_candidate_mask
    from rangeclip_tpu_torch.ops.kernels.pixel_text_topk import (
        pixel_text_topk,
        pixel_text_topk_plain,
    )
    from rangeclip_tpu_torch.training.train_step import microbatch_generator
    from rangeclip_tpu_torch.utils.math import l2_normalize

    table = l2_normalize(text_table.float(), dim=-1)
    C, D = table.shape
    masks, depth = [], None
    for i, batch in enumerate(loader):
        t = batch_to_device(batch, device, ("depth", "segmentation"))
        masks.append(build_candidate_mask(
            t["segmentation"], C, 50, generator=microbatch_generator(
                VAL_SEED, i, 0, torch.device("cpu"))))
        depth = t["depth"] if depth is None else depth
    lives = [int(m.sum()) for m in masks]
    mask, live = masks[0], lives[0]
    with torch.inference_mode():
        flat = model.native_field(depth, normalize=False).reshape(-1, D)
    ids = torch.where(mask, torch.arange(C, dtype=torch.int32,
                                         device=device), -1)
    got = pixel_text_topk(flat, table, mask, 5, True)
    want = pixel_text_topk_plain(flat, table, ids, 5)
    near_tie_check("pixel_text_topk fp32 validation shape", got, want, flat,
                   table)
    ms, plain_ms = time_pair(
        lambda: pixel_text_topk(flat, table, mask, 5, False),
        lambda: pixel_text_topk_plain(flat, table, ids, 5), 10, 3)
    N = flat.shape[0]
    b = bound(flat.numel() * 4 + live * D * 4 + N * 5 * 4,
              2.0 * N * D * live, "f32")
    log(f"  pixel_text_topk[fp32] validation shape N={N} D={D} C={C} k=5, "
        f"the split's candidate masks {min(lives)}-{max(lives)} classes "
        f"live, timed on batch 0's {live}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms (operations)")


def launched_by(fn):
    """(fn(), the kernels it launched: {name: launches}, the launched only),
    with the counts set to 0 just before it."""
    from rangeclip_tpu_torch.ops.kernels import _lib

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n for k, n in _lib.launch_counts.items() if n}


def phase_padded_widths(device) -> None:
    """The four wrappers that zero-pad D % 8 != 0 (pixel_text_ce forward
    and backward, pixel_text_topk, masked_pooling, tv_loss), at D = 20 and
    100 on main-path row counts, and masked_pooling at D = 2056 (two column
    chunks): each launches its kernel and holds to its plain version on
    the unpadded operands, at the tolerances of tests/test_torch_cuda.py."""
    from rangeclip_tpu_torch.ops.kernels.masked_pooling import (
        fused_masked_pooling,
        masked_pooling_plain,
    )
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import (
        fused_pixel_text_ce,
        pixel_text_ce_backward_plain,
        pixel_text_ce_plain,
    )
    from rangeclip_tpu_torch.ops.kernels.pixel_text_topk import (
        kernel_route,
        pixel_text_topk,
    )
    from rangeclip_tpu_torch.ops.kernels.tv_loss import (
        fused_tv_loss,
        tv_loss_grad,
        tv_loss_value,
    )
    from rangeclip_tpu_torch.utils.ce_rounding import plain_dx
    from rangeclip_tpu_torch.utils.math import l2_normalize

    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    pixels = (RES // 2) ** 2  # native pixels of one map

    def counted(names, fn):
        out, launched = launched_by(fn)
        counts = {k: launched.get(k, 0) for k in names}
        require(all(counts.values()), f"not launched: {counts}")
        return out, counts

    for D in (20, 100):
        # pixel_text_ce: fp32 over 90 members of C = 512 (S = 4, N =
        # 131,072: batch 8), and bf16 with a packed table of 128 (N =
        # 524,288: batch 32)
        for dtype, N, packed in ((torch.float32, 8 * pixels, False),
                                 (torch.bfloat16, TRAIN_BATCH * pixels,
                                  True)):
            x = torch.randn(N, D, device=device, generator=gen).to(dtype)
            table = l2_normalize(torch.randn(NUM_CLASSES, D, device=device,
                                             generator=gen), dim=-1).to(dtype)
            mask, members = contrast_set(gen, device, 90)
            labels = members[torch.randint(0, 90, (4, N), device=device,
                                           generator=gen)]
            valid = torch.randint(0, 3, (4, N), device=device,
                                  generator=gen).float()
            temp = torch.tensor(0.07, device=device)
            pk = None
            if packed:
                ids = torch.full((CAPACITY,), NUM_CLASSES, dtype=torch.int32,
                                 device=device)
                ids[:90] = members
                pk = (table[ids.clamp_max(NUM_CLASSES - 1).long()],
                      (ids < NUM_CLASSES).int(), ids,
                      torch.tensor(1, device=device))
            xs, ts = x.clone().requires_grad_(), temp.clone().requires_grad_()

            def run():
                loss = fused_pixel_text_ce(xs, ts, labels, valid, table,
                                           mask.int(), pk)
                loss.backward()
                return loss.detach()

            names = (["pixel_text_ce_tc[fwd]", "pixel_text_ce_tc[bwd]"]
                     if packed else []) + ["pixel_text_ce[fwd]",
                                           "pixel_text_ce[bwd]"]
            loss, counts = counted(names, run)
            args = (x, temp, labels, valid, table, mask.int())
            want = pixel_text_ce_plain(*args, packed=pk)
            dx, dt = pixel_text_ce_backward_plain(
                torch.tensor(1.0, device=device), *args, packed=pk)
            torch.testing.assert_close(loss, want, rtol=2e-5, atol=1e-4)
            torch.testing.assert_close(ts.grad, dt, rtol=2e-5, atol=1e-4)
            scale = dx.double().abs().amax(dim=-1, keepdim=True)
            require(tuple(xs.grad.shape) == (N, D), "CE d samples shape")
            err = (xs.grad.double() - dx.double()).abs()
            if dtype == torch.bfloat16:
                # at these widths no order of the logits' sums holds every
                # row of a flagship-sized draw within one bf16 ulp plus
                # 2^-10 of the row's largest entry: a flipped rounding of a
                # label's delta moves a row of 20-100 entries by more.  So
                # the plain formula with exactly rounded logits
                # (utils/ce_rounding.py) at this draw sets how many rows
                # may pass that check, and d samples as a whole holds to
                # CE_PAD_NORM of its norm; the same formula with the logits
                # rounded to bf16, a rounding fault, must break one of the
                # two.
                limit = bf16_ulp(dx) + scale * 2.0 ** -10

                def reading(d):
                    diff = (d.double() - dx.double()).abs()
                    return (int((diff > limit).any(dim=1).sum()),
                            float(diff.norm() / dx.double().norm()))

                past, rel = reading(xs.grad)
                one = torch.tensor(1.0, device=device)
                exact = reading(plain_dx(x, temp, one, labels, valid,
                                         *pk[:3], "exact"))
                fault = reading(plain_dx(x, temp, one, labels, valid,
                                         *pk[:3], "bf16"))
                allowed = ce_pad_rows(exact[0])
                require(rel <= CE_PAD_NORM,
                        f"pixel_text_ce bf16 D={D}: d samples {rel}")
                require(past <= allowed,
                        f"pixel_text_ce bf16 D={D}: {past} rows past the "
                        f"per-row check, exact logits {exact[0]}")
                require(fault[0] > ce_pad_rows(exact[0])
                        or fault[1] > CE_PAD_NORM,
                        f"pixel_text_ce bf16 D={D}: bf16 logits {fault} "
                        f"pass the check")
                detail = (f"d samples within {rel:.3g} of the plain norm "
                          f"(limit {CE_PAD_NORM:g}), {past} of {N} rows past "
                          f"one bf16 ulp + 2^-10 of the row's largest entry "
                          f"(at most {allowed}); exactly rounded logits "
                          f"{exact[0]} rows, {exact[1]:.3g}; bf16-rounded "
                          f"logits {fault[0]} rows, {fault[1]:.3g}")
            else:
                require(bool((err <= 1e-4 * scale + 1e-9).all()),
                        f"pixel_text_ce f32 D={D}: d samples {err.max()}")
                detail = "d samples within 1e-4 of each row's largest entry"
            ms, plain_ms = time_pair(
                lambda: fused_pixel_text_ce(xs, ts, labels, valid, table,
                                            mask.int(), pk).backward(),
                lambda: pixel_text_ce_backward_plain(
                    torch.tensor(1.0, device=device), *args, packed=pk),
                5, 2)
            log(f"  pixel_text_ce {dtype} D={D} N={N} "
                f"{'packed K=128' if packed else 'full C'}: launches "
                f"{counts}, value and d tau within rtol 2e-5, {detail}; "
                f"forward + backward {ms:.4f} ms, plain backward "
                f"{plain_ms:.4f} ms")
            del x, xs, labels, valid, dx

        # pixel_text_topk: fp32 (the CUDA-core kernel) and bf16 (the
        # tensor cores) over the full table, k = 5, near-ties allowed
        field = torch.randn(8 * pixels, D, device=device, generator=gen)
        text = l2_normalize(torch.randn(NUM_CLASSES, D, device=device,
                                        generator=gen), dim=-1)
        for dtype in (torch.float32, torch.bfloat16):
            f = field.to(dtype)
            route = kernel_route(dtype, D)
            got, _ = counted([route], lambda: pixel_text_topk(f, text,
                                                               top_k=5))
            want = plain_pixel_text_topk(f, text, top_k=5)
            near_tie_check(f"pixel_text_topk {dtype} D={D}", got, want, f,
                           text.to(dtype))
            ms, plain_ms = time_pair(
                lambda: pixel_text_topk(f, text, top_k=5),
                lambda: plain_pixel_text_topk(f, text, top_k=5), 10, 2)
            log(f"  pixel_text_topk {dtype} D={D} N={f.shape[0]} C="
                f"{NUM_CLASSES} k=5: one {route} launch, ids as the plain "
                f"version's up to near-ties; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms")
        del field, f

        # tv_loss: the flagship field's shape at D (bf16), backward
        # bit-equal, forward within rtol 1e-5
        x = (torch.randint(-6, 7, (TRAIN_BATCH, RES // 2, RES // 2, D),
                           device=device, generator=gen) / 4).to(
                               torch.bfloat16)
        xk = x.clone().requires_grad_()
        g = torch.tensor(1.0, device=device)

        def tv():
            value = fused_tv_loss(xk)
            value.backward()
            return value.detach()

        value, counts = counted(["tv_loss[fwd]", "tv_loss[bwd]"], tv)
        torch.testing.assert_close(value, tv_loss_value(x), rtol=1e-5,
                                   atol=0.0)
        require(torch.equal(xk.grad, tv_loss_grad(x, g)),
                f"tv_loss D={D}: backward differs from the plain VJP")
        log(f"  tv_loss bf16 {tuple(x.shape)}: launches {counts}, value "
            f"within rtol 1e-5, backward bit-equal")
        del x, xk

    # masked_pooling at D = 20, 100 and 2056 (column chunks of <= 2048)
    for D in (20, 100, 2056):
        P = (TRAIN_BATCH if D < 2048 else 4) * pixels
        emb = torch.randn(P, D, device=device, generator=gen).to(
            torch.bfloat16)
        seg = torch.randint(-1, TRAIN_PRESENT, (P,), device=device,
                            generator=gen, dtype=torch.int32)
        obj = pool_objects(device)
        (sums, counts), launched = counted(
            ["masked_pooling"], lambda: fused_masked_pooling(emb, seg, obj))
        want, want_counts = masked_pooling_plain(emb, seg, obj)
        scale = masked_pooling_plain(emb.abs(), seg, obj)[0]
        require(tuple(sums.shape) == (POOL_OBJECTS, D), "pooling shape")
        require(torch.equal(counts, want_counts),
                f"masked_pooling D={D}: counts differ")
        require(bool(((sums - want).abs() <= 1e-5 * scale + 1e-6).all()),
                f"masked_pooling D={D}: sums beyond 1e-5")
        require(launched["masked_pooling"] == -(-D // 2048),
                f"masked_pooling D={D}: {launched} launches")
        log(f"  masked_pooling bf16 [{P}, {D}], {POOL_OBJECTS} ids: "
            f"{launched['masked_pooling']} launch(es), counts exact, sums "
            f"within 1e-5 of the summed magnitudes")
        del emb, seg, sums, want, scale
    torch.cuda.empty_cache()


CLIP_TRAIN_KERNELS = ["histogram", "class_presence", "pixel_text_ce[fwd]",
                      "pixel_text_ce[bwd]", "tv_rowtile[fwd]",
                      "tv_rowtile[bwd]"]
# the bf16 MiT step: its field at H/4 gives 16 label slots, the tensor-core
# CE pair past 4 slots in both directions and never the member-only kernels
SLOTS_CE = ["pixel_text_ce_slots[fwd]", "pixel_text_ce_slots[bwd]"]
MEMBER_CE = ["pixel_text_ce[fwd]", "pixel_text_ce[bwd]"]
MIT_TRAIN_KERNELS = ["histogram", "class_presence", "live_rows", *SLOTS_CE,
                     "tv_rowtile[fwd]", "tv_rowtile[bwd]"]
BENCH_PREDICT_KERNELS = ["class_presence[labels]", "conv_score_topk"]
CLIP_LABELS = NUM_CLASSES  # the synthetic dataset's label table


def write_clip_files(tmp: str):
    """A full-width ViT-B/32 CLIP checkpoint in HF's layout with random
    weights from a seed, written as .safetensors, and a byte-level BPE
    vocabulary (every byte alone and as a word end, no merges) whose
    end-of-text token has the highest id, as in CLIP's.  Returns the three
    paths."""
    from rangeclip_tpu_torch.models.clip.convert import (
        hf_state_dict,
        write_safetensors,
    )
    from rangeclip_tpu_torch.models.clip.model import (
        CLIP_VIT_B32,
        CLIPTextTower,
        CLIPVisionTower,
    )
    from rangeclip_tpu_torch.models.clip.tokenizer import bytes_to_unicode

    t0 = time.perf_counter()
    towers = (CLIPTextTower(CLIP_VIT_B32,
                            generator=torch.Generator().manual_seed(SEED + 20)),
              CLIPVisionTower(CLIP_VIT_B32, generator=torch.Generator()
                              .manual_seed(SEED + 21)))
    sd = {k: v.numpy() for k, v in hf_state_dict(*towers).items()}
    ckpt = write_safetensors(os.path.join(tmp, "clip.safetensors"), sd)
    symbols = list(bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>"
                                                   for s in symbols])}
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    paths = (ckpt, os.path.join(tmp, "vocab.json"),
             os.path.join(tmp, "merges.txt"))
    with open(paths[1], "w") as f:
        json.dump(vocab, f)
    with open(paths[2], "w") as f:
        f.write("#version: 0.2\n")
    log(f"  wrote a random ViT-B/32 CLIP checkpoint ({len(sd)} tensors, "
        f"{sum(v.size for v in sd.values()) / 1e6:.1f} M parameters, "
        f"{os.path.getsize(ckpt) / 2 ** 20:.0f} MiB .safetensors) and a "
        f"{len(vocab)}-token vocabulary in {time.perf_counter() - t0:.1f} s")
    return paths


def transformer_flops(width: int, layers: int, tokens: int) -> float:
    """Operations (2 per multiply-add) of one sequence through pre-LN
    transformer layers: per token the four attention projections and the
    4x MLP (12 width^2), per layer the two attention products (2 tokens^2
    width)."""
    return 2.0 * layers * (12 * width * width * tokens
                           + 2 * tokens * tokens * width)


def train_argv(data, ckpt: str, *extra) -> list:
    return ["--labeled_metadata_path", data["metadata"],
            "--labels_path", data["labels"],
            "--equivalence_dict_path", data["similarity"],
            "--checkpoint_path", ckpt, "--n_height", str(RES),
            "--n_width", str(RES), "--n_step_per_summary", "1",
            "--n_step_per_checkpoint", "1", "--bf16", *extra]


def train_losses(ckpt: str) -> list:
    """The Loss/train_step scalars of a cli/train run, in step order."""
    with open(os.path.join(ckpt, "tensorboard-train", "events.csv")) as f:
        return [float(row["value"]) for row in csv.DictReader(f)
                if row["tag"] == "Loss/train_step"]


@contextlib.contextmanager
def counted_calls(cls, calls: list):
    """Record the input shape of every ``cls.forward`` call meanwhile."""
    forward = cls.forward

    def spy(self, x, *args):
        calls.append(tuple(x.shape))
        return forward(self, x, *args)

    cls.forward = spy
    try:
        yield calls
    finally:
        cls.forward = forward


def phase_clip_train(tmp: str, data, device, card: str, step_ms: float,
                     totals) -> None:
    """(a) cli/train --bf16, accumulation 1 x 32 at 256^2, 3 steps, with
    the CLIP towers built from a .safetensors checkpoint, vocab and merges;
    then the text precompute and the image tower timed alone, the tower's
    device time beside ``step_ms``, the flagship step's."""
    from rangeclip_tpu_torch.cli import train
    from rangeclip_tpu_torch.data.labels import load_candidate_labels
    from rangeclip_tpu_torch.models.clip.model import (
        CLIPTextTower,
        CLIPVisionTower,
    )
    from rangeclip_tpu_torch.models.clip.provider import (
        CLIPImageEmbedder,
        CLIPTextEmbedder,
        get_image_provider,
        get_text_provider,
    )

    clip = write_clip_files(tmp)
    ckpt = os.path.join(tmp, "clip_train")
    argv = train_argv(data, ckpt, "--unet_architecture", "resnet",
                      "--batch_size", str(TRAIN_BATCH),
                      "--accumulation_steps", "1",
                      "--learning_rates", "1e-4", "1e-4",
                      "--learning_schedule", "1", "2", "--max_steps", "3",
                      "--clip_checkpoint_path", clip[0],
                      "--clip_vocab_path", clip[1],
                      "--clip_merges_path", clip[2])
    text_calls, image_calls = [], []
    t0 = time.perf_counter()
    with counted_calls(CLIPTextTower, text_calls), \
            counted_calls(CLIPVisionTower, image_calls):
        run_path("cli/train --bf16 with the CLIP towers (1 x 32)",
                 CLIP_TRAIN_KERNELS, lambda: train.main(argv), totals)
    seconds = time.perf_counter() - t0
    losses = train_losses(ckpt)
    require(len(losses) == 3 and np.isfinite(losses).all(),
            f"cli/train with the CLIP towers: losses {losses}")
    require(text_calls == [(128, 77)] * (CLIP_LABELS // 128),
            f"text tower calls {text_calls}")
    require(image_calls == [(TRAIN_BATCH, 224, 224, 3)] * 3,
            f"image tower calls {image_calls}")
    log(f"  cli/train --bf16 with the CLIP towers: losses {losses}; text "
        f"tower {len(text_calls)} calls of [128, 77], image tower "
        f"{len(image_calls)} calls of [{TRAIN_BATCH}, 224, 224, 3]; "
        f"{seconds:.1f} s with start-up")

    labels = load_candidate_labels(data["labels"])
    text = get_text_provider(*clip, device=device)
    require(isinstance(text, CLIPTextEmbedder), "no CLIP text tower")
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = text(labels)
        times.append(time.perf_counter() - t0)
    require(table.shape == (CLIP_LABELS, 512) and np.isfinite(table).all(),
            f"text table {table.shape}")
    image = get_image_provider(clip[0], device=device)
    require(isinstance(image, CLIPImageEmbedder), "no CLIP image tower")
    crops = torch.randn(TRAIN_BATCH, 224, 224, 3, device=device,
                        generator=torch.Generator(device=device).manual_seed(
                            SEED + 22))
    ms = cuda_ms(lambda: image(crops), 10)
    dev = device_fields(lambda: image(crops), calls=5)
    share = dev["device_ms"] / (dev["device_ms"] + step_ms)  # device times
    cfg = image.tower.config
    n = (cfg.image_size // cfg.patch_size) ** 2
    image_ops = TRAIN_BATCH * (
        transformer_flops(cfg.vision_width, cfg.vision_layers, n + 1)
        + 2.0 * n * 3 * cfg.patch_size ** 2 * cfg.vision_width)
    text_cfg = text.tower.config
    text_ops = CLIP_LABELS * transformer_flops(
        text_cfg.text_width, text_cfg.text_layers, 77)
    image_bound = bound(0, image_ops, "f32")["bound_ms"]
    log(f"  text precompute of {CLIP_LABELS} labels (4 calls of [128, 77], "
        f"tokenizer included, host clock): {1e3 * times[0]:.1f} ms the "
        f"first time, {1e3 * times[1]:.1f} ms the second "
        f"({text_ops / 1e12:.3f} TFLOP, {text_ops / times[1] / 1e12:.1f} "
        f"TFLOP/s); image tower (fp32 ViT-B/32) on a window of "
        f"{TRAIN_BATCH} crops at 224^2: {ms:.3f} ms (CUDA events), "
        f"{dev['device_ms']:.3f} ms device time in "
        f"{dev['device_events']:g} events, {image_ops / 1e9:.1f} GFLOP: "
        f"bound {image_bound:.3f} ms at the f32 peak, "
        f"{100 * image_bound / dev['device_ms']:.1f}% of it; "
        f"{100 * share:.1f}% of the device time of a window beside phase "
        f"7's flagship step ({step_ms:.2f} ms of device time) on {card}")


@contextlib.contextmanager
def recorded_ce(calls: list):
    """Keep a detached copy of the operands of the train step's first
    fused_pixel_text_ce call meanwhile."""
    from rangeclip_tpu_torch.parallel import kernel_shard

    fn = kernel_shard.fused_pixel_text_ce

    def spy(*args):
        if not calls:
            copy_of = lambda t: t.detach().clone()  # noqa: E731
            calls.append(tuple(
                tuple(map(copy_of, a)) if isinstance(a, tuple)
                else None if a is None else copy_of(a) for a in args))
        return fn(*args)

    kernel_shard.fused_pixel_text_ce = spy
    try:
        yield calls
    finally:
        kernel_shard.fused_pixel_text_ce = fn


def hold_step_ce(name: str, args, card: str) -> None:
    """A train step's CE on its own operands, with the packed table as the
    step passed it (and with its flag set, where the step's contrast set
    overflowed the capacity) and over the full table: the value and both
    gradients against pixel_text_ce_reference at the flagship check's
    tolerances (rtol 2e-5 on the value and d tau, d samples within one
    bf16 ulp plus 2^-10 of the row's largest entry, or 1e-4 of it in f32);
    then forward and backward timed against the plain versions.  A bf16
    step past 4 slots must run the tensor-core pair past 4 slots in both
    directions in every form, and no other CE kernel."""
    from rangeclip_tpu_torch.ops.kernels import _lib
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import (
        fused_pixel_text_ce,
        pixel_text_ce_reference,
        slots_route,
        tc_route,
    )

    samples, temp, labels, valid, table, mask, packed = args
    D = samples.shape[-1]
    S = labels.shape[0]

    def run(fn, pk):
        xs = samples.clone().requires_grad_()
        ts = temp.clone().requires_grad_()
        loss = fn(xs, ts, labels, valid, table, mask, pk)
        loss.backward()
        return loss.detach(), xs.grad.reshape(-1, D), ts.grad

    forms = [("full table", None)]
    if packed is not None:
        forms.insert(0, ("packed as the step ran it", packed))
        if not bool(packed[3]):  # the step's contrast set overflowed K
            forms.insert(1, ("packed with the flag set", (
                *packed[:3], torch.ones_like(packed[3]))))
    ce_kernels = [k for k in _lib.launch_counts if k.startswith(
        "pixel_text_ce")]
    slots = slots_route(samples.reshape(-1, D), S)
    for form, pk in forms:
        torch.cuda.synchronize()
        before = dict(_lib.launch_counts)
        got = run(fused_pixel_text_ce, pk)
        torch.cuda.synchronize()
        ran = {k: _lib.launch_counts[k] - before[k] for k in ce_kernels}
        want = run(pixel_text_ce_reference, pk)
        torch.cuda.synchronize()
        if samples.dtype == torch.bfloat16 and S > 4:
            require(slots and ran == {k: int(k in SLOTS_CE)
                                      for k in ce_kernels},
                    f"{name} CE ({form}): not the tensor-core pair past 4 "
                    f"slots alone: {ran}")
        torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=0.0)
        torch.testing.assert_close(got[2], want[2], rtol=2e-5, atol=1e-6)
        scale = want[1].double().abs().amax(dim=-1, keepdim=True)
        if samples.dtype == torch.bfloat16:
            require(within_bf16_ulp(got[1], want[1], scale * 2.0 ** -10),
                    f"{name} CE ({form}): d samples beyond one bf16 ulp")
        else:
            err = (got[1].double() - want[1].double()).abs()
            require(bool((err <= 1e-4 * scale + 1e-12).all()),
                    f"{name} CE ({form}): d samples {float(err.max())}")
        ms, plain_ms = time_pair(lambda: run(fused_pixel_text_ce, pk),
                                 lambda: run(pixel_text_ce_reference, pk),
                                 5, 2)
        dev = device_fields(lambda: run(fused_pixel_text_ce, pk), calls=5)
        flag = None if pk is None else int(pk[3])
        tc = bool(flag and tc_route(samples.reshape(-1, D), pk[0], S))
        route = ("tensor cores past 4 slots" if slots else
                 "tensor cores" if tc else "member-only")
        # phase 2's CE bound: the field, labels and validity, the scored
        # rows (the packed table, else the selected table's members) read
        # once, d samples written once; 2 N C D operations forward, twice
        # that backward
        classes = (pk[0].shape[0] if tc else int(pk[1].sum()) if flag
                   else int(mask.sum()))
        esize = samples.element_size()
        io = (samples.numel() * esize + labels.numel() * 8
              + classes * D * esize)
        flops = 2.0 * (samples.numel() // D) * classes * D
        kind = "bf16" if samples.dtype == torch.bfloat16 else "f32"
        fwd_b = bound(io, flops, kind)
        bwd_b = bound(io + samples.numel() * esize, 2 * flops, kind)
        log(f"  {name} CE, {form} ({samples.dtype}, {list(samples.shape)}, "
            f"{S} slots, flag {flag}, {route}): value, d samples and d tau "
            f"within the flagship check's tolerances of the plain versions "
            f"(largest d samples error {max_abs_err(got[1], want[1]):.3g}); "
            f"forward and backward {ms:.4f} ms (CUDA events), "
            f"{dev['device_ms']:.4f} ms device time in "
            f"{dev['device_events']:g} events, plain {plain_ms:.4f} ms; "
            f"bound {fwd_b['bound_ms'] + bwd_b['bound_ms']:.4f} ms over "
            f"{classes} scored rows (forward {fwd_b['bound_ms']:.4f} by "
            f"{fwd_b['bound_by']}, backward {bwd_b['bound_ms']:.4f} by "
            f"{bwd_b['bound_by']}) on {card}")
        if S > 4:
            # a yardstick: the same sum as calls of 4 slots each (the
            # tensor-core kernels where the flag selects the packed table)
            def grouped(xs, ts, lab, val, tab, msk, p):
                return sum(fused_pixel_text_ce(xs, ts, lab[i:i + 4],
                                               val[i:i + 4], tab, msk, p)
                           for i in range(0, S, 4))

            dx4 = run(grouped, pk)[1].double()
            limit = (bf16_ulp(want[1]) if samples.dtype == torch.bfloat16
                     else 0.0) + scale * 2.0 ** -10
            past = int(((dx4 - want[1].double()).abs() > limit).any(
                dim=1).sum())
            ms4 = cuda_ms(lambda: run(grouped, pk), 5)
            dev4 = device_fields(lambda: run(grouped, pk), calls=5)
            log(f"  {name} CE, {form}, as {-(-S // 4)} calls of 4 slots "
                f"(yardstick): {ms4:.4f} ms (CUDA events), "
                f"{dev4['device_ms']:.4f} ms device time in "
                f"{dev4['device_events']:g} events; d samples past the "
                f"check in {past} of {want[1].shape[0]} rows")


def phase_restore_encoder(tmp: str, data, device, totals) -> None:
    """(b) cli/train --restore_path_encoder from phase 8's checkpoint, 2
    steps: every encoder parameter and BatchNorm statistic of both new
    checkpoints bit-equal to the restored ones, the decoder moved."""
    from rangeclip_tpu_torch.cli import train
    from rangeclip_tpu_torch.models.interop import load_reference_pth

    source = os.path.join(tmp, "train", "checkpoints")
    ckpt = os.path.join(tmp, "restore_train")
    argv = train_argv(data, ckpt, "--unet_architecture", "resnet",
                      "--batch_size", str(CLI_TRAIN_BATCH),
                      "--accumulation_steps", "1", "--learning_rates", "1e-4",
                      "--learning_schedule", "1", "--max_steps", "2",
                      "--restore_path_encoder", source)
    run_path("cli/train --restore_path_encoder (frozen)", CLIP_TRAIN_KERNELS,
             lambda: train.main(argv), totals)
    results = open(os.path.join(ckpt, "results.txt")).read()
    require("Restored encoder weights (frozen-encoder finetune)." in results,
            "no frozen-encoder restore line")
    want = load_reference_pth(os.path.join(
        source, "depth_segmentation_model-2.pth"))
    got = [load_reference_pth(os.path.join(
        ckpt, "checkpoints", f"depth_segmentation_model-{s}.pth"))
        for s in (1, 2)]
    enc = [k for k in want if k.startswith("encoder.")]
    dec = [k for k in want if k.startswith("decoder.")
           and want[k].is_floating_point()]
    for sd in got:
        bad = [k for k in enc if not torch.equal(sd[k], want[k])]
        require(not bad, f"restored encoder moved: {bad[:5]}")
    moved = sum(not torch.equal(got[0][k], got[1][k]) for k in dec)
    require(moved > 0 and np.isfinite(train_losses(ckpt)).all(),
            "the decoder did not train")
    log(f"  cli/train --restore_path_encoder: {len(enc)} encoder tensors "
        f"(BatchNorm statistics included) bit-equal to phase 8's step-2 "
        f"checkpoint after steps 1 and 2; {moved} of {len(dec)} decoder "
        f"tensors moved from step 1 to 2; losses {train_losses(ckpt)}")


def bench_model(name: str, model, fp32_state, device, card: str,
                totals) -> None:
    """A model through predict_folded at the bench configuration (bf16,
    batch 128, 384 slots, top-5) twice with identical checksums and its
    maps/s; conv_score_topk on its features and folded head against the
    plain version; then its weights in fp32 at batch 8 on the card against
    the same model on the CPU, labels up to near-ties."""
    from rangeclip_tpu_torch.models.clip.provider import HashTextEmbedder
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        build_candidate_indices,
        predict_folded,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    dgen = torch.Generator(device=device).manual_seed(SEED + 23)
    depths = [torch.randn(BENCH_BATCH, RES, RES, 1, device=device,
                          generator=dgen) for _ in range(2)]
    labels = [f"class {i:03d}" for i in range(NUM_CLASSES)]
    text = torch.from_numpy(HashTextEmbedder(512)(labels)).to(device)
    seg = torch.randint(0, 40, (BENCH_BATCH, RES, RES), device=device,
                        generator=dgen)

    def run():
        cand = build_candidate_indices(
            seg, NUM_CLASSES, BENCH_NEGATIVES, BENCH_SLOTS,
            generator=torch.Generator().manual_seed(SEED + 4))
        sums = []
        for _ in range(2):
            with torch.inference_mode():
                ids = predict_folded(model, depths[0], text,
                                     top_k=BENCH_TOP_K,
                                     candidate_indices=cand)
            require(ids.shape == (BENCH_BATCH, RES, RES, BENCH_TOP_K)
                    and bool(((ids >= 0) & (ids < NUM_CLASSES)).all()),
                    f"{name} bench ids {tuple(ids.shape)}")
            sums.append(int(ids.long().sum()))
        require(sums[0] == sums[1], f"{name} checksums differ: {sums}")
        iters = 6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            with torch.inference_mode():
                predict_folded(model, depths[i % 2], text, top_k=BENCH_TOP_K,
                               candidate_indices=cand)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        log(f"  {name} predict_folded bf16 batch {BENCH_BATCH} @ {RES}^2, "
            f"{BENCH_SLOTS} slots, top-{BENCH_TOP_K}: checksum {sums[0]} "
            f"twice; {BENCH_BATCH * iters / seconds:.1f} maps/s "
            f"({1e3 * seconds / iters:.2f} ms/batch, host clock) on {card}")
        return cand

    cand, _ = run_path(f"{name} bench predict", BENCH_PREDICT_KERNELS, run,
                       totals)
    hold_conv_score_topk(f"{name} decoder features", model, depths[0], text,
                         cand)
    del depths
    torch.cuda.empty_cache()

    fp32 = DepthUNet(dataclasses.replace(model.config, dtype=None),
                     device=device)
    fp32.load_state_dict(fp32_state, strict=True)
    fp32.eval()
    cpu = copy.deepcopy(fp32).cpu()
    depth = torch.randn(SERVE_BATCH, RES, RES, 1,
                        generator=torch.Generator().manual_seed(SEED + 24))
    with torch.inference_mode():
        got = predict_folded(fp32, depth.to(device), text, top_k=BENCH_TOP_K,
                             candidate_indices=cand, upsample=False)
        want = predict_folded(cpu, depth, text.cpu(), top_k=BENCH_TOP_K,
                              candidate_indices=cand.cpu(), upsample=False)
        field = fp32.native_field(depth.to(device), normalize=False)
    k = BENCH_TOP_K
    near_tie_check(f"{name} fp32 batch {SERVE_BATCH} card vs CPU",
                   (got.reshape(-1, k),), (want.reshape(-1, k).to(device),),
                   field.reshape(-1, field.shape[-1]),
                   l2_normalize(text, dim=-1))


def phase_mit(tmp: str, data, device, card: str, totals) -> None:
    """(c) cli/train --bf16 --unet_architecture mit, 2 steps, the CE of its
    first step held on that step's operands; its checkpoint at the bench
    configuration and against the CPU."""
    from rangeclip_tpu_torch.cli import train
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
    )
    from rangeclip_tpu_torch.models.interop import (
        load_reference_pth,
        widths_from_state_dict,
    )

    ckpt = os.path.join(tmp, "mit_train")
    argv = train_argv(data, ckpt, "--unet_architecture", "mit",
                      "--batch_size", str(CLI_TRAIN_BATCH),
                      "--accumulation_steps", "1", "--learning_rates", "1e-4",
                      "--learning_schedule", "1", "--max_steps", "2")
    t0 = time.perf_counter()
    ce_calls = []
    with recorded_ce(ce_calls):
        _, counts = run_path("cli/train --bf16 --unet_architecture mit",
                             MIT_TRAIN_KERNELS, lambda: train.main(argv),
                             totals)
    require(not any(counts[k] for k in MEMBER_CE),
            f"MiT cli/train: the member-only CE ran: {counts}")
    losses = train_losses(ckpt)
    require(len(losses) == 2 and np.isfinite(losses).all(),
            f"MiT cli/train losses {losses}")
    sd = load_reference_pth(os.path.join(
        ckpt, "checkpoints", "depth_segmentation_model-2.pth"))
    widths = widths_from_state_dict(sd)
    require(widths["unet_type"] == "mit"
            and widths["encoder_filters"] == (64, 128, 256, 512),
            f"MiT checkpoint widths {widths}")
    log(f"  MiT cli/train --bf16, 2 steps of 1 x {CLI_TRAIN_BATCH}: losses "
        f"{losses}; {time.perf_counter() - t0:.1f} s with start-up; "
        f"checkpoint widths {widths}")
    require(len(ce_calls) == 1 and ce_calls[0][2].shape[0] == 16,
            "the MiT step's CE did not take 16 label slots")
    hold_step_ce("MiT step", ce_calls[0], card)
    del ce_calls
    model = DepthUNet(DepthUNetConfig(**widths, dtype=torch.bfloat16),
                      device=device)
    model.load_state_dict(sd, strict=True)
    bench_model("MiT (stage widths 64-512)", model.eval(), sd, device, card,
                totals)


def phase_resnet50(device, card: str, totals) -> None:
    """(d) a ResNet-50 DepthUNet (random weights from a seed) at the bench
    configuration and against the CPU."""
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
    )

    model = DepthUNet(DepthUNetConfig(n_layer=50, dtype=torch.bfloat16),
                      device=device,
                      generator=torch.Generator().manual_seed(SEED + 25))
    bench_model("ResNet-50 UNet", model.eval(), model.state_dict(), device,
                card, totals)


def phase_mask_clip(data, device) -> None:
    """(e) evaluate_mask_clip on one batch of the synthetic split at 224^2
    with the random full-width vision tower: the card's ids against the
    CPU's up to near-ties, then the evaluator over that batch."""
    from rangeclip_tpu_torch.data.loader import setup_dataloaders
    from rangeclip_tpu_torch.evals.baselines import (
        evaluate_mask_clip,
        mask_clip_predict,
    )
    from rangeclip_tpu_torch.models.clip.crops import clip_normalize
    from rangeclip_tpu_torch.models.clip.provider import (
        HashTextEmbedder,
        get_image_provider,
    )
    from rangeclip_tpu_torch.models.depth_unet import build_candidate_mask
    from rangeclip_tpu_torch.ops.resize import resize_bilinear
    from rangeclip_tpu_torch.utils.math import l2_normalize

    _, val_loader, _, _, labels = setup_dataloaders(
        data["metadata"], data["labels"], (224, 224), SERVE_BATCH, n_epoch=1)
    batch = next(iter(val_loader))
    towers = {d: get_image_provider("random", device=d).tower
              for d in (device, torch.device("cpu"))}
    text_n = l2_normalize(torch.from_numpy(HashTextEmbedder(512)(labels)),
                          dim=-1)
    seg = torch.from_numpy(np.asarray(batch["segmentation"]))
    mask = build_candidate_mask(seg, len(labels), 50,
                                generator=torch.Generator().manual_seed(0))
    images = clip_normalize(torch.from_numpy(np.asarray(batch["image"],
                                                        np.float32)))
    ids = {d: mask_clip_predict(towers[d], images.to(d), (224, 224),
                                text_n.to(d), mask.to(d), top_k=5)
           for d in towers}
    with torch.inference_mode():
        patches = towers[device](images.to(device), return_patches=True)
    field = resize_bilinear(patches, (224, 224)).float()
    k = 5
    near_tie_check("MaskCLIP probe fp32 card vs CPU",
                   (ids[device].reshape(-1, k),),
                   (ids[torch.device("cpu")].reshape(-1, k).to(device),),
                   field.reshape(-1, field.shape[-1]), text_n.to(device))
    res = evaluate_mask_clip([batch], towers[device], text_n,
                             np.eye(len(labels), dtype=bool),
                             np.arange(len(labels)), len(labels))
    require(all(np.isfinite(v) for v in res.values()),
            f"evaluate_mask_clip: {res}")
    log(f"  evaluate_mask_clip, one batch of {SERVE_BATCH} at 224^2, random "
        f"ViT-B/32: mIoU_tk {res['mIoU_tk']:.4f}")


THROUGHPUT_KERNELS = {
    "auto": ["class_presence[labels]", "score_topk[knockout]",
             "conv_score_topk"],
    "default": ["class_presence[labels]", "pixel_text_topk[fp32]",
                "live_rows", "pixel_text_topk[bf16]"]}
ROBUSTNESS_KERNELS = ["class_presence[labels]", "pixel_text_topk[fp32]",
                      "live_rows"]
SWEEP_KEYS = ("pixel_accuracy_t1", "pixel_accuracy_tk", "mIoU_t1", "mIoU_tk")


def check_throughput(rows: list, what: str) -> None:
    for row in rows:
        require(row["pct_peak"] is not None and 0 < row["pct_peak"] <= 100
                and np.isfinite(row["maps_per_sec"])
                and row["maps_per_sec"] > 0
                and np.isfinite(row.get("ms_per_batch",
                                        row.get("s_per_step", np.nan))),
                f"{what}: {row}")


def phase_tools(tmp: str, data, device, totals) -> None:
    """12. The measurement and evaluation tools at full width, each through
    its entry point."""
    from rangeclip_tpu_torch.cli import benchmark, convert, train
    from rangeclip_tpu_torch.models.interop import load_reference_pth

    t0 = time.perf_counter()
    common = ["--resolution", str(RES), "--num_classes", str(NUM_CLASSES)]
    for path, expect in THROUGHPUT_KERNELS.items():
        rows, _ = run_path(
            f"cli.benchmark throughput --predict_path {path}", expect,
            lambda: benchmark.main([
                "throughput", *common, "--batch_sizes", str(BENCH_BATCH),
                "--both_precisions", "--predict_path", path,
                "--train_configs", "--iters", "10", "--rounds", "3"]),
            totals)
        require([r["predict_path"] for r in rows]
                == [{"auto": "folded"}.get(path, path)] * 2,
                f"throughput --predict_path {path}: {rows}")
        check_throughput(rows, f"throughput --predict_path {path}")
    rows, _ = run_path(
        "cli.benchmark throughput 1x32 bf16 --with_image_tower",
        TRAIN_KERNELS, lambda: benchmark.main([
            "throughput", *common, "--bf16", "--batch_sizes",
            "--train_configs", "1x32", "--with_image_tower", "--iters", "8",
            "--rounds", "3"]), totals)
    require([r["image_tower"] for r in rows] == [False, True],
            f"throughput train rows: {rows}")
    check_throughput(rows, "throughput 1x32 bf16")

    trace_dir = os.path.join(tmp, "profile")
    for mode, expect in (("predict", BENCH_PREDICT_KERNELS),
                         ("train", TRAIN_KERNELS)):
        out, _ = run_path(
            f"cli.benchmark profile --mode {mode}", expect,
            lambda: benchmark.main(["profile", *common, "--mode", mode,
                                    "--steps", "3", "--top", "12",
                                    "--trace_dir", trace_dir]), totals)
        summed = sum(b["ms"] for b in out["buckets"])
        require(abs(summed - out["window_ms"]) <= 0.01 * out["window_ms"]
                and {"encoder", "decoder"} <= {
                    b["interval"] for b in out["buckets"]}
                and os.path.exists(os.path.join(trace_dir, f"{mode}.json")),
                f"profile --mode {mode}: intervals {summed} ms against the "
                f"window's {out['window_ms']} ms, {out['buckets']}")
        log(f"  profile --mode {mode}: the intervals' {summed:.4f} ms/step "
            f"against the window's {out['window_ms']:.4f} ms of device "
            "events")

    checkpoints = os.path.join(tmp, "train", "checkpoints")
    rows, _ = run_path(
        "cli.benchmark robustness --subject depth", ROBUSTNESS_KERNELS,
        lambda: benchmark.main([
            "robustness", "--labeled_metadata_path", data["metadata"],
            "--labels_path", data["labels"],
            "--equivalence_dict_path", data["similarity"],
            "--checkpoint_dir", checkpoints, "--n_height", str(RES),
            "--n_width", str(RES), "--brightness_levels", "1.0", "0.1"]),
        totals)
    require(len(rows) == 2
            and all(np.isfinite(rows[0][k]) and rows[0][k] == rows[1][k]
                    for k in SWEEP_KEYS),
            f"robustness rows differ across brightness: {rows}")

    exported = os.path.join(tmp, "exported.pth")

    def round_trip():
        convert.main(["--checkpoint_dir", checkpoints, "--to_pth", exported])
        return convert.main(["--from_pth", exported, "--checkpoint_path",
                             os.path.join(tmp, "imported")])

    imported, _ = run_path("cli.convert --to_pth, then --from_pth", [],
                           round_trip, totals)
    want = load_reference_pth(os.path.join(
        checkpoints, "depth_segmentation_model-2.pth"))
    for path in (exported, os.path.join(
            imported, "depth_segmentation_model-2.pth")):
        got = load_reference_pth(path)
        require(sorted(got) == sorted(want)
                and all(torch.equal(got[k], want[k]) for k in want),
                f"cli.convert round trip: {path} differs")
    log(f"  cli.convert: phase 8's step-2 checkpoint exported and imported "
        f"again, {len(want)} tensors bit-equal")

    ckpt = os.path.join(tmp, "profile_train")
    traces = os.path.join(tmp, "train_trace")
    argv = train_argv(data, ckpt, "--unet_architecture", "resnet",
                      "--batch_size", str(CLI_TRAIN_BATCH),
                      "--accumulation_steps", "1",
                      "--learning_rates", "1e-4", "1e-4",
                      "--learning_schedule", "1", "2", "--max_steps", "4",
                      "--profile_dir", traces)
    run_path("cli/train --profile_dir (4 steps)", CLIP_TRAIN_KERNELS,
             lambda: train.main(argv), totals)
    written = os.listdir(traces)
    require(len(written) == 1, f"cli/train --profile_dir wrote {written}")
    with open(os.path.join(traces, written[0])) as f:
        kernels = sum(e.get("cat") == "kernel"
                      for e in json.load(f)["traceEvents"])
    losses = train_losses(ckpt)
    require(len(losses) == 4 and np.isfinite(losses).all()
            and kernels > 0,
            f"cli/train --profile_dir: losses {losses}, {kernels} kernel "
            "events")
    log(f"  cli/train --profile_dir: a Chrome trace of steps 2-4 with "
        f"{kernels} kernel events; phase 12 took "
        f"{time.perf_counter() - t0:.1f} s")


THRESHOLDS = (0.9, 0.85, 0.8, 0.75)  # cli.setup similarity-sets' defaults
SAMPLER_KERNELS = [k for k in TRAIN_KERNELS if k != "histogram"]
BLOCK_RTOL = 1e-4  # card against CPU in f32 (TF32 off): of the max |output|


def set_lists(path: str) -> list:
    with open(path) as f:
        return [{k: json.loads(row[k]) for k in ("same", "medium", "hard")}
                for row in csv.DictReader(f)]


def phase_similarity_sets(tmp: str, data, device, card: str) -> None:
    """(a) cli.setup similarity-sets over the 512 labels with phase 11's
    ViT-B/32 checkpoint and vocabulary, the text tower on the card, then on
    the CPU: the same sets but for pairs within 1e-5 of a threshold."""
    from rangeclip_tpu_torch.cli import setup
    from rangeclip_tpu_torch.data.labels import load_candidate_labels
    from rangeclip_tpu_torch.models.clip.provider import get_text_provider
    from rangeclip_tpu_torch.setup_tools.similarity_sets import (
        label_similarity,
    )

    clip = [os.path.join(tmp, name) for name in
            ("clip.safetensors", "vocab.json", "merges.txt")]
    require(all(os.path.exists(p) for p in clip), "phase 11's CLIP files")
    outs, seconds = {}, {}
    for where in ("cuda", "cpu"):
        outs[where] = os.path.join(tmp, f"similarity_{where}.csv")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            setup.main(["similarity-sets", "--labels_path", data["labels"],
                        "--output_csv", outs[where],
                        "--clip_checkpoint_path", clip[0],
                        "--clip_vocab_path", clip[1],
                        "--clip_merges_path", clip[2], "--device", where])
        torch.cuda.synchronize()
        seconds[where] = time.perf_counter() - t0
    labels = load_candidate_labels(data["labels"])
    sim = label_similarity(labels, get_text_provider(*clip, device=device))
    near = np.min([np.abs(sim - t) for t in THRESHOLDS], axis=0) <= 1e-5
    got, want = set_lists(outs["cuda"]), set_lists(outs["cpu"])
    require(len(got) == len(want) == len(labels), "similarity-sets rows")
    members = excused = 0
    for i, (g, w) in enumerate(zip(got, want)):
        for key in g:
            members += len(g[key])
            diff = set(g[key]) ^ set(w[key])
            excused += len(diff)
            require(all(near[i, j] for j in diff),
                    f"similarity-sets row {i} {key}: card {g[key]} vs CPU "
                    f"{w[key]}")
    log(f"  cli.setup similarity-sets (ViT-B/32 text tower, {len(labels)} "
        f"labels, tokenizer and the CSV included, host clock): "
        f"{seconds['cuda']:.2f} s with --device cuda, {seconds['cpu']:.2f} "
        f"s with --device cpu on {card}; {members} set members, the same "
        f"on both but {excused} within 1e-5 of a threshold")


def phase_native(tmp: str, data, card: str) -> None:
    """(b) the native library built from the sources on the card's host,
    phase 8's PNGs decoded byte-identical to PIL, the native depth
    transform within one ulp of the numpy one."""
    from pathlib import Path

    from PIL import Image

    from rangeclip_tpu_torch import native
    from rangeclip_tpu_torch.data.transforms import (
        lower_median_np,
        resize_nearest_np,
    )

    t0 = time.perf_counter()
    built = native.build(Path(tmp) / "native_build")
    build_s = time.perf_counter() - t0
    root = os.path.dirname(data["metadata"])
    with open(data["metadata"]) as f:
        rows = list(csv.DictReader(f))
    paths = [os.path.join(root, row[key]) for row in rows
             for key in ("image_path", "depth_path", "label_path")]
    native.pil_fallbacks.reset()
    t0 = time.perf_counter()
    decoded = [native.decode_png_native(p) for p in paths]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with_pil = []
    for p in paths:
        with Image.open(p) as image:
            with_pil.append(np.asarray(image))
    pil_s = time.perf_counter() - t0
    require(native.pil_fallbacks.value == 0, "a synthetic PNG took PIL")
    for p, got, want in zip(paths, decoded, with_pil):
        require(got.dtype == want.dtype and got.tobytes() == want.tobytes(),
                f"native decode of {p} differs from PIL")
    worst = 0.0
    for depth in decoded[1::3]:
        d = depth.astype(np.float32)
        for size in ((RES, RES), (224, 224)):
            got = native.depth_transform_native(d, size)
            resized = resize_nearest_np(d, size)
            want = resized / lower_median_np(resized)
            ulps = np.abs(got - want) / np.spacing(np.abs(want))
            worst = max(worst, float(ulps.max()))
    require(worst <= 1.0, f"native depth transform {worst} ulp off numpy")
    log(f"  native library built from its sources in {build_s:.2f} s "
        f"({built.name}); {len(paths)} PNGs of phase 8's set ({RES}^2 RGB, "
        f"16-bit depth and labels) decoded byte-identical to PIL, "
        f"{1e3 * native_s / len(paths):.3f} ms a file natively against "
        f"{1e3 * pil_s / len(paths):.3f} ms with PIL (host clock, one "
        f"thread, warm file cache); the depth transform at {RES}^2 and "
        f"224^2 within {worst:g} ulp of numpy on {card}")


def phase_loader(data, card: str) -> None:
    """(c) cli.benchmark loader over phase 8's split: both rows."""
    from rangeclip_tpu_torch.cli import benchmark

    with contextlib.redirect_stdout(io.StringIO()):
        rows = benchmark.main([
            "loader", "--labeled_metadata_path", data["metadata"],
            "--labels_path", data["labels"], "--n_height", str(RES),
            "--n_width", str(RES), "--batch_size", "16", "--num_workers",
            "8"])
    require([r["path"] for r in rows] == ["native-c++", "numpy"]
            and rows[0]["pil_files"] == 0
            and all(r["maps_per_sec"] > 0 for r in rows),
            f"cli.benchmark loader: {rows}")
    log(f"  cli.benchmark loader ({RES}^2, batch 16, 8 threads, host "
        f"clock): native-c++ {rows[0]['maps_per_sec']} maps/s, numpy "
        f"{rows[1]['maps_per_sec']} maps/s on {card}")


def write_setup_fixtures(root: str) -> dict:
    """Synthetic inputs of every host subcommand of cli.setup (the JAX
    package's tests/test_setup_cli.py fixtures, grown): VOID image and
    depth directories, raw labels and label PNGs, a metadata CSV,
    detection dumps, a labeled NYUv2 .mat (v5, scipy) and, where h5py is
    installed, NYUv2 .h5 scenes and a v7.3 .mat."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.default_rng(SEED + 30)
    for sub in ("void/image", "void/depth", "labelpngs", "dets"):
        os.makedirs(os.path.join(root, sub))
    for i in range(16):
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), np.uint8)).save(
            os.path.join(root, f"void/image/{i:03d}.png"))
        # 16-bit grayscale PNGs, as PIL writes a mode "I" image
        Image.fromarray(rng.integers(0, 5000, (480, 640)).astype(
            np.uint16)).save(os.path.join(root, f"void/depth/{i:03d}.png"))
        Image.fromarray(rng.integers(0, 38, (480, 640)).astype(
            np.uint16)).save(os.path.join(root, f"labelpngs/{i:03d}.png"))
        with open(os.path.join(root, f"dets/{i:03d}.txt"), "w") as f:
            for det in rng.random((40, 6)):
                f.write(f"{int(det[0] * 30)} {det[1]:.6f} {det[2]:.6f} "
                        f"{det[3] / 3:.6f} {det[4] / 3:.6f} {det[5]:.6f}\n")
    with open(os.path.join(root, "raw_labels.txt"), "w") as f:
        # 37 raw labels, 13 once lowercased and deduplicated
        f.write("".join(f"{'CLASS' if i % 2 else 'class'} {i % 13}\n"
                        for i in range(37)))
    with open(os.path.join(root, "meta.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image", "depth", "object_id"])
        for k in range(400):
            w.writerow([f"i{k}.png", f"d{k}.png", int(rng.integers(1, 9))])
    N, H, W = 4, 480, 640
    images = rng.integers(0, 256, (N, H, W, 3)).astype(np.uint8)
    depths = rng.uniform(0.5, 9.0, (N, H, W)).astype(np.float32)
    labels = np.zeros((N, H, W), np.uint16)
    for n in range(N):
        for obj in range(1, 6):
            y, x = rng.integers(0, H - 60), rng.integers(0, W - 60)
            labels[n, y:y + 60, x:x + 60] = obj + 10 * n
    savemat(os.path.join(root, "labeled_v5.mat"),
            {"images": images.transpose(1, 2, 3, 0),
             "depths": depths.transpose(1, 2, 0),
             "labels": labels.transpose(1, 2, 0)})
    out = {"objects": int(sum(len(np.unique(l)) - 1 for l in labels)),
           "h5py": importlib.util.find_spec("h5py") is not None}
    if out["h5py"]:
        import h5py

        with h5py.File(os.path.join(root, "labeled_v73.mat"), "w") as f:
            f["images"] = images.transpose(0, 3, 2, 1)
            f["depths"] = depths.transpose(0, 2, 1)
            f["labels"] = labels.transpose(0, 2, 1)
        for i in range(2):
            with h5py.File(os.path.join(root, f"scene{i}.h5"), "w") as f:
                f["rgb"] = images[i].transpose(2, 0, 1)
                f["depth"] = depths[i]
    return out


def phase_setup_tools(tmp: str, card: str) -> None:
    """(d) every host subcommand of cli.setup on synthetic fixtures; the
    whole run never imports pandas."""
    from rangeclip_tpu_torch.cli import setup

    root = os.path.join(tmp, "setup")
    t0 = time.perf_counter()
    fixtures = write_setup_fixtures(os.path.join(root, "in"))
    fixture_s = time.perf_counter() - t0
    src = lambda *p: os.path.join(root, "in", *p)  # noqa: E731
    dst = lambda *p: os.path.join(root, "out", *p)  # noqa: E731
    runs = [
        ("cleanup-labels", ["--raw_labels", src("raw_labels.txt"),
                            "--label_png_glob", src("labelpngs/*.png"),
                            "--output_dir", dst("clean"), "--labels_csv",
                            dst("clean.csv"), "--frequency_csv",
                            dst("freq.csv")]),
        ("void-train-files", ["--image_dir", src("void/image"),
                              "--depth_dir", src("void/depth"),
                              "--image_list_out", dst("img.txt"),
                              "--depth_list_out", dst("dep.txt")]),
        ("nyu-labeled", ["--mat_path", src("labeled_v5.mat"),
                         "--output_dir", dst("labeled_v5")]),
        ("combine-metadata", ["--inputs", src("meta.csv"), src("meta.csv"),
                              "--output_csv", dst("all.csv")]),
        ("remove-small", ["--metadata_csv", src("meta.csv"), "--output_csv",
                          dst("pruned.csv"), "--min_count", "50"]),
        ("pseudo-gt", ["--detections_glob", src("dets/*.txt"),
                       "--output_dir", dst("nms")])]
    if fixtures["h5py"]:
        runs += [("nyu-labeled", ["--mat_path", src("labeled_v73.mat"),
                                  "--output_dir", dst("labeled_v73")]),
                 ("nyu-crops", ["--h5_glob", src("scene*.h5"),
                                "--output_dir", dst("crops")])]
    os.makedirs(dst())
    seconds = {}
    for name, argv in runs:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            setup.main([name, *argv])
        seconds[f"{name} {os.path.basename(argv[1])}"] = round(
            time.perf_counter() - t0, 3)
    with open(dst("clean.csv")) as f:
        require(len(f.read().splitlines()) == 1 + 13, "cleanup-labels")
    require(len(os.listdir(dst("clean"))) == 16
            and len(open(dst("img.txt")).read().splitlines()) == 16,
            "cleanup-labels / void-train-files outputs")
    for out in ("labeled_v5",) + (("labeled_v73",) if fixtures["h5py"]
                                  else ()):
        with open(dst(out, "metadata.csv")) as f:
            require(len(list(csv.DictReader(f))) == fixtures["objects"],
                    f"nyu-labeled ({out}) rows")
    with open(dst("all.csv")) as f:
        require(len(list(csv.DictReader(f))) == 800, "combine-metadata")
    require(len(os.listdir(dst("nms"))) == 16, "pseudo-gt outputs")
    require("pandas" not in sys.modules, "the port imported pandas")
    skipped = ("" if fixtures["h5py"] else "; nyu-crops and a v7.3 "
               "nyu-labeled not run: this machine has no h5py")
    log(f"  cli.setup on synthetic 480x640 fixtures (written in "
        f"{fixture_s:.1f} s), seconds each: {seconds}{skipped}; pandas "
        f"never imported on {card}")


def phase_multinomial_train(device, card: str, totals) -> None:
    """(e) the flagship bf16 train step with the multinomial sampler, 3
    steps; the sampler's device time beside the histogram's."""
    from rangeclip_tpu_torch.losses.infonce import (
        sample_pixel_multiplicities,
        sample_pixel_multiplicities_multinomial,
    )
    from rangeclip_tpu_torch.utils.profiling import train_setup

    state, data, text, medium, hard, step = train_setup(
        device, batch=TRAIN_BATCH, bf16=True, present=TRAIN_PRESENT,
        seed=SEED + 31, res=RES, pixel_sampler="multinomial")
    losses, times = [], []

    def drive():
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = step(state, data, (SEED, i), 1e-4, 0.0, 0.75, text,
                           medium, hard)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append({k: float(v) for k, v in info.items()})

    _, counts = run_path("train step, multinomial sampler (bf16, 1 x 32)",
                         SAMPLER_KERNELS, drive, totals)
    require(counts["histogram"] == 0, "the multinomial step ran the "
            "histogram kernel")
    require(all(np.isfinite(list(l.values())).all() for l in losses),
            f"multinomial train step: {losses}")
    target = data["segmentation"][0]
    gen = torch.Generator(device=device).manual_seed(SEED + 32)
    n_total = RES * RES
    weights, _ = sample_pixel_multiplicities_multinomial(
        target, slots=2, generator=gen)
    per_image = weights.reshape(4, TRAIN_BATCH, -1).sum(dim=(0, 2))
    require(bool((per_image == int(0.7 * n_total)).all()),
            f"multinomial counts per image {per_image.tolist()}")
    sampler = {
        "multinomial": lambda: sample_pixel_multiplicities_multinomial(
            target, slots=2, generator=gen),
        "histogram": lambda: sample_pixel_multiplicities(
            target, slots=2, generator=gen)}
    dev = {name: device_fields(fn, calls=5) for name, fn in sampler.items()}
    step_s = sum(times[1:]) / len(times[1:])
    log(f"  train step with the multinomial sampler: losses "
        f"{[round(l['total_loss'], 4) for l in losses]}, "
        f"{1e3 * step_s:.2f} ms/step (steps 2-3, host clock); the sampler "
        f"at [{TRAIN_BATCH}, {RES}, {RES}], 2 x 2 slots: multinomial "
        f"{dev['multinomial']['device_ms']:.4f} ms device time in "
        f"{dev['multinomial']['device_events']:g} events, histogram "
        f"{dev['histogram']['device_ms']:.4f} ms in "
        f"{dev['histogram']['device_events']:g} (draws, kernel, "
        f"slotting; torch.profiler) on {card}")
    del state, data
    torch.cuda.empty_cache()


def block_cases():
    """(name, port block factory on a device, input shape NCHW, extra
    call arguments) at the UNet's widths."""
    from rangeclip_tpu_torch.ops import blocks as b

    return [
        ("DepthwiseSeparableConv2d", lambda d, g: b.DepthwiseSeparableConv2d(
            128, 128, 3, 2, use_batch_norm=True, device=d, generator=g),
         (8, 128, 64, 64), ()),
        ("AtrousConv2d", lambda d, g: b.AtrousConv2d(
            256, 256, 3, 2, use_batch_norm=True, device=d, generator=g),
         (8, 256, 32, 32), ()),
        ("TransposeConv2d", lambda d, g: b.TransposeConv2d(
            256, 128, 3, use_batch_norm=True, device=d, generator=g),
         (8, 256, 32, 32), ()),
        ("UpConv2d", lambda d, g: b.UpConv2d(
            128, 64, 3, use_instance_norm=True, device=d, generator=g),
         (8, 128, 48, 48), ((96, 96),)),
        ("FullyConnected", lambda d, g: b.FullyConnected(
            512, 512, device=d, generator=g), (32, 512), ()),
        ("AtrousResNetBlock", lambda d, g: b.AtrousResNetBlock(
            256, 512, 2, use_batch_norm=True, device=d, generator=g),
         (8, 256, 32, 32), ()),
        ("VGGNetBlock", lambda d, g: b.VGGNetBlock(
            64, 128, 2, 2, use_batch_norm=True, device=d, generator=g),
         (8, 64, 128, 128), ()),
        ("AtrousVGGNetBlock", lambda d, g: b.AtrousVGGNetBlock(
            128, 128, 2, 4, use_batch_norm=True, use_depthwise_separable=True,
            device=d, generator=g), (8, 128, 64, 64), ()),
        ("AtrousSpatialPyramidPooling", lambda d, g:
         b.AtrousSpatialPyramidPooling(512, 256, (6, 12, 18),
                                       use_batch_norm=True, device=d,
                                       generator=g), (8, 512, 16, 16), ()),
        ("SpatialPyramidPooling", lambda d, g: b.SpatialPyramidPooling(
            128, 64, (2, 4, 8), use_batch_norm=True, device=d, generator=g),
         (8, 128, 64, 64), ())]


def phase_blocks(device, card: str) -> None:
    """(f) the ten library blocks in f32 on the card against the CPU, same
    weights and inputs, in eval and train mode."""
    worst = {}
    for name, make, shape, args in block_cases():
        cpu = make(torch.device("cpu"), torch.Generator().manual_seed(7))
        card_block = copy.deepcopy(cpu).to(device)
        x = torch.randn(*shape, generator=torch.Generator().manual_seed(8))
        errs = []
        for train_mode in (False, True):
            cpu.train(train_mode)
            card_block.train(train_mode)
            with torch.no_grad():
                want = cpu(x, *args)
                got = card_block(x.to(device), *args).cpu()
            scale = float(want.abs().max())
            errs.append(max_abs_err(got, want) / scale)
            require(got.shape == want.shape and errs[-1] <= BLOCK_RTOL,
                    f"{name} ({'train' if train_mode else 'eval'}): card "
                    f"against CPU {errs[-1]:.3g} of the max |output|")
        worst[name] = float(f"{max(errs):.3g}")
    log(f"  the ten library blocks, f32 (TF32 off), card against CPU, "
        f"eval and train mode, error over the max |output| (limit "
        f"{BLOCK_RTOL:g}): {worst}")


def phase_data_prep(tmp: str, data, device, card: str, totals) -> None:
    """13. The offline data-prep CLI, the native data path, the multinomial
    sampler and the block library."""
    t0 = time.perf_counter()
    marks = []
    for part in (lambda: phase_similarity_sets(tmp, data, device, card),
                 lambda: phase_native(tmp, data, card),
                 lambda: phase_loader(data, card),
                 lambda: phase_setup_tools(tmp, card),
                 lambda: phase_multinomial_train(device, card, totals),
                 lambda: phase_blocks(device, card)):
        part()
        marks.append(round(time.perf_counter() - t0, 1))
    log(f"  phase 13 (a)-(f) ended at {marks} s")


# phase 14's sharded predicts: (precision, predict path, batch, grid, top-k,
# the kernel each cell's scoring takes)
SHARDED_RUNS = (
    ("bf16", "folded", 2 * BENCH_BATCH, (2, 2), BENCH_TOP_K,
     "conv_score_topk"),
    ("bf16", "folded", BENCH_BATCH, (1, 2), BENCH_TOP_K, "conv_score_topk"),
    ("bf16", "folded", BENCH_BATCH, (2, 2), BENCH_TOP_K,
     "score_topk[packed]"),
    ("bf16", "default", 2 * BENCH_BATCH, (2, 2), BENCH_TOP_K,
     "pixel_text_topk[bf16]"),
    ("fp32", "folded", SERVE_BATCH, (2, 1), 1, "score_topk[knockout]"),
)
# Where a grid splits the batch, a bf16 cell's UNet runs at another batch
# than the single device's, cuDNN may pick another algorithm, and the bf16
# field rounds otherwise: a label that then differs must be a near-tie,
# within this gap of cosine scores (two bf16 ulps at 0.5).  bf16 scores
# tie often (8 bits of mantissa, 512 classes, top-5), so the agreement is
# only a floor
SHARD_TIE_TOL = 4e-3
SHARD_MIN_AGREEMENT = 0.95
DDP_RANK_BATCH = 8  # rows a rank per microbatch in phase 14 (b)
DDP_TOLERANCE = {True: dict(loss=1e-3, grads=3e-2, stats=1e-2,
                            params_close=0.99),
                 False: dict(loss=1e-5, grads=1e-3, stats=1e-4,
                             params_close=0.999)}
# phase 14 (e): the global-batch step's ranks (8 rows each) against the
# single-device step on their 16 rows.  BatchNorm's statistics are combined
# in another order than cuDNN's and the ranks' convolutions run at half the
# batch, so the field differs in its last bits (bf16: by an ulp where that
# crosses a rounding boundary).  f32 is held to JAX's layout test: the
# loss within rtol 2e-5 and every gradient entry within that test's
# parameter tolerance after SGD at lr 1e-3 (``sgd`` <= 1), and the whole
# gradient within 2e-3; bf16 over the whole gradient.  Not held: each
# tensor's gap against its own largest entry (a tensor whose gradient is
# small against the step's, the deepest blocks', keeps the absolute
# rounding of the large ones: 5.5% in f32 on an NVIDIA H100 80GB HBM3 at
# 700 W), and the parameters beyond Adam's bound (2 lr): its first step
# moves an entry by about lr * sign(g), so where a gradient entry is
# rounding noise the two sides step apart (JAX's own layout test takes SGD
# for that reason, tests/test_parallel.py:123-126).  Both are reported
GLOBAL_TOLERANCE = {True: dict(loss=1e-3, grads=math.inf, grads_norm=0.1,
                               stats=2e-2, params_close=0.0),
                    False: dict(loss=2e-5, grads=math.inf, grads_norm=2e-3,
                                sgd=1.0, stats=5e-4, params_close=0.0)}
DDP_KERNELS = {True: ["histogram", "class_presence", "l2_normalize[fwd]",
                      "l2_normalize[bwd]", "tv_rowtile[fwd]",
                      "tv_rowtile[bwd]"],
               False: ["histogram", "class_presence", "live_rows",
                       "pixel_text_ce[fwd]", "pixel_text_ce[bwd]"]}
GLOBAL_KERNELS = {True: ["histogram", "class_presence", "l2_normalize[fwd]",
                         "l2_normalize[bwd]", "pixel_text_ce_tc[fwd]",
                         "pixel_text_ce_tc[bwd]", "tv_rowtile[fwd]",
                         "tv_rowtile[bwd]"],
                  False: ["histogram", "class_presence", "live_rows",
                          "pixel_text_ce[fwd]", "pixel_text_ce[bwd]"]}
# phase 14 (f): sharded validation against one device.  The ranks' UNet
# runs at half the batch, so an f32 top-k near-tie may fall otherwise:
# accuracies and mIoU within this, the losses within VAL_LOSS_RTOL
VAL_METRIC_ATOL = 1e-4
VAL_LOSS_RTOL = 1e-4


def host_maps_per_s(fn, batch: int, iters: int = 3) -> float:
    """maps/s of ``fn()`` by the host clock, the device synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return batch * iters / (time.perf_counter() - t0)


def phase_sharded_predict(device, card: str, totals) -> None:
    """14 (a): the class-sharded, data-parallel predict on grids that name
    this card several times: each run's labels against single-device
    predict of the same path, and maps/s of both by the host clock (on one
    card: the cost of the grid's loop and merge, not a speed-up)."""
    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        predict_folded,
    )
    from rangeclip_tpu_torch.parallel import (
        make_mesh,
        make_sharded_predict,
        pad_class_table,
        shard_predict_inputs,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    models = {p: DepthUNet(DepthUNetConfig(
        dtype=torch.bfloat16 if p == "bf16" else None), device=device,
        generator=torch.Generator().manual_seed(SEED)).eval()
        for p in ("bf16", "fp32")}
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    text = torch.randn(NUM_CLASSES, 512, device=device, generator=gen)
    depth = torch.randn(2 * BENCH_BATCH, RES, RES, 1, device=device,
                        generator=gen)
    # on CUDA the table pads to the kernels' 128-slot quantum: 61 classes
    # over 3 columns take 3 x 128 rows, 323 of them pad rows with id -1
    padded, ids = pad_class_table(text[:61], 3)
    require(padded.shape[0] == 384 and int((ids < 0).sum()) == 323
            and not padded[61:].any(),
            f"pad_class_table on {device}: {padded.shape[0]} rows, "
            f"{int((ids < 0).sum())} pad ids")
    for precision, path, batch, (n_data, n_model), k, kernel in SHARDED_RUNS:
        model, x = models[precision], depth[:batch]
        mesh = make_mesh(n_data, n_model, [device] * (n_data * n_model))
        shards = shard_predict_inputs(mesh, *pad_class_table(text, n_model))
        fn = make_sharded_predict(model, mesh, k, path)
        name = (f"sharded predict {precision} {path} batch {batch} on "
                f"{n_data} x {n_model}")
        with torch.inference_mode():
            got, counts = run_path(name, [kernel],
                                   lambda: fn(x, shards), totals)
            if path == "folded":
                single = lambda: predict_folded(  # noqa: E731
                    model, x, text, top_k=k)
            else:
                single = lambda: model.predict(  # noqa: E731
                    x, text, None, k, return_embeddings=False)[0]
            want = single()
            torch.cuda.synchronize()
            require(got.shape == want.shape == (batch, RES, RES, k),
                    f"{name}: shape {tuple(got.shape)}")
            differ = int((got != want).sum())
            if differ:
                # f32, and bf16 whose cells take the whole batch (only the
                # table split; the fold is blocked), are bit-equal
                require(precision == "bf16" and n_data > 1,
                        f"{name}: {differ} labels differ from single-device "
                        "predict")
                field = model.native_field(x, normalize=False)
                near_tie_check(
                    f"{name} on {card}",
                    (got[:, ::2, ::2].reshape(-1, k), None),
                    (want[:, ::2, ::2].reshape(-1, k), None),
                    field.reshape(-1, field.shape[-1]),
                    l2_normalize(text, dim=-1), tol=SHARD_TIE_TOL,
                    min_rate=SHARD_MIN_AGREEMENT)
            sharded_rate = host_maps_per_s(lambda: fn(x, shards), batch, 2)
            single_rate = host_maps_per_s(single, batch, 2)
        log(f"  {name}: {differ} of {got.numel()} labels differ from "
            f"single-device predict; "
            f"{counts[kernel]} {kernel} launches; {sharded_rate:.1f} maps/s "
            f"against {single_rate:.1f} single-device (host clock) on {card}")


def rank_launches(ranks, part: str, totals) -> dict:
    """The ranks' launch counts of one part of their run (a step, or
    ``val``), summed, and added to ``totals``."""
    counts = {}
    for res in ranks:
        for kernel, n in (res[part]["launches"] if part == "val"
                          else res["launches"]).items():
            counts[kernel] = counts.get(kernel, 0) + n
            totals[kernel] += n
    return counts


def phase_rank_steps(device, card: str, totals) -> None:
    """14 (b), (e), (f): one spawn of two gloo ranks on this card, each
    taking four full-width steps (ResNet-18, D = 512, 256^2, 2 x 8 rows a
    rank, 40 labels present): (b) the ddp_parity step in bf16 and in f32,
    against the per-rank simulation in this process with the same draws;
    (e) the global-batch step in bf16 and in f32, against the
    single-device step on the 16-row batch in this process with the same
    draws; both ranks end bit-equal.  (f) before the f32 global step the
    ranks validate their rows of two 16-row val batches over the group,
    against single-device validation of the whole batches."""
    from rangeclip_tpu_torch.parallel.dryrun import (
        StepSpec,
        Tolerance,
        check_step,
        run_ranks,
        simulate_ddp_step,
        single_device_step,
        single_device_validation,
    )

    common = dict(filters=(32, 64, 128, 256, 512), dim=512, res=RES,
                  batch=DDP_RANK_BATCH, accum=2, classes=NUM_CLASSES,
                  present=TRAIN_PRESENT, lr=1e-4)
    specs = ([StepSpec(**common, bf16=bf16, seed=SEED + 20,
                       mode="ddp_parity") for bf16 in (True, False)]
             + [StepSpec(**common, bf16=bf16, seed=SEED + 21, mode="global",
                         val_batches=0 if bf16 else 2)
                for bf16 in (True, False)])
    t0 = time.perf_counter()
    results = run_ranks(2, specs, device.type, "gloo")
    log(f"  the two ranks' processes took {time.perf_counter() - t0:.1f} s "
        f"on {card}")
    for i, spec in enumerate(specs):
        ranks = [r[i] for r in results]
        ddp = spec.mode == "ddp_parity"
        t1 = time.perf_counter()
        want = (simulate_ddp_step if ddp else single_device_step)(
            spec, 2, device)
        oracle_s = time.perf_counter() - t1
        errors = check_step(ranks, want, spec, Tolerance(
            **(DDP_TOLERANCE if ddp else GLOBAL_TOLERANCE)[spec.bf16]))
        counts = rank_launches(ranks, "step", totals)
        for kernel in (DDP_KERNELS if ddp else GLOBAL_KERNELS)[spec.bf16]:
            require(counts.get(kernel, 0) > 0,
                    f"{spec.mode} ranks: {kernel} was not launched")
        log(f"  {spec.mode}, 2 gloo ranks x {spec.batch} rows on one card, "
            f"{'bf16' if spec.bf16 else 'fp32'}: loss "
            f"{ranks[0]['info']['total_loss']:.6f} against "
            f"{want['info']['total_loss']:.6f} "
            f"{'simulated' if ddp else 'on one device'} ({oracle_s:.1f} s "
            f"in this process), both ranks bit-equal; errors {errors}; "
            f"launches { {k: n for k, n in counts.items() if n} }")

    spec = specs[3]
    got = [r[3]["val"]["results"] for r in results]
    require(got[0] == got[1], "sharded validation: the ranks' results "
            f"differ: {got}")
    want = single_device_validation(spec, 2, device)
    metric_err = max(abs(got[0][k] - want[k]) for k in (
        "mIoU_t1", "mIoU_tk", "pixel_accuracy_t1", "pixel_accuracy_tk"))
    loss_err = max(abs(got[0][k] - want[k]) / max(abs(want[k]), 1e-30)
                   for k in ("loss", "avg_text_contrastive_loss",
                             "avg_image_contrastive_loss",
                             "avg_smoothness_loss"))
    require(metric_err <= VAL_METRIC_ATOL and loss_err <= VAL_LOSS_RTOL,
            f"sharded validation against one device: metrics {metric_err} "
            f"(<= {VAL_METRIC_ATOL}), losses {loss_err} (<= "
            f"{VAL_LOSS_RTOL}): {got[0]} against {want}")
    counts = rank_launches([r[3] for r in results], "val", totals)
    for kernel in VAL_KERNELS:
        require(counts.get(kernel, 0) > 0,
                f"sharded validation: {kernel} was not launched")
    log(f"  sharded validation, 2 gloo ranks x 8 rows of 2 batches, fp32: "
        f"mIoU_tk {got[0]['mIoU_tk']:.6f} against {want['mIoU_tk']:.6f}, "
        f"largest metric difference {metric_err:.3g}, loss relative "
        f"{loss_err:.3g}; launches "
        f"{ {k: n for k, n in counts.items() if n} }")


# phase 14 (h): the 'spatial' axis at full width, in one spawn of four
# ranks: the grid predicts of the ResNet UNet and the MiT (f32 and bf16 on
# 1 x 2 x 1 and 1 x 2 x 2), then the global-batch steps of both on 1 x 2 x
# 1 (ranks 2 and 3 sit out), the f32 ones after validating over the grid
GRID_PREDICT_BATCH = SERVE_BATCH
GRID_VAL_BATCH = 8  # images of a val batch (phase 8's, cli/train's)
GRID_VAL_BATCHES = 2
# the steps' kernels by (architecture, bf16): the ResNet's field at H/2
# packs 4 label slots (bf16: the tensor-core CE), the MiT's at H/4 16
# (bf16: the tensor-core pair past 4 slots; f32: the member-only CE's
# 16-slot instances)
GRID_KERNELS = {
    ("resnet", True): ["histogram", "class_presence", "l2_normalize[fwd]",
                       "l2_normalize[bwd]", "pixel_text_ce_tc[fwd]",
                       "pixel_text_ce_tc[bwd]"],
    ("resnet", False): ["histogram", "class_presence", "live_rows",
                        "pixel_text_ce[fwd]", "pixel_text_ce[bwd]"],
    ("mit", True): ["histogram", "class_presence", "l2_normalize[fwd]",
                    "l2_normalize[bwd]", "live_rows", *SLOTS_CE],
    ("mit", False): ["histogram", "class_presence", "live_rows",
                     "pixel_text_ce[fwd]", "pixel_text_ce[bwd]"]}
GRID_VAL_KERNELS = ["pixel_text_topk[fp32]", "class_presence[labels]"]
ARCH_NAMES = {"resnet": "ResNet-18", "mit": "MiT (stage widths 64-512)"}


def grid_specs():
    """Phase 14 (h)'s specs: the eight grid predicts, then the four steps
    (the two f32 ones validating first)."""
    from rangeclip_tpu_torch.parallel.dryrun import PredictSpec, StepSpec

    full = dict(filters=(32, 64, 128, 256, 512), dim=512, res=RES)
    predicts = [PredictSpec(**full, unet_type=arch, grid=grid,
                            batch=GRID_PREDICT_BATCH, classes=NUM_CLASSES,
                            top_k=BENCH_TOP_K, bf16=bf16, seed=SEED + 40)
                for arch in ("resnet", "mit")
                for grid in ((1, 2, 1), (1, 2, 2)) for bf16 in (False, True)]
    steps = [StepSpec(**full, unet_type=arch, batch=TRAIN_BATCH, accum=1,
                      classes=NUM_CLASSES, present=TRAIN_PRESENT, lr=1e-4,
                      bf16=bf16, seed=SEED + 41, mode="global",
                      grid=(1, 2, 1),
                      val_batches=0 if bf16 else GRID_VAL_BATCHES,
                      val_batch=GRID_VAL_BATCH)
             for arch in ("resnet", "mit") for bf16 in (True, False)]
    return predicts, steps


def member_launches(members, part: str, kernels, what: str) -> None:
    """Require that every rank launched each of ``kernels`` in ``part`` of
    its run (its step, or ``val``)."""
    for r, res in enumerate(members):
        counts = res["val"]["launches"] if part == "val" else res["launches"]
        for kernel in kernels:
            require(counts.get(kernel, 0) > 0,
                    f"{what}: rank {r} did not launch {kernel}")


def check_grid_validation(spec, members, device, card: str, totals) -> None:
    """A grid step's validation (``spec.val_batches``): every rank's
    results equal, against single-device ``validate_model`` on the whole
    batches (metrics within VAL_METRIC_ATOL, losses within
    VAL_LOSS_RTOL), each rank launching GRID_VAL_KERNELS."""
    from rangeclip_tpu_torch.parallel.dryrun import single_device_validation

    name = f"grid validation of the {ARCH_NAMES[spec.unet_type]} on 1 x 2 x 1"
    got = [res["val"]["results"] for res in members]
    require(all(g == got[0] for g in got[1:]),
            f"{name}: the ranks' results differ: {got}")
    want = single_device_validation(spec, 2, device)
    metrics = ("mIoU_t1", "mIoU_tk", "pixel_accuracy_t1", "pixel_accuracy_tk")
    metric_err = max(abs(got[0][k] - want[k]) for k in metrics)
    loss_err = max(abs(got[0][k] - want[k]) / max(abs(want[k]), 1e-30)
                   for k in ("loss", "avg_text_contrastive_loss",
                             "avg_image_contrastive_loss",
                             "avg_smoothness_loss"))
    require(metric_err <= VAL_METRIC_ATOL and loss_err <= VAL_LOSS_RTOL,
            f"{name} against one device: metrics {metric_err} (<= "
            f"{VAL_METRIC_ATOL}), losses {loss_err} (<= {VAL_LOSS_RTOL}): "
            f"{got[0]} against {want}")
    member_launches(members, "val", GRID_VAL_KERNELS, name)
    counts = rank_launches(members, "val", totals)
    log(f"  {name}, f32, {GRID_VAL_BATCHES} batches of {GRID_VAL_BATCH} "
        f"images with {RES // 2} of {RES} rows a rank, 50 negatives, top-5: "
        f"metrics {'equal to' if metric_err == 0 else 'within'} "
        f"single-device validation's (largest difference {metric_err!r}; "
        f"mIoU_tk {got[0]['mIoU_tk']!r} against {want['mIoU_tk']!r}), "
        f"losses relative {loss_err:.3g}; launches "
        f"{ {k: n for k, n in counts.items() if n} } on {card}")


def phase_grid(device, card: str, totals) -> None:
    """14 (h): the module docstring's 'spatial' axis at full width."""
    from rangeclip_tpu_torch.parallel.dryrun import (
        PredictSpec,
        Tolerance,
        check_step,
        oracle_step,
        predict_inputs,
        run_ranks,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    predicts, steps = grid_specs()
    t0 = time.perf_counter()
    results = run_ranks(4, predicts + steps, device.type, "gloo")
    log(f"  (h) the four ranks' processes took "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    for i, spec in enumerate(predicts + steps):
        ranks = [r[i] for r in results]
        members = [r for r in ranks if r is not None]
        arch = ARCH_NAMES[spec.unet_type]
        precision = "bf16" if spec.bf16 else "fp32"
        if isinstance(spec, PredictSpec):
            counts = rank_launches(members, "step", totals)
            name = (f"grid predict of the {arch}, {precision}, on "
                    f"{' x '.join(map(str, spec.grid))}")
            kernel = f"pixel_text_topk[{precision}]"
            member_launches(members, "step", [kernel], name)
            got = members[0]["labels"]
            require(all(torch.equal(r["labels"], got) for r in members),
                    f"{name}: the ranks gathered different maps")
            model, depth, table = predict_inputs(spec, device)
            with torch.inference_mode():
                want = model.predict(depth, table, None, spec.top_k,
                                     return_embeddings=False)[0].cpu()
                field = model.native_field(depth, normalize=False)
            require(got.shape == want.shape == (spec.batch, RES, RES,
                                                spec.top_k),
                    f"{name}: shape {tuple(got.shape)}")
            differ = int((got != want).sum())
            if differ:
                up = model.field_scale
                native = lambda t: (  # noqa: E731
                    t[:, ::up, ::up].reshape(-1, spec.top_k).to(device),
                    None)
                near_tie_check(
                    f"{name} on {card}", native(got), native(want),
                    field.reshape(-1, field.shape[-1]),
                    l2_normalize(table, dim=-1),
                    **(dict(tol=SHARD_TIE_TOL, min_rate=SHARD_MIN_AGREEMENT)
                       if spec.bf16 else {}))
            log(f"  {name}, batch {spec.batch} at {RES}^2, C = "
                f"{spec.classes}, top-{spec.top_k}: {differ} of "
                f"{got.numel()} labels differ from single-device predict; "
                f"{counts.get(kernel, 0)} {kernel} launches by "
                f"{len(members)} ranks on {card}")
            del model, field
            continue
        if spec.val_batches:
            check_grid_validation(spec, members, device, card, totals)
        counts = rank_launches(members, "step", totals)
        t1 = time.perf_counter()
        want = oracle_step(spec, 2, device)
        oracle_s = time.perf_counter() - t1
        errors = check_step(ranks, want, spec,
                            Tolerance(**GLOBAL_TOLERANCE[spec.bf16]))
        name = f"grid step of the {arch}, {precision}"
        member_launches(members, "step",
                        GRID_KERNELS[spec.unet_type, spec.bf16], name)
        if spec.unet_type == "mit" and spec.bf16:
            require(not any(counts.get(k, 0) for k in MEMBER_CE),
                    f"{name}: the member-only CE ran past 4 slots")
        for kernel in ("tv_rowtile[fwd]", "tv_rowtile[bwd]"):
            require(not counts.get(kernel, 0),
                    f"{name}: {kernel} launched under the 'spatial' axis")
        log(f"  global step of the {arch} on 1 x 2 x 1, {spec.batch} "
            f"images with {RES // 2} of {RES} rows a rank, {precision}: "
            f"loss {members[0]['info']['total_loss']:.6f} against "
            f"{want['info']['total_loss']:.6f} on one device ({oracle_s:.1f}"
            f" s in this process), both ranks bit-equal; errors {errors}; "
            f"launches { {k: n for k, n in counts.items() if n} } on {card}")
        del want
        torch.cuda.empty_cache()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_nccl_world_one(tmp: str, data, totals) -> None:
    """14 (c): cli/train --distributed --ddp_parity over NCCL at world 1
    (torchrun's environment: RANK=0, WORLD_SIZE=1) on phase 8's data, 2
    steps, bit-equal to --ddp_parity alone; (g) cli/train --distributed
    (the global-batch step) over NCCL at world 1, bit-equal to plain
    cli/train; all with deterministic algorithms, so that the comparison
    sees the collectives only."""
    from rangeclip_tpu_torch.cli import train
    from rangeclip_tpu_torch.models.interop import load_reference_pth

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    saved_env = {k: os.environ.get(k) for k in env}
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    argv = lambda ckpt, *extra: train_argv(  # noqa: E731
        data, os.path.join(tmp, ckpt), "--unet_architecture", "resnet",
        "--batch_size", "8", "--accumulation_steps", "2",
        "--learning_rates", "1e-4", "--learning_schedule", "1",
        "--max_steps", "2", *extra)
    expect = ["histogram", "class_presence", "l2_normalize[fwd]",
              "tv_rowtile[fwd]"]
    try:
        os.environ.update(env)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        for name, ckpt, flags in (
                ("--distributed --ddp_parity (NCCL, world 1)", "nccl1",
                 ("--distributed", "--ddp_parity")),
                ("--ddp_parity", "ddp1", ("--ddp_parity",)),
                ("--distributed (NCCL, world 1)", "nccl1g",
                 ("--distributed",)),
                ("(plain)", "plain1", ())):
            run_path(f"cli/train {name}", expect,
                     lambda: train.main(argv(ckpt, *flags)), totals)
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]
        torch.backends.cudnn.benchmark = saved[2]
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require(not torch.distributed.is_initialized(),
            "cli/train left its process group open")
    for runs in (("nccl1", "ddp1"), ("nccl1g", "plain1")):
        for step in (1, 2):
            got, want = (load_reference_pth(os.path.join(
                tmp, run, "checkpoints",
                f"depth_segmentation_model-{step}.pth")) for run in runs)
            bad = [k for k in want if not torch.equal(got[k], want[k])]
            require(not bad, f"{runs[0]} differs from {runs[1]} at step "
                    f"{step}: {bad[:5]}")
    log(f"  cli/train --distributed --ddp_parity over NCCL at world 1: "
        f"weights, BatchNorm statistics and temperatures bit-equal to "
        f"--ddp_parity alone at steps 1 and 2 (losses "
        f"{train_losses(os.path.join(tmp, 'nccl1'))}); --distributed "
        f"alone (the global-batch step) bit-equal to plain cli/train "
        f"(losses {train_losses(os.path.join(tmp, 'nccl1g'))})")


def phase_multigpu(tmp: str, data, device, card: str, totals) -> None:
    """14. Multi-GPU on one card: (a) sharded predict; two gloo ranks of
    (b) the ddp_parity step, (e) the global-batch step and (f) sharded
    validation; (h) four gloo ranks of the 'spatial' axis (grid predicts,
    grid validation and the grid step of the ResNet UNet and the MiT); (c) and (g) NCCL at world 1; (d) the dry run of four
    ranks on JAX's 1 x 2 x 2 layout."""
    from rangeclip_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    marks = []
    phase_sharded_predict(device, card, totals)
    log(f"  phase 14 (a) ended at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    marks.append(round(time.perf_counter() - t0, 1))
    phase_rank_steps(device, card, totals)
    torch.cuda.empty_cache()
    marks.append(round(time.perf_counter() - t0, 1))
    phase_grid(device, card, totals)
    torch.cuda.empty_cache()
    marks.append(round(time.perf_counter() - t0, 1))
    phase_nccl_world_one(tmp, data, totals)
    marks.append(round(time.perf_counter() - t0, 1))
    summary = dryrun_multichip(4, device.type, backend="gloo")
    for kernel, n in summary["launches"].items():
        totals[kernel] += n
    require(summary["launches"].get("histogram", 0) > 0,
            "the dry run's ranks launched no kernel")
    require(summary["layout"] == [1, 2, 2]
            and "grid_predict" in summary and "large_c" in summary,
            f"the dry run's layout: {summary}")
    log(f"  dryrun_multichip(4, backend='gloo') on {card}: {summary}")
    marks.append(round(time.perf_counter() - t0, 1))
    log(f"  phase 14 (a), (b)+(e)+(f), (h), (c)+(g), (d) ended at {marks} "
        f"s on {card}")


def run_path(name: str, expect, fn, totals):
    """Run one path with the launch counts set to 0 just before it; require
    the kernels it is built on; add its counts to ``totals``."""
    from rangeclip_tpu_torch.ops.kernels import _lib

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(_lib.launch_counts)
    for kernel in expect:
        require(counts[kernel] > 0, f"{name}: {kernel} was not launched")
    for kernel, n in counts.items():
        totals[kernel] += n
    log(f"  launches in {name}: "
        f"{ {k: n for k, n in counts.items() if n} }")
    return out, counts


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on "
              "a GPU", file=sys.stderr)
        return 1

    from rangeclip_tpu_torch.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        build_candidate_indices,
    )
    from rangeclip_tpu_torch.models.interop import save_reference_pth
    from rangeclip_tpu_torch.ops.kernels import _lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(f"chip_smoke on {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    log("phase 1: build")
    built = _lib.build()
    log(f"  built {built.path.name} in {built.seconds:.1f} s")
    lib = _lib.library()
    for line in (ptxas_summary(built.ptxas)
                 or built.ptxas.splitlines()[:60]):
        log(f"  ptxas: {line}")
    # the fp32 contract keeps pixel_text_topk's CUDA-core kernel off the
    # tensor cores: its SASS must hold no matrix instruction
    sass = sass_counts(built.path, "pixel_text_topk_fma_kernel")
    require(len(sass) == 16 and all(mma == 0 for mma, _ in sass.values()),
            f"pixel_text_topk_fma_kernel SASS: {sass}")
    log(f"  SASS of pixel_text_topk_fma_kernel ({len(sass)} instances): 0 "
        f"HMMA/HGMMA/IMMA, {min(f for _, f in sass.values())}-"
        f"{max(f for _, f in sass.values())} FFMA")
    log(f"  dynamic shared memory per block: pixel_text_topk[bf16] at D=512 "
        f"{lib.rc_pixel_text_topk_tc_smem(512)} B, pixel_text_topk[fp32] "
        f"{lib.rc_pixel_text_topk_fma_smem(0)} B (a bf16 field beyond 1280 "
        f"dims {lib.rc_pixel_text_topk_fma_smem(1)} B), conv_score_topk at "
        f"C_in=32 {lib.rc_conv_score_topk_smem(32)} B")

    # the bench configuration's model and inputs (phases 2 and 4), and the
    # serve model (fp32, full width) saved as a reference .pth (phases 2-6)
    gen = torch.Generator().manual_seed(SEED)
    bench_model = DepthUNet(DepthUNetConfig(dtype=torch.bfloat16),
                            device=device, generator=gen).eval()
    serve_model = DepthUNet(DepthUNetConfig(), device=device,
                            generator=torch.Generator().manual_seed(SEED)
                            ).eval()
    dgen = torch.Generator(device=device).manual_seed(SEED + 3)
    depths = [torch.randn(BENCH_BATCH, RES, RES, 1, device=device,
                          generator=dgen) for _ in range(2)]
    text = torch.randn(NUM_CLASSES, 512, device=device, generator=dgen)
    seg = torch.randint(0, 40, (BENCH_BATCH, RES, RES), device=device,
                        generator=dgen)
    cand = build_candidate_indices(seg, NUM_CLASSES, BENCH_NEGATIVES,
                                   BENCH_SLOTS,
                                   generator=torch.Generator().manual_seed(1))

    log("phase 2: kernels against their plain versions")
    stats = {}
    phase_kernels(device, bench_model, depths[0], text, cand, stats)
    phase_unfolded_kernels(device, bench_model, serve_model, depths, text,
                           cand, stats)
    phase_train_kernels(device, stats)
    phase_slot_ce_kernels(device, stats)
    phase_eval_kernels(device, bench_model, serve_model, depths, text, seg,
                       stats)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  phase 2 done at {time.perf_counter() - t_start:.1f} s")

    totals = {name: 0 for name in KERNEL_ROWS}
    with tempfile.TemporaryDirectory() as tmp:
        save_reference_pth(serve_model, os.path.join(tmp, "model.pth"))
        write_labels(os.path.join(tmp, "labels.csv"))
        write_labels(os.path.join(tmp, "labels_large.csv"), LARGE_TABLE)

        log("phase 3: serve")
        for bf16, path, expect in (
                (False, "auto", ["score_topk[knockout]"]),
                (True, "auto", ["score_topk[packed]"]),
                (False, "default", ["pixel_text_topk[fp32]", "live_rows"]),
                (True, "default", ["pixel_text_topk[bf16]"])):
            folded, _ = run_path(
                f"serve {'bf16' if bf16 else 'fp32'} {path}", expect,
                lambda: phase_serve(tmp, bf16, device, path), totals)
            require(folded == (path == "auto"), f"serve {path} path choice")
        folded, counts = run_path(
            f"serve fp32 auto C={LARGE_TABLE}", ["pixel_text_topk[fp32]"],
            lambda: phase_serve(tmp, False, device, "auto",
                                "labels_large.csv", LARGE_TABLE), totals)
        require(not folded and not counts["score_topk[knockout]"],
                f"auto over {LARGE_TABLE} classes took the folded path")

        log("phase 4: bench configuration")
        run_path("bench predict_folded + DepthUNet.predict",
                 ["class_presence[labels]", "conv_score_topk",
                  "pixel_text_topk[bf16]"],
                 lambda: phase_bench(device, bench_model, depths, text, seg,
                                     card), totals)
        phase_fused_head(device, bench_model, serve_model, depths, text, seg,
                         card, totals)
        del bench_model, serve_model, depths
        torch.cuda.empty_cache()

        log("phase 5: infer and export")
        phase_infer(tmp, device, totals)
        run_path("export", ["pixel_text_topk[fp32]"],
                 lambda: phase_export(tmp, device), totals)

    log("phase 6: gradient")
    run_path("forward_native + backward",
             ["l2_normalize[fwd]", "l2_normalize[bwd]"],
             lambda: phase_gradient(device), totals)
    phase_pool_tv(device, totals)

    log("phase 7: train")
    step_ms = phase_train(device, card, totals)
    log(f"  phase 7 done at {time.perf_counter() - t_start:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        log("phase 8: cli/train (validating) and cli/validate")
        data = phase_cli_train(tmp, device, totals)

        log("phase 9: val step, kernels against plain versions")
        compare_val_step(device)

        log("phase 10: D % 8 != 0, kernels against plain versions")
        phase_dim100(device)
        phase_padded_widths(device)
        log(f"  phase 10 done at {time.perf_counter() - t_start:.1f} s")

        log("phase 11: CLIP towers, frozen encoder, MiT, ResNet-50, "
            "MaskCLIP")
        phase_clip_train(tmp, data, device, card, step_ms, totals)
        torch.cuda.empty_cache()
        phase_restore_encoder(tmp, data, device, totals)
        phase_mit(tmp, data, device, card, totals)
        torch.cuda.empty_cache()
        phase_resnet50(device, card, totals)
        torch.cuda.empty_cache()
        phase_mask_clip(data, device)
        log(f"  phase 11 done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()

        log("phase 12: cli.benchmark, cli.convert, cli/train --profile_dir")
        phase_tools(tmp, data, device, totals)
        log(f"  phase 12 done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()

        log("phase 13: cli.setup, the native data path, the multinomial "
            "sampler, the block library")
        phase_data_prep(tmp, data, device, card, totals)
        log(f"  phase 13 done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()

        log("phase 14: multi-GPU on one card (sharded predict, ddp_parity "
            "and global-batch ranks over gloo, sharded validation, the "
            "'spatial' axis's grid predicts and step, NCCL at world 1, the "
            "dry run)")
        phase_multigpu(tmp, data, device, card, totals)
        log(f"  phase 14 done at {time.perf_counter() - t_start:.1f} s")

    log(f"launches over phases 3-8 and 11-14: {totals} "
        f"({time.perf_counter() - t_start:.1f} s since the start)")
    for name in KERNEL_ROWS:
        require(totals[name] > 0, f"{name} was not launched by a main path")

    rows = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        require("device_ms" in stats[name], f"{name}: no device time")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": totals[name],
                     **stats[name]})
    log("product only (cuBLAS/cuDNN), ms: " + json.dumps(PRODUCT_ONLY_MS))
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
