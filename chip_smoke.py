"""Drive the PyTorch/CUDA port's inference paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Full width: the ResNet-18 UNet with embedding dim 512 and filters 32..512
at 256x256, a label table of C=512 (hash-stub text embeddings) and random
weights made from a seed, saved to and reloaded from a reference ``.pth``.
Phases (any failure raises; nothing is caught):

1. Build the CUDA kernels from ``rangeclip_tpu_torch/csrc/``.
2. Hold each kernel against its plain PyTorch version at the shapes the
   main paths give it, and time both.
3. Serve: the port's ``cli/serve`` engine and HTTP server in this process,
   four POSTed depth maps per configuration: default flags (fp32, batch 8,
   top-1, --predict_path auto: folded), --bf16, --predict_path default in
   fp32 and bf16, and --predict_path auto over a 1000-class label file
   (unfolded).  fp32 labels are checked against the same model on the CPU.
4. The bench configuration: bf16 batch 128 over 384 candidate slots drawn
   by build_candidate_indices, through predict_folded and through the
   unfolded DepthUNet.predict, each run twice with identical checksums;
   maps/s of both and their top-1 agreement.
5. cli/infer over 20 16-bit depth PNGs (batch 8, a padded tail,
   --predict_path default), and cli/export --predict_path default
   --text_as_input --verify, then the .pt2 loaded and run once.
6. Gradient: forward_native in bf16 at batch 8, then backward.

Each path of phases 3-6 runs with the launch counts set to 0 just before
it and read just after; each must launch the kernels it is built on, and
every kernel must be launched by some path.

The second-to-last line is a JSON object with each kernel's launches, error
against its plain version and times; the last line names the device.  The
script exits non-zero without printing them when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import copy
import csv
import http.client
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import torch

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

KERNEL_ROWS = {
    "score_topk[knockout]": ("rangeclip_tpu_torch/csrc/score_topk.cu",
                             "rangeclip_tpu/ops/pallas/score_topk.py:91"),
    "score_topk[packed]": ("rangeclip_tpu_torch/csrc/score_topk.cu",
                           "rangeclip_tpu/ops/pallas/score_topk.py:126"),
    "conv_score_topk": ("rangeclip_tpu_torch/csrc/conv_score_topk.cu",
                        "rangeclip_tpu/ops/pallas/conv_score_topk.py:60"),
    "class_presence": ("rangeclip_tpu_torch/csrc/class_presence.cu",
                       "rangeclip_tpu/ops/pallas/class_presence.py:21"),
    "pixel_text_topk": ("rangeclip_tpu_torch/csrc/pixel_text_topk.cu",
                        "rangeclip_tpu/ops/pallas/pixel_text_topk.py:79"),
    "l2_normalize[fwd]": ("rangeclip_tpu_torch/csrc/l2_normalize.cu",
                          "rangeclip_tpu/ops/pallas/l2_normalize.py:154"),
    "l2_normalize[bwd]": ("rangeclip_tpu_torch/csrc/l2_normalize.cu",
                          "rangeclip_tpu/ops/pallas/l2_normalize.py:164"),
}


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


def phase_kernels(device, bench_model, bench_depth, text, cand, stats):
    from rangeclip_tpu_torch.ops.kernels.class_presence import (
        class_presence,
        class_presence_plain,
    )
    from rangeclip_tpu_torch.ops.kernels.conv_score_topk import (
        conv_score_topk,
        conv_score_topk_plain,
        fold_to_rows,
    )
    from rangeclip_tpu_torch.ops.kernels.score_topk import (
        score_topk,
        score_topk_plain,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

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
                stats[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        stats[name]["max_abs_err"] = err
    del field

    # class_presence at the bench shape: N = 128 * 256^2 labels, C = 512
    labels = torch.randint(0, 40, (BENCH_BATCH * RES * RES,), device=device,
                           generator=gen, dtype=torch.int32)
    labels[::977] = torch.randint(-5, NUM_CLASSES + 5, labels[::977].shape,
                                  device=device, generator=gen,
                                  dtype=torch.int32)
    valid = (torch.rand(labels.shape, device=device, generator=gen)
             > 0.1).float()
    got = class_presence(labels, valid, NUM_CLASSES)
    want = class_presence_plain(labels, valid, NUM_CLASSES)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "class_presence differs")
    ms, plain_ms = time_pair(
        lambda: class_presence(labels, valid, NUM_CLASSES),
        lambda: class_presence_plain(labels, valid, NUM_CLASSES), 20, 5)
    log(f"  class_presence N={labels.numel()} C={NUM_CLASSES}: bit-equal "
        f"({int(got.sum())} present); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    stats["class_presence"] = dict(
        max_abs_err=max_abs_err(got.int(), want.int()), ms=ms,
        plain_ms=plain_ms)
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
    with torch.inference_mode():
        feats = bench_model.decode_features(bench_depth).contiguous()
        table = l2_normalize(text[cand.clamp_min(0).long()].float(), dim=-1)
        W = bench_model.decoder.output_conv.conv.weight.float()
        rows = fold_to_rows(torch.einsum("diyx,sd->siyx", W, table).to(
            torch.bfloat16))
    got = conv_score_topk(feats, rows, slot_ids, BENCH_TOP_K, True)
    want = conv_score_topk_plain(feats, rows, slot_ids, BENCH_TOP_K)
    torch.cuda.synchronize()
    agree = got[0] == want[0]
    rate = float(agree.float().mean())
    v_got, v_want = got[1][~agree], want[1][~agree]
    top = torch.maximum(v_got.abs(), v_want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    ties = bool(((v_got - v_want).abs() <= ulp).all())
    err = max(err, max_abs_err(got[1], want[1]))
    log(f"  conv_score_topk, decoder features: id agreement {rate:.6f}, "
        f"{int((~agree).sum())} mismatches, all within one bf16 ulp: {ties}")
    require(rate >= 0.999, f"conv_score_topk id agreement {rate} < 0.999")
    require(ties, "conv_score_topk mismatch beyond a one-ulp tie")
    ms, plain_ms = time_pair(
        lambda: conv_score_topk(feats, rows, slot_ids, BENCH_TOP_K),
        lambda: conv_score_topk_plain(feats, rows, slot_ids, BENCH_TOP_K),
        5, 2)
    log(f"  conv_score_topk: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    stats["conv_score_topk"] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms)


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


def near_tie_check(name, got, want, field, table, slot_ids=None) -> float:
    """Id agreement of two top-k results on a real field; every mismatch
    must be a near-tie: f32 score gap <= 1e-5 under the plain scoring.
    ``slot_ids`` maps the table's rows to the global ids in the results
    (the gathered form); default: row i is id i."""
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
    require(rate >= 0.999, f"{name}: id agreement {rate} < 0.999")
    require(gap <= 1e-5, f"{name}: a mismatch beyond a near-tie ({gap})")
    return rate


def within_bf16_ulp(got: torch.Tensor, want: torch.Tensor,
                    slack=0.0) -> bool:
    got, want = got.double(), want.double()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return bool(((got - want).abs() <= ulp + slack).all())


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
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        field, table = q_field.to(dtype), q_table.to(dtype)
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
        # an exhausted candidate set: 2 candidates, top-5
        got, e = check_topk(f"pixel_text_topk exhausted {dtype}", field,
                            table, two, 5)
        require(bool((got[0][:, 2:] == -1).all()
                     and (got[1][:, 2:] == -1e30).all()
                     and ((got[0][:, :2] == 5) | (got[0][:, :2] == 77)).all()),
                "pixel_text_topk: exhausted set not (-1, -1e30)")
        err = max(err, e)
    log("  pixel_text_topk exhausted set (2 candidates, k=5): bit-equal, "
        "(-1, -1e30) past the candidates")
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
    stats["pixel_text_topk"] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms)
    del field
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
    stats["l2_normalize[fwd]"] = dict(max_abs_err=l2_errs[0], ms=ms,
                                      plain_ms=plain_ms)
    xp = flat.detach().clone().requires_grad_()
    yp = l2_normalize_plain(xp)
    ms, plain_ms = time_pair(
        lambda: l2_normalize_backward_op(flat, g),
        lambda: torch.autograd.grad(yp, xp, g, retain_graph=True), 20, 5)
    log(f"  l2_normalize[bwd] [{N}, {D}] bf16: kernel {ms:.4f} ms, plain "
        f"(autograd backward) {plain_ms:.4f} ms")
    stats["l2_normalize[bwd]"] = dict(max_abs_err=l2_errs[1], ms=ms,
                                      plain_ms=plain_ms)
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
    written, _ = run_path("infer", ["pixel_text_topk"],
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
    _lib.library()

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
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  phase 2 done at {time.perf_counter() - t_start:.1f} s")

    totals = {name: 0 for name in KERNEL_ROWS}
    with tempfile.TemporaryDirectory() as tmp:
        save_reference_pth(serve_model, os.path.join(tmp, "model.pth"))
        del serve_model
        write_labels(os.path.join(tmp, "labels.csv"))
        write_labels(os.path.join(tmp, "labels_large.csv"), LARGE_TABLE)

        log("phase 3: serve")
        for bf16, path, expect in (
                (False, "auto", ["score_topk[knockout]"]),
                (True, "auto", ["score_topk[packed]"]),
                (False, "default", ["pixel_text_topk"]),
                (True, "default", ["pixel_text_topk"])):
            folded, _ = run_path(
                f"serve {'bf16' if bf16 else 'fp32'} {path}", expect,
                lambda: phase_serve(tmp, bf16, device, path), totals)
            require(folded == (path == "auto"), f"serve {path} path choice")
        folded, counts = run_path(
            f"serve fp32 auto C={LARGE_TABLE}", ["pixel_text_topk"],
            lambda: phase_serve(tmp, False, device, "auto",
                                "labels_large.csv", LARGE_TABLE), totals)
        require(not folded and not counts["score_topk[knockout]"],
                f"auto over {LARGE_TABLE} classes took the folded path")

        log("phase 4: bench configuration")
        run_path("bench predict_folded + DepthUNet.predict",
                 ["class_presence", "conv_score_topk", "pixel_text_topk"],
                 lambda: phase_bench(device, bench_model, depths, text, seg,
                                     card), totals)
        del bench_model, depths
        torch.cuda.empty_cache()

        log("phase 5: infer and export")
        phase_infer(tmp, device, totals)
        run_path("export", ["pixel_text_topk"],
                 lambda: phase_export(tmp, device), totals)

    log("phase 6: gradient")
    run_path("forward_native + backward",
             ["l2_normalize[fwd]", "l2_normalize[bwd]"],
             lambda: phase_gradient(device), totals)

    log(f"launches over phases 3-6: {totals} "
        f"({time.perf_counter() - t_start:.1f} s since the start)")
    for name in KERNEL_ROWS:
        require(totals[name] > 0, f"{name} was not launched by a main path")

    rows = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": totals[name],
                     **stats[name]})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
