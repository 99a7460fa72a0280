"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Full width: the ResNet-18 UNet with embedding dim 512 and filters 32..512
at 256x256, a label table of C=512 (hash-stub text embeddings) and random
weights made from a seed, saved to and reloaded from a reference ``.pth``.
Phases (any failure raises; nothing is caught):

1. Build the CUDA kernels from ``rangeclip_tpu_torch/csrc/``.
2. Hold each kernel against its plain PyTorch version at the shapes the
   main path gives it, and time both.
3. Serve: the port's ``cli/serve`` engine and HTTP server in this process,
   default flags (fp32, batch 8, top-1, --predict_path auto), four POSTed
   depth maps; fp32 labels are checked against the same model on the CPU.
   Then again with --bf16.
4. The bench configuration: bf16 predict_folded at batch 128 over 384
   candidate slots drawn by build_candidate_indices, run twice with
   identical checksums; maps/s.
5. The kernels' launch counts over phases 3 and 4: each must be > 0.

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

KERNEL_ROWS = {
    "score_topk[knockout]": ("rangeclip_tpu_torch/csrc/score_topk.cu",
                             "rangeclip_tpu/ops/pallas/score_topk.py:91"),
    "score_topk[packed]": ("rangeclip_tpu_torch/csrc/score_topk.cu",
                           "rangeclip_tpu/ops/pallas/score_topk.py:126"),
    "conv_score_topk": ("rangeclip_tpu_torch/csrc/conv_score_topk.cu",
                        "rangeclip_tpu/ops/pallas/conv_score_topk.py:60"),
    "class_presence": ("rangeclip_tpu_torch/csrc/class_presence.cu",
                       "rangeclip_tpu/ops/pallas/class_presence.py:21"),
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


def write_labels(path: str) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["label", "index"])
        for i in range(1, NUM_CLASSES):  # + the dummy class 0 = 512
            writer.writerow([f"class {i:03d}", i])


def phase_serve(tmp: str, bf16: bool, device) -> None:
    from rangeclip_tpu_torch.cli import serve
    from rangeclip_tpu_torch.data.transforms import depth_transform
    from rangeclip_tpu_torch.models.clip.provider import HashTextEmbedder
    from rangeclip_tpu_torch.models.depth_unet import predict_folded

    args = serve.parse_args([
        "--checkpoint_path", os.path.join(tmp, "model.pth"),
        "--labels_path", os.path.join(tmp, "labels.csv")]
        + (["--bf16"] if bf16 else []))
    require(args.device == "cuda" and args.batch_size == SERVE_BATCH
            and args.top_k == 1 and args.predict_path == "auto",
            "serve defaults changed")
    t0 = time.perf_counter()
    predict, model, labels, dev = serve.build_engine(args)
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
            require(((top1 >= 0) & (top1 < NUM_CLASSES)).all(),
                    "top-1 ids outside [0, 512)")
            served.append(top1)
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
    thread.join(30)
    mode = "bf16" if bf16 else "fp32"
    log(f"  serve {mode}: /healthz device {health['device']}; 4 POSTs -> "
        f"200, [256, 256] top-1, ids in [0, 512) "
        f"({time.perf_counter() - t0:.1f} s with engine start)")
    if bf16:
        return
    # fp32: the same model and requests through the plain versions on the
    # CPU (no TF32 on the card), labels equal up to near-ties
    cpu_model = copy.deepcopy(model).cpu()
    batch = torch.from_numpy(np.stack([depth_transform(d, size)
                                       for d in depths]))
    table = torch.from_numpy(HashTextEmbedder(dim=args.embedding_dim)(labels))
    with torch.inference_mode():
        want = predict_folded(cpu_model, batch, table, top_k=1)[..., 0]
    rate = float((torch.from_numpy(np.stack(served)) == want).float().mean())
    log(f"  serve fp32 labels vs the CPU plain path: agreement {rate:.6f}")
    require(rate >= 0.999, f"fp32 serve agreement {rate} < 0.999")


def phase_bench(device, model, depths, text, seg, card: str) -> int:
    from rangeclip_tpu_torch.models.depth_unet import (
        build_candidate_indices,
        predict_folded,
    )

    gen = torch.Generator().manual_seed(SEED + 4)
    cand = build_candidate_indices(seg, NUM_CLASSES, BENCH_NEGATIVES,
                                   BENCH_SLOTS, generator=gen)

    def run(depth):
        with torch.inference_mode():
            topk = predict_folded(model, depth, text, top_k=BENCH_TOP_K,
                                  candidate_indices=cand)
        return topk

    sums = []
    for _ in range(2):
        topk = run(depths[0])
        require(topk.shape == (BENCH_BATCH, RES, RES, BENCH_TOP_K),
                f"bench output shape {tuple(topk.shape)}")
        require(bool(((topk >= 0) & (topk < NUM_CLASSES)).all()),
                "bench ids outside [0, 512)")
        sums.append(int(topk.long().sum()))
    require(sums[0] == sums[1], f"checksums differ: {sums}")
    iters = 6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        run(depths[i % len(depths)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"  bench predict_folded bf16 batch {BENCH_BATCH} @ {RES}^2, "
        f"{BENCH_SLOTS} slots, top-{BENCH_TOP_K}: checksum {sums[0]} twice; "
        f"{BENCH_BATCH * iters / seconds:.1f} maps/s "
        f"({1e3 * seconds / iters:.2f} ms/batch, host clock) on {card}")
    return sums[0]


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

    log("phase 1: build")
    built = _lib.build()
    log(f"  built {built.path.name} in {built.seconds:.1f} s")
    _lib.library()

    # the bench configuration's model and inputs (phases 2 and 4)
    gen = torch.Generator().manual_seed(SEED)
    bench_model = DepthUNet(DepthUNetConfig(dtype=torch.bfloat16),
                            device=device, generator=gen).eval()
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
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        serve_model = DepthUNet(DepthUNetConfig(), device=device,
                                generator=torch.Generator().manual_seed(SEED))
        save_reference_pth(serve_model, os.path.join(tmp, "model.pth"))
        del serve_model
        write_labels(os.path.join(tmp, "labels.csv"))

        _lib.reset_launch_counts()  # the main path starts here
        log("phase 3: serve")
        phase_serve(tmp, False, device)
        phase_serve(tmp, True, device)
        log("phase 4: bench configuration")
        phase_bench(device, bench_model, depths, text, seg, card)
        torch.cuda.synchronize()
        counts = dict(_lib.launch_counts)

    log(f"phase 5: launch counts over phases 3-4: {counts}")
    for name in KERNEL_ROWS:
        require(counts[name] > 0, f"{name} was not launched by the main path")

    rows = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     **stats[name]})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
