"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX (the machine with the card has none).  Every test here needs
a CUDA device and skips without one.  On the card, where tests/conftest.py
cannot load (it imports JAX), run them with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import dataclasses

import pytest
import torch

from rangeclip_tpu_torch.models.depth_unet import (
    DepthUNet,
    DepthUNetConfig,
    predict_folded,
)
from rangeclip_tpu_torch.ops.kernels import _lib
from rangeclip_tpu_torch.ops.kernels.class_presence import (
    class_presence,
    class_presence_plain,
    launch_name,
)
from rangeclip_tpu_torch.ops.kernels.conv_score_topk import (
    conv_score_topk,
    conv_score_topk_plain,
)
from rangeclip_tpu_torch.ops.kernels.histogram import (
    histogram,
    histogram_plain,
)
from rangeclip_tpu_torch.ops.kernels.l2_normalize import (
    l2_normalize_plain,
    l2_normalize_rows,
)
from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import (
    fused_pixel_text_ce,
    pixel_text_ce_backward_plain,
    pixel_text_ce_plain,
)
from rangeclip_tpu_torch.ops.kernels.pixel_text_topk import (
    kernel_route,
    normalize_rows_rsqrt,
    pixel_text_topk,
)
from rangeclip_tpu_torch.ops.kernels.score_topk import score_topk
from rangeclip_tpu_torch.ops.kernels.tv_rowtile import (
    tv_rowtile,
    tv_rowtile_backward_op,
    tv_rowtile_plain,
)
from rangeclip_tpu_torch.utils.math import l2_normalize


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _score_cases(gen):
    """(scores, ids, max_id): random with dead slots, quantised ties over
    sparse global ids, an exhausted set, an odd slot count and row count."""
    sc = torch.randn(4096, 512, generator=gen)
    ids = torch.arange(512, dtype=torch.int32)
    ids[::7] = -1
    yield sc, ids, 511
    ids = torch.full((384,), -1, dtype=torch.int32)
    ids[:300] = torch.randperm(2000, generator=gen)[:300].sort().values.int()
    yield torch.round(torch.randn(999, 384, generator=gen) * 4) / 4, ids, 1999
    ids = torch.full((128,), -1, dtype=torch.int32)
    ids[:3] = torch.tensor([4, 7, 9], dtype=torch.int32)
    row = torch.full((128,), 0.5)
    row[:3] = torch.tensor([2.0, 2.0, 1.0])
    yield row.repeat(64, 1), ids, 9
    yield torch.randn(4099, 100, generator=gen), torch.arange(
        100, dtype=torch.int32), 99


@pytest.mark.cuda
@pytest.mark.parametrize("selector,dtype", [("knockout", torch.float32),
                                            ("knockout", torch.bfloat16),
                                            ("packed", torch.bfloat16)])
def test_score_topk_matches_plain(cuda_device, selector, dtype):
    gen = torch.Generator().manual_seed(0)
    name = f"score_topk[{selector}]"
    for sc, ids, max_id in _score_cases(gen):
        s = sc.to(dtype)
        for k in (1, 5, 8):
            want = score_topk(s, ids, k, True, selector, max_id=max_id)
            before = _lib.launch_counts[name]
            got = score_topk(s.to(cuda_device), ids.to(cuda_device), k, True,
                             selector, max_id=max_id)
            torch.cuda.synchronize()
            assert _lib.launch_counts[name] == before + 1
            assert torch.equal(got[0].cpu(), want[0]), (s.shape, k)
            assert torch.equal(got[1].cpu(), want[1]), (s.shape, k)


@pytest.mark.cuda
@pytest.mark.parametrize("n,num_classes", [(100_000, 512), (7, 33),
                                           (300_000, 1000)])
def test_class_presence_matches_plain(cuda_device, n, num_classes):
    gen = torch.Generator().manual_seed(1)
    labels = torch.randint(-3, num_classes + 50, (n,), generator=gen,
                           dtype=torch.int32)
    valid = (torch.rand(n, generator=gen) > 0.5).float()
    got = class_presence(labels.to(cuda_device), valid.to(cuda_device),
                         num_classes)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(),
                       class_presence_plain(labels, valid, num_classes))


def _offset_view(t, offset, device):
    """``t`` on the device as a contiguous view ``offset`` elements into a
    larger buffer: its start 4 * offset bytes past the buffer's."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=device)
    buf[offset:] = t.to(device)
    return buf[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("n,num_classes,label_offset,valid_offset", [
    (0, 33, 0, 0), (1, 33, 0, 0), (1, 1, 3, None), (5, 31, 1, 1),
    (4098, 33, 2, 2), (100_003, 2049, 3, 3), (100_001, 1, 1, 0),
    (300_002, 512, 0, 3), (100_003, 2049, 1, None), (4099, 31, 3, None),
    (2_097_152, 512, 0, None), (2_097_153, 512, 2, 1)])
def test_class_presence_unaligned_and_ragged(cuda_device, n, num_classes,
                                             label_offset, valid_offset):
    """Bit-equal to the plain version in one launch: N % 4 in {1, 2, 3},
    N = 0 and 1, C in {1, 31, 33, 512, 2049}, labels and valid starting
    off a 16-byte boundary (the same way, and differently: the scalar
    validity loads), and ``valid=None`` (every label valid)."""
    gen = torch.Generator().manual_seed(20 + n % 97)
    labels = torch.randint(-3, num_classes + 50, (n,), generator=gen,
                           dtype=torch.int32)
    valid = (torch.rand(n, generator=gen) > 0.5).float()
    labels_d = _offset_view(labels, label_offset, cuda_device)
    valid_d = None
    if valid_offset is not None:
        valid_d = _offset_view(valid, valid_offset, cuda_device)
    else:
        valid = None
    assert labels_d.is_contiguous()
    got, launches = _counted(launch_name(valid_d), lambda: class_presence(
        labels_d, valid_d, num_classes))
    assert launches == 1
    assert got.dtype == torch.bool and got.shape == (num_classes,)
    assert torch.equal(got.cpu(),
                       class_presence_plain(labels, valid, num_classes))


@pytest.mark.cuda
def test_class_presence_workspace_resets(cuda_device):
    """The per-stream workspace is zero again after every call: calls back
    to back with other labels and classes, calls on two streams at once,
    and one CUDA graph replayed with other labels each give the plain
    version's answer."""
    gen = torch.Generator().manual_seed(21)

    def case(n, c, hi):
        labels = torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32)
        return labels, (torch.rand(n, generator=gen) > 0.3).float(), c

    cases = [case(50_000, 512, 40), case(7, 512, 3), case(300_001, 33, 40),
             case(2_000_000, 512, 512), case(1000, 512, 2)]
    for labels, valid, c in cases:  # back to back on one stream
        for v in (valid, None):
            got = class_presence(labels.to(cuda_device),
                                 None if v is None else v.to(cuda_device), c)
            assert torch.equal(got.cpu(), class_presence_plain(labels, v, c))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = [tuple(x.to(cuda_device) for x in cases[i][:2]) for i in (3, 4)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for stream, (labels, valid) in zip(streams, inputs):
            with torch.cuda.stream(stream):
                outs.append(class_presence(labels, valid, 512))
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        labels, valid, c = cases[3 + i % 2]
        assert torch.equal(out.cpu(), class_presence_plain(labels, valid, c))
    for with_valid in (True, False):
        stream = torch.cuda.Stream()
        static_labels = cases[0][0].to(cuda_device)
        static_valid = cases[0][1].to(cuda_device) if with_valid else None
        with torch.cuda.stream(stream):  # warm-up: the stream's workspace
            class_presence(static_labels, static_valid, 512)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = class_presence(static_labels, static_valid, 512)
        for hi in (40, 3, 512, 1):
            labels = torch.randint(0, hi, static_labels.shape, generator=gen,
                                   dtype=torch.int32)
            static_labels.copy_(labels)
            graph.replay()
            torch.cuda.synchronize()
            want = class_presence_plain(
                labels, cases[0][1] if with_valid else None, 512)
            assert torch.equal(out.cpu(), want), (with_valid, hi)


@pytest.mark.cuda
def test_class_presence_graphs_replayed_at_once(cuda_device):
    """Two graphs captured on the default capture stream, replayed at once
    on two streams with other labels each round: each call in a graph has
    its own workspace, so each gives the plain version's answer."""
    gen = torch.Generator().manual_seed(23)
    n = 4_000_000
    statics = [torch.zeros(n, dtype=torch.int32, device=cuda_device)
               for _ in range(2)]
    valid = (torch.rand(n, generator=gen) > 0.3).float()
    valid_d = valid.to(cuda_device)
    class_presence(statics[0], valid_d, 512)  # build and load the kernel
    torch.cuda.synchronize()
    graphs, outs = [], []
    for labels in statics:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(class_presence(labels, valid_d, 512))
        graphs.append(graph)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for round_ in range(6):
        draws = [torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32)
                 for hi in (40 + round_, 3 + 100 * round_)]
        for static, draw in zip(statics, draws):
            static.copy_(draw)
        torch.cuda.synchronize()
        for stream, graph in zip(streams, graphs):
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        for out, draw in zip(outs, draws):
            assert torch.equal(out.cpu(),
                               class_presence_plain(draw, valid, 512)), round_


@pytest.mark.cuda
@pytest.mark.parametrize("with_valid", [True, False])
def test_class_presence_is_one_device_event(cuda_device, with_valid):
    """One call is one device event, the kernel: no memset before it and
    no cast after it (torch.profiler, device events only)."""
    from rangeclip_tpu_torch.utils.profiling import profile

    gen = torch.Generator().manual_seed(22)
    labels = torch.randint(0, 40, (524_288,), generator=gen,
                           dtype=torch.int32).to(cuda_device)
    valid = torch.ones(labels.shape, device=cuda_device) if with_valid else None
    result = profile(lambda: class_presence(labels, valid, 512), calls=5)
    assert result["device_events"] == 1, result["events"]
    assert len(result["events"]) == 1
    assert "class_presence_kernel" in result["events"][0][0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,S,k", [((2, 8, 200, 32), 256, 5),
                                       ((1, 1, 5, 8), 128, 1),
                                       ((3, 4, 130, 64), 128, 8),
                                       ((1, 1, 1, 16), 128, 5),
                                       ((2, 3, 129, 32), 256, 5),
                                       ((2, 5, 40, 64), 384, 8)])
def test_conv_score_topk_matches_plain(cuda_device, shape, S, k):
    """Quantised-exact inputs (multiples of 1/4): bit-equal.  Covers ragged
    strips (w not a multiple of the block width, w = 129), one-row images,
    a 1x1 image (every tap but the centre is border), dead slots, C_in
    8..64 (K = 72..576, padded to a multiple of 16) and S = 384 at k = 8."""
    gen = torch.Generator().manual_seed(2)
    q = lambda *s: (torch.randint(-8, 9, s, generator=gen) / 4).to(
        torch.bfloat16)
    feats, rows = q(*shape), q(S, 9 * shape[-1])
    ids = torch.arange(S, dtype=torch.int32)
    ids[-9:] = -1
    want = conv_score_topk_plain(feats, rows, ids, k)
    before = _lib.launch_counts["conv_score_topk"]
    got = conv_score_topk(feats.to(cuda_device), rows.to(cuda_device),
                          ids.to(cuda_device), k, True)
    torch.cuda.synchronize()
    assert _lib.launch_counts["conv_score_topk"] == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_predict_folded_on_cuda_matches_cpu(cuda_device):
    """A narrow model on the card (kernels) against the same model on the
    CPU (plain versions): fp32 labels agree on >= 99.9% of entries; the
    bf16 batch of 128 takes the fused kernel."""
    cfg = DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                          embedding_dim=32)
    gen = torch.Generator().manual_seed(3)
    model = DepthUNet(cfg, generator=gen).eval()
    depth = torch.randn(4, 32, 32, generator=gen)
    text = torch.randn(100, 32, generator=gen)
    want = predict_folded(model, depth, text, top_k=5)
    got = predict_folded(model.to(cuda_device), depth.to(cuda_device),
                         text.to(cuda_device), top_k=5)
    assert got.dtype == torch.int32
    assert (got.cpu() == want).float().mean() >= 0.999

    bf16 = DepthUNet(DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                                     embedding_dim=32, dtype=torch.bfloat16),
                     device=cuda_device)
    bf16.load_state_dict(model.state_dict())
    bf16.eval()
    before = _lib.launch_counts["conv_score_topk"]
    ids = predict_folded(bf16, torch.randn(128, 32, 32, device=cuda_device),
                         text.to(cuda_device), top_k=5)
    torch.cuda.synchronize()
    assert _lib.launch_counts["conv_score_topk"] == before + 1
    assert ids.shape == (128, 32, 32, 5)
    assert bool(((ids >= 0) & (ids < 100)).all())


@pytest.mark.cuda
def test_predict_folded_wide_features_on_cuda_matches_cpu(cuda_device):
    """bf16 at batch 128 with 144 pre-head channels, wider than the fused
    kernel's 136: the conv + score_topk path on the card, against the same
    bf16 model on the CPU.  Top-1 ids agree on >= 99% of pixels (bf16
    activations round differently in the two convs, so near-ties flip)."""
    cfg = DepthUNetConfig(encoder_filters=(144, 16, 16, 16, 32),
                          embedding_dim=32, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(19)
    model = DepthUNet(cfg, generator=gen).eval()
    depth = torch.randn(128, 16, 16, generator=gen)
    text = torch.randn(100, 32, generator=gen)
    want = predict_folded(model, depth, text, top_k=5)
    before = dict(_lib.launch_counts)
    got = predict_folded(model.to(cuda_device), depth.to(cuda_device),
                         text.to(cuda_device), top_k=5)
    torch.cuda.synchronize()
    assert _lib.launch_counts["conv_score_topk"] == before["conv_score_topk"]
    selects = ("score_topk[packed]", "score_topk[knockout]")
    assert (sum(_lib.launch_counts[k] for k in selects)
            == sum(before[k] for k in selects) + 1)
    assert got.shape == (128, 16, 16, 5)
    agree = float((got[..., 0].cpu() == want[..., 0]).float().mean())
    assert agree >= 0.99, agree


@pytest.mark.cuda
def test_conv_kernel_fits_matches_the_kernel(cuda_device):
    """The Python gate of the fused conv kernel against the library's own
    shared-memory query, C_in = 8..256."""
    from rangeclip_tpu_torch.ops.kernels.conv_score_topk import (
        conv_kernel_fits,
    )

    lib = _lib.library()
    for c_in in range(8, 257, 8):
        assert conv_kernel_fits(c_in) == (lib.rc_conv_score_topk_smem(c_in)
                                          > 0), c_in


def _sparse_signs(gen, rows, dim, nonzero):
    """Rows of +-1 in ``nonzero`` places: power-of-two norms, exact sums."""
    x = torch.zeros(rows, dim)
    at = torch.rand(rows, dim, generator=gen).argsort(dim=1)[:, :nonzero]
    signs = torch.randint(0, 2, (rows, nonzero), generator=gen) * 2 - 1
    return x.scatter_(1, at, signs.float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,c,tied", [(5000, 512, 512, False),
                                        (77, 32, 1000, False),
                                        (300, 1024, 40, False),
                                        (129, 40, 130, False),
                                        (100, 64, 1, False),
                                        (200, 512, 8, False),
                                        (300, 512, 129, False),
                                        (1000, 512, 384, False),
                                        (500, 512, 300, True),
                                        (200, 1344, 130, False)])
def test_pixel_text_topk_matches_plain(cuda_device, dtype, n, d, c, tied):
    """Quantised-exact inputs: ids and values bit-equal to the plain version
    for the mask form, sparse global ids, and an exhausted set; ragged row
    and class counts (past one 128-row block, one past a 128-class tile),
    C = 1 and C = k, S = 384 at k = 8, D of 1024 and D = 40 (a last dim
    chunk of 8), and a table of one repeated row (every class scores the
    same: the smallest live ids win).  A bf16 field takes the tensor-core
    kernel up to 1280 dims, an fp32 field (and a bf16 one of 1344 dims) the
    CUDA-core one."""
    _hold_pixel_topk(cuda_device, torch.Generator().manual_seed(4), dtype,
                     n, d, c, tied, "contiguous")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [20, 100])
def test_pixel_text_topk_pads_odd_widths(cuda_device, dtype, d):
    """D % 8 != 0: the wrapper zero-pads the field and the table to 24 and
    104 and launches the route's kernel once per call; ids and values
    bit-equal to the plain version on the unpadded operands (16 nonzeros
    a row: power-of-two norms)."""
    _hold_pixel_topk(cuda_device, torch.Generator().manual_seed(40 + d),
                     dtype, 700, d, 130, False, "contiguous", nonzero=16)


def _hold_pixel_topk(cuda_device, gen, dtype, n, d, c, tied, layout,
                     nonzero=None):
    """Quantised-exact field and table drawn from ``gen`` (power-of-two
    norms: 16 nonzeros a row, 4 where d < 32), the table placed on the card
    as ``layout`` says: the kernel's ids and values bit-equal to the plain
    version's for the mask form, sparse global ids and an exhausted set at
    k = 1, 5, 8, and one launch of the route's kernel per call."""
    field = (_sparse_signs(gen, n, d, nonzero or min(16, d // 2))
             * 2.0 ** torch.randint(-3, 4, (n, 1), generator=gen)).to(dtype)
    table = (_sparse_signs(gen, 1 if tied else c, d, 4) / 2).expand(
        c, d).contiguous().to(dtype)
    mask = torch.rand(c, generator=gen) > 0.3
    ids = torch.full((c,), -1, dtype=torch.int32)
    ids[:c // 2] = torch.randperm(5000, generator=gen)[:c // 2].sort().values
    two = torch.zeros(c, dtype=torch.bool)
    two[[i for i in (1, 3) if i < c]] = True
    route = kernel_route(dtype, d)
    table_d = _placed(table, layout, cuda_device)
    for kw in ({"candidate_mask": mask}, {"candidate_mask": ids >= 0,
                                          "candidate_ids": ids},
               {"candidate_mask": two}):
        for k in (k for k in (1, 5, 8) if k <= c):
            want = pixel_text_topk(field, table, top_k=k, **kw)
            before = dict(_lib.launch_counts)
            got = pixel_text_topk(field.to(cuda_device), table_d, top_k=k,
                                  **{a: t.to(cuda_device)
                                     for a, t in kw.items()})
            torch.cuda.synchronize()
            assert {name: _lib.launch_counts[name] - before[name]
                    for name in ("pixel_text_topk[bf16]",
                                 "pixel_text_topk[fp32]")} == {
                name: int(name == route) for name in (
                    "pixel_text_topk[bf16]", "pixel_text_topk[fp32]")}
            assert torch.equal(got[0].cpu(), want[0]), (kw.keys(), k)
            assert torch.equal(got[1].cpu(), want[1]), (kw.keys(), k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pixel_text_topk_random_near_ties(cuda_device, dtype):
    gen = torch.Generator().manual_seed(5)
    field = torch.randn(20000, 512, generator=gen).to(dtype)
    table = l2_normalize(torch.randn(300, 512, generator=gen)).to(dtype)
    got = pixel_text_topk(field.to(cuda_device), table.to(cuda_device),
                          top_k=5)
    want = pixel_text_topk(field, table, top_k=5)
    agree = got[0].cpu() == want[0]
    assert agree.float().mean() >= 0.999
    scores = normalize_rows_rsqrt(field).float() @ table.float().T
    gap = (scores.gather(1, got[0].cpu().long())
           - scores.gather(1, want[0].long())).abs()
    assert bool((gap[~agree] <= 1e-5).all())


def _placed(table, layout, device):
    """The table on the device as a contiguous tensor, a strided view, or a
    contiguous view 4 bytes off a 16-byte boundary."""
    c, d = table.shape
    if layout == "strided":
        big = torch.zeros(c, d + 8, dtype=table.dtype, device=device)
        big[:, 4:4 + d] = table.to(device)
        return big[:, 4:4 + d]
    if layout == "misaligned":
        buf = torch.zeros(c * d + 1, dtype=table.dtype, device=device)
        buf[1:] = table.flatten().to(device)
        return buf[1:].view(c, d)
    return table.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,d,c,tied,layout", [
    (torch.float32, 300, 8, 40, False, "contiguous"),
    (torch.float32, 129, 40, 130, False, "contiguous"),
    (torch.float32, 255, 512, 1, False, "contiguous"),
    (torch.float32, 1, 512, 8, False, "contiguous"),
    (torch.float32, 383, 64, 129, False, "contiguous"),
    (torch.float32, 200, 64, 257, False, "contiguous"),
    (torch.float32, 200, 64, 258, False, "contiguous"),
    (torch.float32, 200, 64, 274, False, "contiguous"),
    (torch.float32, 500, 512, 300, True, "contiguous"),
    (torch.float32, 300, 136, 200, False, "strided"),
    (torch.float32, 300, 136, 200, False, "misaligned"),
    (torch.bfloat16, 300, 1344, 257, False, "contiguous")])
def test_pixel_text_topk_cuda_core_edges(cuda_device, dtype, n, d, c, tied,
                                         layout):
    """The CUDA-core kernel's edges, bit-equal to the plain version on
    quantised-exact inputs: D = 8 (less than one 32-dim stage) and D = 40
    (a ragged chunk), N ragged against the 128-row block (and N = 1), C = 1
    (its two-class set empty: every pick a dead slot), C = k = 8, C one
    past a 128-class tile and one past two, 129 and 137 live classes (the
    sparse-id form of C = 258, 274: a ragged last tile of 1 and 9), a
    table of one repeated row, a strided and a misaligned table (the
    wrapper gathers its live rows), and a bf16 field beyond 1280 dims; the
    mask form, sparse global ids and an exhausted set, k = 1, 5, 8."""
    assert kernel_route(dtype, d) == "pixel_text_topk[fp32]"
    _hold_pixel_topk(cuda_device, torch.Generator().manual_seed(6), dtype,
                     n, d, c, tied, layout)


def _vjp_scale(x, g):
    """Per row, the largest |g| / max(||x||, eps): the size of the VJP's
    first term, which its second term can cancel."""
    n = torch.linalg.vector_norm(x.double(), dim=-1, keepdim=True)
    return g.double().abs().amax(dim=-1, keepdim=True) / n.clamp_min(1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 16, 16, 512), (1000, 136), (3, 8)])
def test_l2_normalize_matches_plain(cuda_device, dtype, shape):
    """Forward and backward kernels against autograd of the plain version
    on the card: f32 rtol 1e-6 (values) and 1e-5 (gradients); bf16 values
    within one bf16 ulp, bf16 gradients within one bf16 ulp plus 2^-16 of
    the row's VJP scale (the two terms of dx cancel, so f32 rounding of
    each can exceed an ulp of the small difference); zero rows finite."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=gen).to(dtype).to(cuda_device)
    x.view(-1, shape[-1])[0] = 0
    g = torch.randn(shape, generator=gen).to(dtype).to(cuda_device)
    xk = x.clone().requires_grad_()
    before = dict(_lib.launch_counts)
    y = l2_normalize_rows(xk)
    y.backward(g)
    torch.cuda.synchronize()
    assert _lib.launch_counts["l2_normalize[fwd]"] == \
        before["l2_normalize[fwd]"] + 1
    assert _lib.launch_counts["l2_normalize[bwd]"] == \
        before["l2_normalize[bwd]"] + 1
    xp = x.clone().requires_grad_()
    y_plain = l2_normalize_plain(xp)
    y_plain.backward(g)
    assert y.dtype == dtype and xk.grad.dtype == dtype
    assert torch.isfinite(xk.grad).all()
    for got, want, rtol, scale in ((y, y_plain, 1e-6, 0.0),
                                   (xk.grad, xp.grad, 1e-5,
                                    _vjp_scale(x, g) * 2.0 ** -16)):
        got, want = got.detach().double(), want.detach().double()
        if dtype == torch.bfloat16:
            ulp = torch.exp2(torch.floor(torch.log2(
                want.abs().clamp_min(1e-30))) - 7)
            assert bool(((got - want).abs() <= ulp + scale).all())
        else:
            torch.testing.assert_close(got, want, rtol=rtol, atol=1e-6)


@pytest.mark.cuda
def test_predict_unfolded_on_cuda_matches_cpu(cuda_device):
    """DepthUNet.predict on the card (the pixel_text_topk kernel) against
    the same model on the CPU (plain scoring): fp32 labels >= 99.9%; the
    bf16 native field runs the l2_normalize kernels forward and backward."""
    cfg = DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                          embedding_dim=128)
    gen = torch.Generator().manual_seed(7)
    model = DepthUNet(cfg, generator=gen).eval()
    depth = torch.randn(8, 32, 32, generator=gen)
    text = torch.randn(1000, 128, generator=gen)
    mask = torch.rand(1000, generator=gen) > 0.5
    want = model.predict(depth, text, mask, 5)[0]
    before = _lib.launch_counts["pixel_text_topk[fp32]"]
    got = model.to(cuda_device).predict(depth.to(cuda_device),
                                        text.to(cuda_device),
                                        mask.to(cuda_device), 5)[0]
    torch.cuda.synchronize()
    assert _lib.launch_counts["pixel_text_topk[fp32]"] == before + 1
    assert (got.cpu() == want).float().mean() >= 0.999

    bf16 = DepthUNet(dataclasses.replace(cfg, dtype=torch.bfloat16),
                     device=cuda_device)
    bf16.load_state_dict(model.state_dict())
    before = dict(_lib.launch_counts)
    field, _, _ = bf16.forward_native(depth.to(cuda_device))
    field.float().sum().backward()
    torch.cuda.synchronize()
    for name in ("l2_normalize[fwd]", "l2_normalize[bwd]"):
        assert _lib.launch_counts[name] == before[name] + 1
    assert torch.isfinite(bf16.decoder.output_conv.conv.weight.grad).all()


def _counted(name, fn):
    """fn() with the launches of ``name`` it made."""
    before = _lib.launch_counts[name]
    out = fn()
    torch.cuda.synchronize()
    return out, _lib.launch_counts[name] - before


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,n_bins", [(32, 45875, 65536), (3, 1000, 70000),
                                           (2, 5, 7), (1, 0, 3)])
def test_histogram_matches_plain(cuda_device, rows, n, n_bins):
    """Bit-equal, with -1 padding and indices past the last bin ignored."""
    gen = torch.Generator().manual_seed(8)
    idx = torch.randint(-1, n_bins + 2, (rows, n), generator=gen,
                        dtype=torch.int32)
    got, launches = _counted("histogram",
                             lambda: histogram(idx.to(cuda_device), n_bins))
    assert launches == 1
    assert torch.equal(got.cpu(), histogram_plain(idx, n_bins))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,n_bins,offset", [
    (32, 1, 65536, 0), (32, 3, 65536, 1), (32, 45875, 65536, 0),
    (32, 45876, 65536, 3), (1, 45875, 65536, 2), (1, 7, 8193, 0),
    (65535, 3, 16, 0), (65535, 5, 9000, 1), (4, 100_000, 20, 2)])
def test_histogram_rows_and_offsets(cuda_device, rows, n, n_bins, offset):
    """Bit-equal to the plain version in one launch: n in {1, 3, 45,875,
    45,876} (rows starting off a 16-byte boundary), one row, 65,535 rows,
    a bin range past 8192, many draws per bin, and a storage-offset view
    of the draws."""
    gen = torch.Generator().manual_seed(9 + n + rows)
    idx = torch.randint(-1, n_bins + 2, (rows, n), generator=gen,
                        dtype=torch.int32)
    idx_d = _offset_view(idx.flatten(), offset, cuda_device).view(rows, n)
    assert idx_d.is_contiguous()
    got, launches = _counted("histogram", lambda: histogram(idx_d, n_bins))
    assert launches == 1
    assert torch.equal(got.cpu(), histogram_plain(idx, n_bins))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65535, 65536, 100_000])
def test_histogram_counts_past_16_bits(cuda_device, n):
    """Every draw in one bin: the count n exact whether the kernel counts in
    16 bits (n < 2^16) or in 32."""
    idx = torch.zeros(2, n, dtype=torch.int32)
    idx[1, ::2] = 40_000
    got = histogram(idx.to(cuda_device), 65536)
    assert torch.equal(got.cpu(), histogram_plain(idx, 65536))
    assert got[0, 0] == n


def _ce_inputs(gen, dtype, n, d, c, slots, members, capacity=None):
    """(samples, temperature, labels, valid, table, mask, packed) with the
    valid labels members of the contrast set (packed-path precondition)."""
    samples = torch.randn(n, d, generator=gen).to(dtype)
    table = torch.nn.functional.normalize(torch.randn(c, d, generator=gen),
                                          dim=-1).to(dtype)
    member_ids = torch.randperm(c, generator=gen)[:members].sort().values
    mask = torch.zeros(c, dtype=torch.int32)
    mask[member_ids] = 1
    labels = member_ids[torch.randint(0, members, (slots, n),
                                      generator=gen)].int()
    labels[:, ::17] = c + 3  # out of range: picks nothing
    valid = torch.randint(0, 3, (slots, n), generator=gen).float()
    temperature = torch.tensor(0.07)
    packed = None
    if capacity is not None:
        ids = torch.full((capacity,), c, dtype=torch.int32)
        ids[:min(members, capacity)] = member_ids[:capacity].int()
        ptable = table[ids.clamp_max(c - 1).long()]
        packed = (ptable, (ids < c).int(), ids,
                  torch.tensor(int(members <= capacity)))
    return samples, temperature, labels, valid, table, mask, packed


def _within_bf16(got, want, slack):
    got, want = got.double(), want.double()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return bool(((got - want).abs() <= ulp + slack).all())


def _hold_ce(loss, xs_grad, ts_grad, args, packed, dtype, device):
    """The fused CE's value and gradients against the plain versions at the
    tolerances of test_pixel_text_ce_matches_plain."""
    want = pixel_text_ce_plain(*args, packed=packed)
    dx, dt = pixel_text_ce_backward_plain(torch.tensor(1.0, device=device),
                                          *args, packed=packed)
    torch.testing.assert_close(loss, want, rtol=2e-5, atol=1e-4)
    torch.testing.assert_close(ts_grad, dt, rtol=2e-5, atol=1e-4)
    scale = dx.double().abs().amax(dim=-1, keepdim=True)
    err = (xs_grad.double() - dx.double()).abs()
    if dtype == torch.bfloat16:
        assert _within_bf16(xs_grad, dx, scale * 2.0 ** -10)
    else:
        assert bool((err <= 1e-4 * scale + 1e-9).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [136, 768, 20, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("form", ["full", "packed", "overflow"])
def test_pixel_text_ce_matches_plain(cuda_device, dtype, slots, form, d):
    """Forward (the summed CE), d samples and d temperature against the
    plain versions on the card.  Values and d temperature within rtol 2e-5
    (f32 sums in another order, and an online max over class tiles); d
    samples f32 within 1e-4 of the row's largest entry, bf16 within one
    bf16 ulp plus 2^-10 of the row's largest entry (an order change in f32
    can flip a bf16 rounding, and d samples subtracts its projection).
    A bf16 packed table also launches the tensor-core kernels, which write
    only where the device flag selects it (not in the overflow form); the
    member-only kernels beside them write otherwise.  D = 20 and 100 are
    zero-padded to 24 and 104 by the wrapper, the plain versions run
    unpadded."""
    gen = torch.Generator().manual_seed(9)
    n, c = 1111, 300
    capacity = None if form == "full" else 128
    members = 140 if form == "overflow" else 60
    samples, temperature, labels, valid, table, mask, packed = _ce_inputs(
        gen, dtype, n, d, c, slots, members, capacity)
    dev = lambda t: t.to(cuda_device)
    packed_d = None if packed is None else tuple(map(dev, packed))
    xs = dev(samples).requires_grad_()
    ts = dev(temperature).requires_grad_()
    before = dict(_lib.launch_counts)
    loss = fused_pixel_text_ce(xs, ts, dev(labels), dev(valid), dev(table),
                               dev(mask), packed_d)
    loss.backward()
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16 and packed is not None)
    for name, launches in (("pixel_text_ce[fwd]", 1),
                           ("pixel_text_ce[bwd]", 1),
                           ("pixel_text_ce_tc[fwd]", tc),
                           ("pixel_text_ce_tc[bwd]", tc)):
        assert _lib.launch_counts[name] == before[name] + launches, name
    args = (dev(samples), dev(temperature), dev(labels), dev(valid),
            dev(table), dev(mask))
    _hold_ce(loss.detach(), xs.grad, ts.grad, args, packed_d, dtype,
             cuda_device)


def _member_inputs(gen, dtype, n, d, c, slots, members, form, capacity=128):
    """Inputs of the member-only kernels: labels of any class (members,
    non-members in [0, C), and classes outside it), and the valid weights
    with the non-member labels' zeroed; a packed table of ``capacity`` for
    the packed and overflow forms."""
    samples = torch.randn(n, d, generator=gen).to(dtype)
    table = torch.nn.functional.normalize(torch.randn(c, d, generator=gen),
                                          dim=-1).to(dtype)
    member_ids = torch.randperm(c, generator=gen)[:members].sort().values
    mask = torch.zeros(c, dtype=torch.int32)
    mask[member_ids] = 1
    labels = torch.randint(0, c, (slots, n), generator=gen, dtype=torch.int32)
    if members:
        labels[:, ::3] = member_ids[torch.randint(
            0, members, labels[:, ::3].shape, generator=gen)].int()
    labels[:, ::17] = c + 3
    labels[:, 5::19] = -2
    valid = torch.randint(0, 3, (slots, n), generator=gen).float()
    nonmember = (labels >= 0) & (labels < c) & (
        mask[labels.clamp(0, c - 1).long()] == 0)
    packed = None
    if form != "full":
        ids = torch.full((capacity,), c, dtype=torch.int32)
        ids[:min(members, capacity)] = member_ids[:capacity].int()
        packed = (table[ids.clamp_max(c - 1).long()], (ids < c).int(), ids,
                  torch.tensor(int(form == "packed")))
    return (samples, torch.tensor(0.07), labels, valid,
            torch.where(nonmember, 0.0, valid), table, mask, packed)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,members,slots,form,n", [
    *[(dt, 136, m, 4, "full", 1111)
      for dt in (torch.float32, torch.bfloat16)
      for m in (0, 1, 64, 65, 128, 129, 300)],
    *[(dt, d, 90, 1, "full", 1111)
      for dt in (torch.float32, torch.bfloat16) for d in (8, 768, 1344)],
    (torch.float32, 136, 60, 4, "packed", 1111),
    (torch.float32, 136, 140, 4, "overflow", 1111),
    (torch.bfloat16, 1344, 60, 1, "packed", 1111),
    (torch.bfloat16, 1344, 140, 1, "overflow", 1111),
    (torch.float32, 136, 90, 4, "full", 1),
    (torch.bfloat16, 136, 90, 4, "full", 129)])
def test_pixel_text_ce_members_forward(cuda_device, dtype, d, members,
                                       slots, form, n):
    """The member-only forward (every route without a tensor-core kernel
    beside it: f32, bf16 over the full table, bf16 packed beyond D = 1280)
    against the plain version over C = 300 at the tolerance of
    test_pixel_text_ce_matches_plain (rtol 2e-5): with the non-member
    labels weighted (each picks -1e30, so the sum is near 1e30 times their
    weight) and with them at weight 0 (the members' part alone).  0 to all
    300 classes members, one and two class tiles and their edges (64, 65,
    128, 129), labels outside [0, C), one and four slots, D = 8 to 1344,
    ragged N, and the packed table where the device flag selects it and
    where it does not.  One launch per call, none of the tensor-core
    kernel's."""
    gen = torch.Generator().manual_seed(21)
    (samples, temperature, labels, valid, valid_members, table, mask,
     packed) = _member_inputs(gen, dtype, n, d, 300, slots, members, form)
    dev = lambda t: t.to(cuda_device)
    packed_d = None if packed is None else tuple(map(dev, packed))
    before = dict(_lib.launch_counts)
    for weights in (valid, valid_members):
        args = tuple(map(dev, (samples, temperature, labels, weights, table,
                               mask)))
        got = fused_pixel_text_ce(*args, packed_d)
        want = pixel_text_ce_plain(*args, packed=packed_d)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4)
    torch.cuda.synchronize()
    assert _lib.launch_counts["pixel_text_ce[fwd]"] == (
        before["pixel_text_ce[fwd]"] + 2)
    assert (_lib.launch_counts["pixel_text_ce_tc[fwd]"]
            == before["pixel_text_ce_tc[fwd]"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,members,slots,form,n,capacity", [
    *[(dt, 136, m, 4, "full", 1111, 128)
      for dt in (torch.float32, torch.bfloat16)
      for m in (0, 2, 64, 65, 90, 128, 129, 200, 300)],
    *[(dt, d, 90, 1, "full", 1111, 128)
      for dt in (torch.float32, torch.bfloat16)
      for d in (8, 648, 656, 768, 1344)],
    *[(dt, 136, m, s, form, 1111, 128)
      for dt in (torch.float32, torch.bfloat16)
      for m, form in ((60, "packed"), (140, "overflow")) for s in (1, 4)],
    (torch.bfloat16, 136, 200, 4, "packed", 1111, 256),
    (torch.bfloat16, 136, 300, 4, "overflow", 1111, 256),
    (torch.float32, 136, 200, 1, "packed", 1111, 256),
    (torch.float32, 136, 90, 4, "full", 1, 128),
    (torch.bfloat16, 136, 90, 4, "full", 129, 128),
    (torch.float32, 648, 200, 2, "full", 129, 128)])
def test_pixel_text_ce_members_backward(cuda_device, dtype, d, members,
                                        slots, form, n, capacity):
    """The member-only backward (every route but the tensor-core packed
    branch: f32, bf16 over the full table, bf16 with the flag at 0 beside
    the tensor-core kernels, a bf16 packed table past K = 128 or D = 1280)
    against the plain version over C = 300 at the tolerances of
    test_pixel_text_ce_matches_plain, unloosened: with the non-member
    labels weighted (a valid label of a class in [0, C) outside the set
    adds its table row to d samples and -1e30 to d tau) and at weight 0.
    0 to all 300 classes members (none: every row scored at -1e30; one,
    two and three class tiles and their edges), labels outside [0, C), one
    to four slots, D = 8 to 1344, N = 1, 129 and a ragged 1111, the packed
    table with the flag either way at K = 128 and 256.  Each backward is
    one launch of pixel_text_ce[bwd] and one of the gather; two calls are
    bit-equal."""
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import (
        ce_operands,
        pixel_text_ce_backward_op,
        pixel_text_ce_op,
    )

    gen = torch.Generator().manual_seed(23)
    (samples, temperature, labels, valid, valid_members, table, mask,
     packed) = _member_inputs(gen, dtype, n, d, 300, slots, members, form,
                              capacity)
    dev = lambda t: t.to(cuda_device)
    packed_d = None if packed is None else tuple(map(dev, packed))
    for weights in (valid, valid_members):
        args = tuple(map(dev, (samples, temperature, labels, weights, table,
                               mask)))
        xs = args[0].clone().requires_grad_()
        ts = args[1].clone().requires_grad_()
        before = dict(_lib.launch_counts)
        loss = fused_pixel_text_ce(xs, ts, *args[2:], packed_d)
        loss.backward()
        torch.cuda.synchronize()
        assert _lib.launch_counts["pixel_text_ce[bwd]"] == (
            before["pixel_text_ce[bwd]"] + 1)
        assert _lib.launch_counts["live_rows"] == before["live_rows"] + 2
        _hold_ce(loss.detach(), xs.grad, ts.grad, args, packed_d, dtype,
                 cuda_device)
    operands = ce_operands(*args, packed_d)
    op_args = (operands[0], args[1], operands[1], operands[2], args[4],
               *operands[3:])
    g = torch.tensor(0.37, device=cuda_device)
    stats = pixel_text_ce_op(*op_args)[1]
    first = pixel_text_ce_backward_op(g, stats, *op_args)
    second = pixel_text_ce_backward_op(g, stats, *op_args)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                            second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,d", [(1, 8), (7, 24), (130, 136), (1000, 512)])
@pytest.mark.parametrize("live", ["none", "some", "all"])
def test_live_rows_matches_live_table(cuda_device, dtype, c, d, live):
    """The gather kernel bit-equal to its plain version (live_table):
    ids-keyed (pixel_text_topk's form, -1 dead) and mask-keyed (the CE's),
    with none, some and all rows live, C % 4 != 0 (zero padding columns);
    and the CE's two-table form (member_table) with the device flag either
    way, the selected table first.  One launch each."""
    from rangeclip_tpu_torch.ops.kernels.live_rows import (
        live_rows,
        live_table,
    )
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import member_table

    gen = torch.Generator().manual_seed(24)
    table = torch.randn(c, d, generator=gen).to(dtype)
    keep = {"none": torch.zeros(c, dtype=torch.bool),
            "all": torch.ones(c, dtype=torch.bool),
            "some": torch.rand(c, generator=gen) < 0.4}[live]
    ids = torch.where(keep, torch.randperm(c, generator=gen).int(), -1)
    dev = lambda t: t.to(cuda_device)
    cases = [
        (lambda: live_rows(dev(table), dev(ids)),
         live_table(table, ids)),
        (lambda: live_rows(dev(table), None, dev(keep.int())),
         live_table(table, torch.arange(c, dtype=torch.int32), keep)),
    ]
    K = 32
    pids = torch.full((K,), c, dtype=torch.int32)
    members = keep.nonzero()[:, 0].int()[:K]
    pids[:members.numel()] = members
    ptable = table[pids.clamp_max(c - 1).long()]
    for flag in (0, 1):
        fl = torch.tensor([flag], dtype=torch.int32)
        sel = (ptable, pids) if flag else (table,
                                           torch.arange(c, dtype=torch.int32))
        other = (table, torch.arange(c, dtype=torch.int32)) if flag else (
            ptable, pids)
        sel_live = (pids < c) if flag else keep
        want = live_table(torch.cat([sel[0], other[0]]),
                          torch.cat([sel[1], other[1]]),
                          torch.cat([sel_live, torch.zeros(
                              other[0].shape[0], dtype=torch.bool)]))
        cases.append((lambda fl=fl: member_table(
            dev(table), dev(keep.int()), dev(ptable), dev((pids < c).int()),
            dev(pids), dev(fl)), want))
    for run, want in cases:
        got, launches = _counted("live_rows", run)
        assert launches == 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (g.shape, w.shape)


def _tc_ce(samples, temperature, labels, valid, packed, flag=None):
    """The tensor-core kernels launched directly (flag None: always run):
    (per-row ce [N], dx [N, D], per-row dtau [N]), each filled with NaN
    before the launch, and whether the backward took the shape."""
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import transposed_table

    lib, stream = _lib.library(), _lib.stream_of(samples)
    ptable, pmask, pids, _ = packed
    N, D = samples.shape
    S, K = labels.shape[0], ptable.shape[0]
    ce = torch.full((N,), float("nan"), device=samples.device)
    dx = torch.full_like(samples, float("nan"))
    dtau = torch.full((N,), float("nan"), device=samples.device)
    coeff = torch.tensor(1.0, device=samples.device)
    fp = None if flag is None else flag.data_ptr()
    ptable_t = transposed_table(ptable)
    assert lib.rc_pixel_text_ce_tc_fwd(
        samples.data_ptr(), temperature.data_ptr(), labels.data_ptr(),
        valid.data_ptr(), S, N, D, ptable.data_ptr(), pmask.data_ptr(),
        pids.data_ptr(), K, fp, ce.data_ptr(), None, stream) == 0
    code = lib.rc_pixel_text_ce_tc_bwd(
        samples.data_ptr(), temperature.data_ptr(), coeff.data_ptr(),
        labels.data_ptr(), valid.data_ptr(), S, N, D, ptable.data_ptr(),
        ptable_t.data_ptr(), pmask.data_ptr(), pids.data_ptr(), K, fp,
        dx.data_ptr(), dtau.data_ptr(), stream)
    torch.cuda.synchronize()
    return ce, dx, dtau, code == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 136, 512])
@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("capacity", [128, 256])
def test_pixel_text_ce_tc_kernels_match_plain(cuda_device, capacity, slots,
                                              d):
    """The tensor-core kernels' entry points launched directly on a packed
    bf16 table, N = 1111, against the plain versions at the tolerances of
    test_pixel_text_ce_matches_plain.  K = 256 takes two class tiles in the
    forward (an online max); the backward keeps delta for one tile in
    registers and refuses K > 128.  With the device flag at 0 neither
    kernel writes."""
    gen = torch.Generator().manual_seed(18)
    n, c = 1111, 300
    members = 60 if capacity == 128 else 200
    samples, temperature, labels, valid, table, mask, packed = _ce_inputs(
        gen, torch.bfloat16, n, d, c, slots, members, capacity)
    dev = lambda t: t.to(cuda_device)
    args = tuple(map(dev, (samples, temperature, labels, valid, table,
                           mask)))
    packed_d = tuple(map(dev, packed))
    ce, dx, dtau, bwd_ran = _tc_ce(args[0], args[1], args[2], args[3],
                                   packed_d)
    assert bwd_ran == (capacity <= 128)
    if bwd_ran:
        _hold_ce(ce.sum(), dx, dtau.sum() / args[1], args, packed_d,
                 torch.bfloat16, cuda_device)
    else:
        torch.testing.assert_close(
            ce.sum(), pixel_text_ce_plain(*args, packed=packed_d),
            rtol=2e-5, atol=1e-4)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    ce, dx, dtau, _ = _tc_ce(args[0], args[1], args[2], args[3], packed_d,
                             flag)
    assert bool(ce.isnan().all() and dx.isnan().all() and dtau.isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,weights,upsample", [
    ((3, 10, 16, 128), (1.0, 0.0, 1.0), 2),
    ((2, 128, 128, 512), None, 2),
    ((1, 2, 8, 8), (1.0,), 1),
    ((1, 2, 2, 8), (1.0,), 1),
    ((2, 33, 35, 136), (0.0, 1.0), 2),
    ((3, 65, 97, 8), (1.0, 0.0, 1.0), 1),
    ((1, 31, 64, 264), None, 2)])
def test_tv_rowtile_matches_plain(cuda_device, shape, weights, upsample):
    """bf16 with ties (quantised values), several row tiles and a ragged
    last one, a zero sample weight: the backward bit-equal to the plain VJP,
    the forward within rtol 1e-5 (f32 summation order).  The backward's
    edges: H = 2 and W = 2, H and W ragged against its 32-row band and
    32-column tile, D = 8 and channel chunks ragged against 64 (136,
    264)."""
    gen = torch.Generator().manual_seed(10)
    x = (torch.randint(-6, 7, shape, generator=gen) / 4
         + torch.randn(shape, generator=gen) * (torch.rand(shape, generator=gen) > 0.5)
         ).to(torch.bfloat16).to(cuda_device)
    w = None if weights is None else torch.tensor(weights, device=cuda_device)
    xk = x.clone().requires_grad_()
    before = dict(_lib.launch_counts)
    value = tv_rowtile(xk, w, upsample)
    value.backward(torch.tensor(1.7, device=cuda_device))
    torch.cuda.synchronize()
    for name in ("tv_rowtile[fwd]", "tv_rowtile[bwd]"):
        assert _lib.launch_counts[name] == before[name] + 1
    xp = x.clone().requires_grad_()
    want = tv_rowtile_plain(xp, w, upsample)
    want.backward(torch.tensor(1.7, device=cuda_device))
    torch.testing.assert_close(value.detach(), want.detach(), rtol=1e-5,
                               atol=0.0)
    assert torch.equal(xk.grad, xp.grad)


@pytest.mark.cuda
def test_tv_rowtile_backward_past_the_forward_grid(cuda_device):
    """B * ceil(H / 8) = 65,544, past the grid the forward once had: both
    one-dimensional grids take the shape, the value within rtol 1e-5 of the
    plain version and the backward bit-equal to the plain VJP."""
    shape = (8193, 64, 2, 8)
    gen = torch.Generator().manual_seed(11)
    x = (torch.randint(-6, 7, shape, generator=gen) / 4).to(
        torch.bfloat16).to(cuda_device)
    grad = torch.tensor(1.7, device=cuda_device)
    before = dict(_lib.launch_counts)
    value = tv_rowtile(x)
    got = tv_rowtile_backward_op(x, None, grad, 1)
    torch.cuda.synchronize()
    for name in ("tv_rowtile[fwd]", "tv_rowtile[bwd]"):
        assert _lib.launch_counts[name] == before[name] + 1
    xp = x.clone().requires_grad_()
    want = tv_rowtile_plain(xp, None, 1)
    want.backward(grad)
    torch.testing.assert_close(value, want.detach(), rtol=1e-5, atol=0.0)
    assert torch.equal(got, xp.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,upsample", [((32, 128, 128, 512), 2),
                                            ((3, 65, 97, 136), 1)])
def test_tv_rowtile_forward_is_deterministic(cuda_device, shape, upsample):
    """Two forward calls are bit-equal (the partials are summed in block
    order), each one launch of tv_rowtile[fwd], within rtol 1e-5 of the
    plain value."""
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(shape, generator=gen).to(torch.bfloat16).to(cuda_device)
    w = torch.ones(shape[0], device=cuda_device)
    w[-1] = 0.0
    values = []
    for _ in range(2):
        values.append(_counted("tv_rowtile[fwd]",
                               lambda: tv_rowtile(x, w, upsample)))
    assert [launches for _, launches in values] == [1, 1]
    assert torch.equal(values[0][0], values[1][0])
    torch.testing.assert_close(values[0][0], tv_rowtile_plain(x, w, upsample),
                               rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_training_ops_pass_opcheck(cuda_device):
    """The training operators' fake implementations, schemas and autograd
    registrations against their CUDA implementations."""
    from rangeclip_tpu_torch.ops.kernels.class_presence import (
        class_presence_op,
    )
    from rangeclip_tpu_torch.ops.kernels.histogram import histogram_op
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import (
        ce_operands,
        pixel_text_ce_op,
    )
    from rangeclip_tpu_torch.ops.kernels.tv_rowtile import tv_rowtile_op

    gen = torch.Generator().manual_seed(11)
    dev = lambda t: t.to(cuda_device)
    torch.library.opcheck(histogram_op, (dev(torch.randint(
        -1, 70, (3, 50), generator=gen, dtype=torch.int32)), 64))
    labels = dev(torch.randint(-1, 40, (999,), generator=gen,
                               dtype=torch.int32))
    for valid in (dev(torch.rand(999, generator=gen)), None):
        torch.library.opcheck(class_presence_op, (labels, valid, 33))
    x = dev(torch.randn(2, 4, 8, 16, generator=gen).bfloat16())
    torch.library.opcheck(tv_rowtile_op, (x.requires_grad_(),
                                          dev(torch.tensor([1.0, 0.0])), 2))
    samples, temperature, labels, valid, table, mask, packed = _ce_inputs(
        gen, torch.bfloat16, 200, 32, 300, 4, 60, 128)
    flat, lab, val, msk, pt, pm, pi, flag = ce_operands(
        dev(samples), dev(temperature), dev(labels), dev(valid), dev(table),
        dev(mask), tuple(map(dev, packed)))
    torch.library.opcheck(pixel_text_ce_op, (
        flat.requires_grad_(), dev(temperature).requires_grad_(), lab, val,
        dev(table), msk, pt, pm, pi, flag))
    # the member-only kernels: fp32 over the full table, and bf16 with the
    # flag at 0 (beside the tensor-core kernels)
    for dtype, form in ((torch.float32, "full"), (torch.bfloat16,
                                                   "overflow")):
        (samples, temperature, labels, valid, _, table, mask,
         packed) = _member_inputs(gen, dtype, 200, 32, 300, 4, 140, form)
        flat, lab, val, msk, pt, pm, pi, flag = ce_operands(
            dev(samples), dev(temperature), dev(labels), dev(valid),
            dev(table), dev(mask),
            None if packed is None else tuple(map(dev, packed)))
        torch.library.opcheck(pixel_text_ce_op, (
            flat.requires_grad_(), dev(temperature).requires_grad_(), lab,
            val, dev(table), msk, pt, pm, pi, flag))


@pytest.mark.cuda
@pytest.mark.parametrize("P,D,dtype", [(70_000, 512, torch.bfloat16),
                                       (5000, 40, torch.float32),
                                       (17, 8, torch.float32),
                                       (5000, 20, torch.bfloat16),
                                       (3000, 100, torch.float32),
                                       (2000, 2056, torch.bfloat16)])
def test_masked_pooling_matches_plain(cuda_device, P, D, dtype):
    """Counts exact, sums within rtol 1e-5 of the dense match product (f32
    sums in another order), the same bits on a second run (no atomics);
    duplicate, absent and -1 labels as the plain version has them.  D % 8
    != 0 is zero-padded; D past 2048 runs as column chunks of at most 2048,
    one launch each."""
    from rangeclip_tpu_torch.ops.kernels.masked_pooling import (
        fused_masked_pooling,
        masked_pooling_plain,
    )

    gen = torch.Generator().manual_seed(12)
    emb = torch.randn(P, D, generator=gen).to(dtype).to(cuda_device)
    seg = torch.randint(-1, 40, (P,), generator=gen,
                        dtype=torch.int32).to(cuda_device)
    obj = torch.tensor([0, 5, 5, 39, 77, 12, 1000],
                       dtype=torch.int32).to(cuda_device)
    (sums, counts), launches = _counted(
        "masked_pooling", lambda: fused_masked_pooling(emb, seg, obj))
    assert launches == -(-D // 2048)
    assert sums.shape == (obj.shape[0], D)
    want_sums, want_counts = masked_pooling_plain(emb, seg, obj)
    assert torch.equal(counts, want_counts)
    torch.testing.assert_close(sums, want_sums, rtol=1e-5, atol=1e-5)
    assert torch.equal(sums, fused_masked_pooling(emb, seg, obj)[0])
    assert (sums[4] == 0).all() and (sums[6] == 0).all()


def _regions(gen, batch, h, w, per_image):
    """[batch * h * w] int32 labels: each image in ``per_image`` Voronoi
    regions about distinct seed pixels (none empty), image b's numbered b
    * per_image + 0 .. per_image - 1."""
    pix = torch.arange(h * w)
    out = []
    for b in range(batch):
        seeds = torch.randperm(h * w, generator=gen)[:per_image]
        d2 = ((pix[:, None] // w - seeds[None] // w) ** 2
              + (pix[:, None] % w - seeds[None] % w) ** 2)
        out.append(d2.argmin(dim=1) + b * per_image)
    return torch.cat(out).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    ("regions", torch.bfloat16), ("regions", torch.float32),
    ("all_ids", torch.bfloat16), ("one_id", torch.bfloat16),
    ("padding", torch.float32), ("below_chunk", torch.bfloat16),
    ("duplicates", torch.float32), ("many_ids", torch.bfloat16)])
def test_masked_pooling_label_layouts(cuda_device, case, dtype):
    """The one-pass kernels on the label layouts their design turns on:
    spatially coherent labels (8 images of 96 x 112 in 32 Voronoi regions
    each, all 256 ids present, runs of one id crossing the sum blocks'
    segments), uniform labels over 256 ids (every id in every 8192-pixel
    chunk), one id, every label -1, fewer pixels than one chunk, duplicate
    ids (one id five times), and 1,500 ids (two id groups, two launches).
    Counts exact, sums within 1e-5 of the summed magnitudes (f32 sums in
    another order), a second run bit-equal."""
    from rangeclip_tpu_torch.ops.kernels.masked_pooling import (
        fused_masked_pooling,
        id_groups,
        masked_pooling_plain,
    )

    gen = torch.Generator().manual_seed(18)
    P, D = 8 * 96 * 112, 512
    seg = _regions(gen, 8, 96, 112, 32)
    obj = torch.arange(256, dtype=torch.int32)
    if case == "all_ids":
        P = 70_000
        seg = torch.randint(0, 256, (P,), generator=gen, dtype=torch.int32)
    elif case == "one_id":
        obj = torch.tensor([77], dtype=torch.int32)
    elif case == "padding":
        seg = torch.full((P,), -1, dtype=torch.int32)
    elif case == "below_chunk":
        P, seg = 3000, seg[:3000]
    elif case == "duplicates":
        obj = torch.tensor([5, 9, 5, 300, 5, 2, 9, 5, 5], dtype=torch.int32)
    elif case == "many_ids":
        obj = torch.randint(0, 300, (1500,), generator=gen,
                            dtype=torch.int32)
    emb = torch.randn(P, D, generator=gen).to(dtype).to(cuda_device)
    seg, obj = seg.to(cuda_device), obj.to(cuda_device)
    (sums, counts), launches = _counted(
        "masked_pooling", lambda: fused_masked_pooling(emb, seg, obj))
    assert launches == len(id_groups(obj.shape[0]))
    want, want_counts = masked_pooling_plain(emb, seg, obj)
    scale = masked_pooling_plain(emb.abs(), seg, obj)[0]
    assert torch.equal(counts, want_counts)
    assert bool(((sums - want).abs() <= 1e-5 * scale + 1e-6).all())
    again = fused_masked_pooling(emb, seg, obj)
    assert torch.equal(sums, again[0]) and torch.equal(counts, again[1])
    if case in ("regions", "all_ids"):
        assert bool((counts > 0).all())
    if case == "padding":
        assert bool((counts == 0).all() and (sums == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((3, 9, 16, 8), torch.float32),
                                         ((2, 17, 33, 24), torch.bfloat16),
                                         ((2, 64, 64, 512), torch.bfloat16),
                                         ((1, 2, 5, 8), torch.float32),
                                         ((2, 9, 10, 20), torch.bfloat16),
                                         ((1, 5, 7, 100), torch.float32),
                                         ((2, 17, 33, 100), torch.bfloat16),
                                         ((3, 9, 16, 20), torch.float32),
                                         ((2, 33, 70, 72), torch.bfloat16),
                                         ((1, 65, 33, 72), torch.bfloat16),
                                         ((2, 33, 70, 40), torch.float32),
                                         ((1, 65, 33, 40), torch.float32),
                                         ((2, 64, 64, 512), torch.float32),
                                         ((8200, 64, 2, 8), torch.bfloat16)])
def test_tv_loss_matches_plain(cuda_device, shape, dtype):
    """Quantised values with exact ties (sign(0) = 0): the backward
    bit-equal to the plain VJP, the forward within rtol 1e-5 (f32
    summation order) and bit-equal across two calls, each one launch.  D =
    20 and 100 are zero-padded by the operators, which divide by the true
    pair counts and slice the gradient back.  The band's edges: H and W
    not multiples of its 32 rows and columns (33, 65, 70), channel chunks
    ragged against 64 bf16 (72) and 32 f32 (40) channels, W = 2; and
    [8200, 64, 2, 8], past the grid the kernels once had (B * ceil(H / 8)
    <= 65535)."""
    from rangeclip_tpu_torch.ops.kernels.tv_loss import (
        fused_tv_loss,
        tv_loss_grad,
        tv_loss_value,
    )

    gen = torch.Generator().manual_seed(13)
    x = (torch.randint(-6, 7, shape, generator=gen) / 4
         + torch.randn(shape, generator=gen)
         * (torch.rand(shape, generator=gen) > 0.5)).to(dtype).to(cuda_device)
    g = torch.tensor(1.7, device=cuda_device)
    xk = x.clone().requires_grad_()
    before = dict(_lib.launch_counts)
    value = fused_tv_loss(xk)
    value.backward(g)
    torch.cuda.synchronize()
    for name in ("tv_loss[fwd]", "tv_loss[bwd]"):
        assert _lib.launch_counts[name] == before[name] + 1
    torch.testing.assert_close(value.detach(), tv_loss_value(x), rtol=1e-5,
                               atol=0.0)
    assert torch.equal(xk.grad, tv_loss_grad(x, g))
    again, launches = _counted("tv_loss[fwd]", lambda: fused_tv_loss(x))
    assert launches == 1 and torch.equal(again, value.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tv_loss_band_blocks_match_the_kernel(cuda_device, dtype):
    """The wrapper's mirror of the grid, ``band_blocks``, against the
    kernel's own count of the forward's partials (two floats a block), and
    a width the kernels refuse (D % 8 != 0) sized 0."""
    from rangeclip_tpu_torch.ops.kernels.tv_loss import band_blocks

    lib = _lib.library()
    is_bf16 = int(dtype == torch.bfloat16)
    for shape in ((32, 128, 128, 512), (8200, 64, 2, 8), (2, 33, 70, 72),
                  (1, 65, 33, 40), (1, 2, 2, 8), (3, 1, 1, 2056)):
        assert (lib.rc_tv_loss_fwd_partials(is_bf16, *shape)
                == 2 * band_blocks(shape, dtype)), shape
    assert lib.rc_tv_loss_fwd_partials(is_bf16, 2, 4, 4, 12) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [1.7, 0.0, -3e-34, 1e36])
def test_tv_loss_backward_at_every_scale(cuda_device, dtype, g):
    """The backward bit-equal to the plain VJP on both of its paths: in
    bf16, scales within 2^-100 .. 2^100 (1.7) take the products of the
    pre-rounded scales, the others (0, a scale in bf16's subnormal range,
    one past 2^100) the general path's three roundings, which f32 takes at
    every scale."""
    from rangeclip_tpu_torch.ops.kernels.tv_loss import (
        tv_loss_backward_op,
        tv_loss_grad,
    )

    shape = (2, 33, 70, 72)
    gen = torch.Generator().manual_seed(14)
    x = (torch.randint(-6, 7, shape, generator=gen) / 4).to(dtype).to(
        cuda_device)
    grad = torch.tensor(g, device=cuda_device)
    got, launches = _counted("tv_loss[bwd]",
                             lambda: tv_loss_backward_op(x, grad, shape[-1]))
    assert launches == 1
    assert torch.equal(got, tv_loss_grad(x, grad))


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,w,dtype,C,C_in,D,k", [
    (2, 16, 16, torch.float32, 512, 32, 512, 5),
    (3, 7, 7, torch.float32, 130, 32, 512, 5),
    (2, 12, 12, torch.bfloat16, 40, 32, 512, 5),
    (2, 70, 70, torch.float32, 130, 32, 768, 5),
    (2, 12, 12, torch.bfloat16, 40, 32, 768, 5),
    (3, 9, 9, torch.float32, 40, 12, 20, 5),
    (2, 12, 12, torch.bfloat16, 40, 12, 20, 5),
    (3, 7, 9, torch.bfloat16, 130, 8, 8, 1),
    (2, 9, 11, torch.bfloat16, 512, 64, 136, 8),
    (1, 40, 41, torch.bfloat16, 512, 64, 512, 5),
    (1, 1, 200, torch.bfloat16, 130, 32, 512, 5),
    (1, 150, 1, torch.bfloat16, 1, 32, 512, 5),
    (2, 16, 16, torch.bfloat16, 512, 32, 520, 5),
    (2, 10, 10, torch.bfloat16, 40, 72, 64, 5),
    (1, 5, 7, torch.float32, 130, 32, 512, 5),
    (2, 15, 17, torch.float32, 512, 32, 512, 1),
    (2, 12, 13, torch.float32, 130, 16, 1288, 5),
    (2, 11, 9, torch.float32, 200, 72, 136, 5),
    (2, 16, 16, torch.float32, 512, 32, 512, 8),
    (1, 13, 14, torch.bfloat16, 130, 72, 768, 8)])
def test_head_topk_matches_plain(cuda_device, B, h, w, dtype, C, C_in, D, k):
    """Ids against the plain version: every mismatch a near-tie (the
    winning values within 1e-5 in f32, and within 1e-3, two bf16 ulps of the
    top scores, in bf16, where an embedding component's rounding may flip
    with the conv's summation order); a mask of 3 live classes, or none,
    gives id 0 at -1e30 past them.  Each call counts one launch of its
    route and none of the other (nor of ``live_rows``): bf16 with C_in <= 64 and D <= 512 the
    tensor-core kernel (C_in 8 and 64, D 8, 136 and 512, C 1, 130 and 512,
    k 1, 5 and 8, pixel counts off the 64-pixel tile, h = 1, w = 1), f32
    and bf16 past those widths (D = 520, C_in = 72) the CUDA-core one.
    The CUDA-core route (a gather, a conv and a scoring launch on the f32
    loop, its f32 field in a workspace): fewer pixels than one 128-pixel
    tile (35), a ragged last tile (510), D = 768 (9,800 pixels) and 1288,
    C_in = 12 (padded to 16), 16 and 72 (the im2col chunk not one tap), k =
    1, 5 and 8, and bf16 at C_in = 72, D = 768, k = 8; C_in = 12, D = 20
    runs on operands zero-padded to 16 and 24.  Masks: random (70% live),
    3 live classes, none, and 130 live where C >= 130; a second call gives
    the same bits."""
    from rangeclip_tpu_torch.ops.kernels.head_topk import (
        fused_head_score_topk,
        head_topk_plain,
        kernel_route,
    )

    gen = torch.Generator().manual_seed(14)
    feats = torch.randn(B, h, w, C_in, generator=gen).to(dtype)
    rows = torch.randn(9 * C_in, D, generator=gen) / 17
    text = l2_normalize(torch.randn(C, D, generator=gen), dim=-1)
    route = kernel_route(dtype, C_in, D)
    assert route == ("head_topk[bf16]" if dtype == torch.bfloat16
                     and C_in <= 64 and D <= 512 else "head_topk[fp32]")
    dev = lambda t: t.to(cuda_device)
    masks = [torch.rand(C, generator=gen) < 0.7,
             torch.isin(torch.arange(C), torch.tensor([4, 9, 33])),
             torch.zeros(C, dtype=torch.bool)]
    if C >= 130:
        masks.append(torch.isin(torch.arange(C),
                                torch.randperm(C, generator=gen)[:130]))
    for m in masks:
        before = dict(_lib.launch_counts)
        idx, val = fused_head_score_topk(dev(feats), dev(rows), dev(text),
                                         dev(m), k)
        again = fused_head_score_topk(dev(feats), dev(rows), dev(text),
                                      dev(m), k)
        torch.cuda.synchronize()
        assert torch.equal(idx, again[0]) and torch.equal(val, again[1])
        assert {name: _lib.launch_counts[name] - before[name]
                for name in ("head_topk[bf16]", "head_topk[fp32]")} == {
            name: 2 * int(name == route)
            for name in ("head_topk[bf16]", "head_topk[fp32]")}
        assert _lib.launch_counts["live_rows"] == before["live_rows"]
        want_idx, want_val = head_topk_plain(
            dev(feats), dev(rows).to(dtype), dev(text).to(dtype),
            dev(m).int(), k)
        tol = 1e-5 if dtype == torch.float32 else 1e-3
        torch.testing.assert_close(val, want_val, rtol=0, atol=tol)
        agree = float((idx == want_idx).float().mean())
        assert agree >= (0.999 if dtype == torch.float32 else 0.99), agree
        live = int(m.sum())
        assert bool((idx[:, live:] == 0).all()
                    and (val[:, live:] == -1e30).all())


@pytest.mark.cuda
def test_head_topk_route_matches_the_kernel(cuda_device):
    """The route's width limits (``kernel_route``: TC_MAX_C_IN,
    TC_MAX_DIMS) against the tensor-core kernel's own (``tc_head::fits``):
    its C entry point, called on one pixel, launches at exactly the widths
    the route gives it, C_in = 8..80 and D from 8 to 1024, and refuses the
    others."""
    from rangeclip_tpu_torch.ops.kernels.head_topk import kernel_route

    lib = _lib.library()
    stream = _lib.stream_of(torch.empty(0, device=cuda_device))
    bf16 = dict(dtype=torch.bfloat16, device=cuda_device)
    ids = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    count = torch.tensor([2], dtype=torch.int32, device=cuda_device)
    idx = torch.empty(1, 1, dtype=torch.int32, device=cuda_device)
    val = torch.empty(1, 1, device=cuda_device)
    for c_in in range(8, 81, 8):
        for d in (8, 136, 504, 512, 520, 1024):
            feats = torch.ones(1, 1, 1, c_in, **bf16)
            wt = torch.ones(d, 9 * c_in, **bf16)
            table = torch.ones(2, d, **bf16)
            code = lib.rc_head_topk_tc(
                feats.data_ptr(), wt.data_ptr(), table.data_ptr(),
                ids.data_ptr(), count.data_ptr(), 1, 1, 1, c_in, d, 2, 1,
                idx.data_ptr(), val.data_ptr(), stream)
            torch.cuda.synchronize()
            assert (code == 0) == (kernel_route(torch.bfloat16, c_in, d)
                                   == "head_topk[bf16]"), (c_in, d, code)


@pytest.mark.cuda
def test_predict_topk_fused_on_cuda_matches_cpu(cuda_device):
    """The narrow fp32 model on the card (the head_topk kernel) against the
    same model on the CPU (the plain version): ids >= 99.9% equal."""
    from rangeclip_tpu_torch.models.depth_unet import predict_topk_fused

    model = DepthUNet(DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32),
                                      embedding_dim=32),
                      generator=torch.Generator().manual_seed(15)).eval()
    gen = torch.Generator().manual_seed(16)
    depth = torch.randn(2, 64, 64, 1, generator=gen)
    text = torch.randn(30, 32, generator=gen)
    mask = torch.rand(30, generator=gen) < 0.5
    want = predict_topk_fused(model, depth, text, mask)
    got, launches = _counted("head_topk[fp32]", lambda: predict_topk_fused(
        model.to(cuda_device), depth.to(cuda_device), text.to(cuda_device),
        mask.to(cuda_device)))
    assert launches == 1 and got.shape == (2, 64, 64, 5)
    assert float((got.cpu() == want).float().mean()) >= 0.999


@pytest.mark.cuda
def test_eval_ops_pass_opcheck(cuda_device):
    """The masked_pooling, head_topk and tv_loss operators' fake
    implementations, schemas and (tv_loss) autograd registration against
    their CUDA implementations."""
    from rangeclip_tpu_torch.ops.kernels.head_topk import head_topk_op
    from rangeclip_tpu_torch.ops.kernels.masked_pooling import (
        masked_pooling_op,
    )
    from rangeclip_tpu_torch.ops.kernels.tv_loss import tv_loss_op

    gen = torch.Generator().manual_seed(17)
    dev = lambda t: t.to(cuda_device)
    torch.library.opcheck(masked_pooling_op, (
        dev(torch.randn(300, 16, generator=gen)),
        dev(torch.randint(-1, 6, (300,), generator=gen, dtype=torch.int32)),
        dev(torch.tensor([0, 2, 2, 9], dtype=torch.int32))))
    for dtype in (torch.float32, torch.bfloat16):  # both routes
        torch.library.opcheck(head_topk_op, (
            dev(torch.randn(2, 5, 6, 8, generator=gen).to(dtype)),
            dev(torch.randn(72, 16, generator=gen).to(dtype)),
            dev(l2_normalize(torch.randn(20, 16, generator=gen),
                             dim=-1).to(dtype)),
            dev(torch.ones(20, dtype=torch.int32)), 3))
    x = dev(torch.randn(2, 4, 8, 16, generator=gen).bfloat16())
    torch.library.opcheck(tv_loss_op, (x.requires_grad_(), 16))
    # D = 20 as the wrapper hands it: padded to 24, the means over 20
    x = dev(torch.nn.functional.pad(torch.randn(2, 4, 8, 20, generator=gen),
                                    (0, 4)))
    torch.library.opcheck(tv_loss_op, (x.requires_grad_(), 20))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["text", "vision", "patches"])
def test_clip_towers_on_cuda_match_cpu(cuda_device, kind):
    """The CLIP towers (plain PyTorch: no kernel of this slice) on the card
    against the same weights on the CPU, fp32 with TF32 off: within 1e-4
    relative to the largest feature."""
    from rangeclip_tpu_torch.models.clip.model import (
        CLIPConfig,
        CLIPTextTower,
        CLIPVisionTower,
    )

    cfg = CLIPConfig(vocab_size=99, max_position_embeddings=16,
                     text_width=32, text_heads=4, text_layers=2,
                     image_size=64, patch_size=16, vision_width=48,
                     vision_heads=4, vision_layers=2, projection_dim=24)
    gen = torch.Generator().manual_seed(4)
    cls = CLIPTextTower if kind == "text" else CLIPVisionTower
    tower = cls(cfg, generator=gen).eval()
    if kind == "text":
        x = torch.randint(1, 99, (3, 16), generator=gen)
    else:
        x = torch.randn(2, 64, 64, 3, generator=gen)
    args = (True,) if kind == "patches" else ()
    with torch.no_grad():
        want = tower(x, *args)
        got = tower.to(cuda_device)(x.to(cuda_device), *args).cpu()
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mit", "resnet50"])
def test_mit_and_resnet50_on_cuda_match_cpu(cuda_device, kind):
    """The MiT and ResNet-50 UNets on the card against the CPU, fp32 with
    TF32 off: the field within 1e-4, predict's and the folded predict's
    labels on >= 99.9% of entries (near-ties aside)."""
    kw = (dict(unet_type="mit", encoder_filters=(0, 16, 32, 64, 96))
          if kind == "mit" else
          dict(n_layer=50, encoder_filters=(8, 8, 16, 16, 32)))
    gen = torch.Generator().manual_seed(5)
    model = DepthUNet(DepthUNetConfig(embedding_dim=32, **kw),
                      generator=gen).eval()
    depth = torch.randn(4, 64, 64, generator=gen)
    text = torch.randn(100, 32, generator=gen)
    with torch.no_grad():
        field = model(depth)[0]
        ids = model.predict(depth, text, None, 5, return_embeddings=False)[0]
        folded = predict_folded(model, depth, text, top_k=5)
        model.to(cuda_device)
        d, t = depth.to(cuda_device), text.to(cuda_device)
        got_field = model(d)[0].cpu()
        got_ids = model.predict(d, t, None, 5, return_embeddings=False)[0]
        got_folded = predict_folded(model, d, t, top_k=5)
    assert (got_field - field).abs().max() <= 1e-4
    assert (got_ids.cpu() == ids).float().mean() >= 0.999
    assert (got_folded.cpu() == folded).float().mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["full", "packed"])
def test_pixel_text_ce_more_than_four_slots(cuda_device, dtype, form):
    """16 label slots (a MiT field at H/4, upsampled x4): one pass of the
    member-only kernels in each direction, on the tensor-core route's
    packed shape too, held to the plain versions at 4 slots' tolerances
    (_hold_ce)."""
    _hold_many_slots(cuda_device, dtype, form, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [5, 9, 15])
@pytest.mark.parametrize("form", ["full", "packed"])
def test_pixel_text_ce_padded_slot_counts(cuda_device, slots, form):
    """5-15 slots run on the 16-slot kernels, padded with weightless slots:
    bf16 held to the plain version on the unpadded slots (_hold_ce)."""
    _hold_many_slots(cuda_device, torch.bfloat16, form, slots)


def _hold_many_slots(cuda_device, dtype, form, slots):
    gen = torch.Generator().manual_seed(23)
    capacity = None if form == "full" else 128
    samples, temperature, labels, valid, table, mask, packed = _ce_inputs(
        gen, dtype, 1111, 136, 300, slots, 60, capacity)
    dev = lambda t: t.to(cuda_device)
    packed_d = None if packed is None else tuple(map(dev, packed))
    xs = dev(samples).requires_grad_()
    ts = dev(temperature).requires_grad_()
    before = dict(_lib.launch_counts)
    loss = fused_pixel_text_ce(xs, ts, dev(labels), dev(valid), dev(table),
                               dev(mask), packed_d)
    loss.backward()
    torch.cuda.synchronize()
    for name in ("pixel_text_ce[fwd]", "pixel_text_ce[bwd]"):
        assert _lib.launch_counts[name] == before[name] + 1, name
    for name in ("pixel_text_ce_tc[fwd]", "pixel_text_ce_tc[bwd]"):
        assert _lib.launch_counts[name] == before[name], name
    args = tuple(map(dev, (samples, temperature, labels, valid, table,
                           mask)))
    _hold_ce(loss.detach(), xs.grad, ts.grad, args, packed_d, dtype,
             cuda_device)


@pytest.mark.cuda
def test_seg_former_runs_where_the_logits_are(cuda_device):
    """evaluate_seg_former with logits on the card runs there and gives
    the accuracy of the same logits on the host (at the labels'
    resolution, so the resize weighs nothing)."""
    import numpy as np

    from rangeclip_tpu_torch.evals.baselines import evaluate_seg_former

    rng = np.random.default_rng(3)
    seg = rng.integers(0, 8, (2, 16, 16)).astype(np.int32)
    logits = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    batches = [{"image": np.zeros((2, 16, 16, 3), np.float32),
                "segmentation": seg,
                "sample_valid": np.array([1.0, 0.0], np.float32)}]
    want = evaluate_seg_former(batches, lambda images: logits, 8,
                               num_negatives=3)
    got = evaluate_seg_former(
        batches, lambda images: torch.from_numpy(logits).to(cuda_device), 8,
        num_negatives=3)
    assert got == want
