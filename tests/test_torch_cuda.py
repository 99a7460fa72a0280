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
    normalize_rows_rsqrt,
    pixel_text_topk,
)
from rangeclip_tpu_torch.ops.kernels.score_topk import score_topk
from rangeclip_tpu_torch.ops.kernels.tv_rowtile import (
    tv_rowtile,
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,S,k", [((2, 8, 200, 32), 256, 5),
                                       ((1, 1, 5, 8), 128, 1),
                                       ((3, 4, 130, 64), 128, 8)])
def test_conv_score_topk_matches_plain(cuda_device, shape, S, k):
    """Quantised-exact inputs (multiples of 1/4): bit-equal.  Covers ragged
    strips (w not a multiple of the block width), one-row images, dead
    slots and C_in 8..64."""
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


def _sparse_signs(gen, rows, dim, nonzero):
    """Rows of +-1 in ``nonzero`` places: power-of-two norms, exact sums."""
    x = torch.zeros(rows, dim)
    at = torch.rand(rows, dim, generator=gen).argsort(dim=1)[:, :nonzero]
    signs = torch.randint(0, 2, (rows, nonzero), generator=gen) * 2 - 1
    return x.scatter_(1, at, signs.float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,c", [(5000, 512, 512), (77, 32, 1000),
                                   (300, 1024, 40), (129, 40, 130)])
def test_pixel_text_topk_matches_plain(cuda_device, dtype, n, d, c):
    """Quantised-exact inputs: ids and values bit-equal to the plain version
    for the mask form, sparse global ids, and an exhausted set; ragged row
    and class counts (past one 128-row block and one 128-class tile), D of
    1024 and D = 40 (a last dim chunk of 8)."""
    gen = torch.Generator().manual_seed(4)
    field = (_sparse_signs(gen, n, d, 16)
             * 2.0 ** torch.randint(-3, 4, (n, 1), generator=gen)).to(dtype)
    table = (_sparse_signs(gen, c, d, 4) / 2).to(dtype)
    mask = torch.rand(c, generator=gen) > 0.3
    ids = torch.full((c,), -1, dtype=torch.int32)
    ids[:c // 2] = torch.randperm(5000, generator=gen)[:c // 2].sort().values
    two = torch.zeros(c, dtype=torch.bool)
    two[[1, 3]] = True
    for kw in ({"candidate_mask": mask}, {"candidate_mask": ids >= 0,
                                          "candidate_ids": ids},
               {"candidate_mask": two}):
        for k in (1, 5, 8):
            want = pixel_text_topk(field, table, top_k=k, **kw)
            before = _lib.launch_counts["pixel_text_topk"]
            got = pixel_text_topk(field.to(cuda_device),
                                  table.to(cuda_device), top_k=k,
                                  **{a: t.to(cuda_device)
                                     for a, t in kw.items()})
            torch.cuda.synchronize()
            assert _lib.launch_counts["pixel_text_topk"] == before + 1
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
    before = _lib.launch_counts["pixel_text_topk"]
    got = model.to(cuda_device).predict(depth.to(cuda_device),
                                        text.to(cuda_device),
                                        mask.to(cuda_device), 5)[0]
    torch.cuda.synchronize()
    assert _lib.launch_counts["pixel_text_topk"] == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("form", ["full", "packed", "overflow"])
def test_pixel_text_ce_matches_plain(cuda_device, dtype, slots, form):
    """Forward (the summed CE), d samples and d temperature against the
    plain versions on the card.  Values and d temperature within rtol 2e-5
    (f32 sums in another order, and an online max over class tiles); d
    samples f32 within 1e-4 of the row's largest entry, bf16 within one
    bf16 ulp plus 2^-10 of the row's largest entry (an order change in f32
    can flip a bf16 rounding, and d samples subtracts its projection)."""
    gen = torch.Generator().manual_seed(9)
    n, d, c = 1111, 136, 300
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
    for name in ("pixel_text_ce[fwd]", "pixel_text_ce[bwd]"):
        assert _lib.launch_counts[name] == before[name] + 1
    args = (dev(samples), dev(temperature), dev(labels), dev(valid),
            dev(table), dev(mask))
    want = pixel_text_ce_plain(*args, packed=packed_d)
    dx, dt = pixel_text_ce_backward_plain(torch.tensor(1.0, device=cuda_device),
                                          *args, packed=packed_d)
    torch.testing.assert_close(loss.detach(), want, rtol=2e-5, atol=1e-4)
    torch.testing.assert_close(ts.grad, dt, rtol=2e-5, atol=1e-4)
    scale = dx.double().abs().amax(dim=-1, keepdim=True)
    err = (xs.grad.double() - dx.double()).abs()
    if dtype == torch.bfloat16:
        assert _within_bf16(xs.grad, dx, scale * 2.0 ** -10)
    else:
        assert bool((err <= 1e-4 * scale + 1e-9).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,weights,upsample", [
    ((3, 10, 16, 128), (1.0, 0.0, 1.0), 2),
    ((2, 128, 128, 512), None, 2),
    ((1, 2, 8, 8), (1.0,), 1)])
def test_tv_rowtile_matches_plain(cuda_device, shape, weights, upsample):
    """bf16 with ties (quantised values), several row tiles and a ragged
    last one, a zero sample weight: the backward bit-equal to the plain VJP,
    the forward within rtol 1e-5 (f32 summation order)."""
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
def test_training_ops_pass_opcheck(cuda_device):
    """The training operators' fake implementations, schemas and autograd
    registrations against their CUDA implementations."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("P,D,dtype", [(70_000, 512, torch.bfloat16),
                                       (5000, 40, torch.float32),
                                       (17, 8, torch.float32)])
def test_masked_pooling_matches_plain(cuda_device, P, D, dtype):
    """Counts exact, sums within rtol 1e-5 of the dense match product (f32
    sums in another order), the same bits on a second run (no atomics);
    duplicate, absent and -1 labels as the plain version has them."""
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
    assert launches == 1
    want_sums, want_counts = masked_pooling_plain(emb, seg, obj)
    assert torch.equal(counts, want_counts)
    torch.testing.assert_close(sums, want_sums, rtol=1e-5, atol=1e-5)
    assert torch.equal(sums, fused_masked_pooling(emb, seg, obj)[0])
    assert (sums[4] == 0).all() and (sums[6] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((3, 9, 16, 8), torch.float32),
                                         ((2, 17, 33, 24), torch.bfloat16),
                                         ((2, 64, 64, 512), torch.bfloat16),
                                         ((1, 2, 5, 8), torch.float32)])
def test_tv_loss_matches_plain(cuda_device, shape, dtype):
    """Quantised values with exact ties (sign(0) = 0): the backward
    bit-equal to the plain VJP, the forward within rtol 1e-5 (f32
    summation order)."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,dtype,C", [(2, 16, torch.float32, 512),
                                         (3, 7, torch.float32, 130),
                                         (2, 12, torch.bfloat16, 40)])
def test_head_topk_matches_plain(cuda_device, B, h, dtype, C):
    """Ids against the plain version: every mismatch a near-tie (the
    winning values within 1e-5 in f32, and within 1e-3, two bf16 ulps of the
    top scores, in bf16, where an embedding component's rounding may flip
    with the conv's summation order); an exhausted mask of 3 live classes
    gives id 0 at -1e30 past them."""
    from rangeclip_tpu_torch.ops.kernels.head_topk import (
        fused_head_score_topk,
        head_topk_plain,
    )

    gen = torch.Generator().manual_seed(14)
    C_in, D, k = 32, 512, 5
    feats = torch.randn(B, h, h, C_in, generator=gen).to(dtype)
    rows = torch.randn(9 * C_in, D, generator=gen) / 17
    text = l2_normalize(torch.randn(C, D, generator=gen), dim=-1)
    mask = torch.rand(C, generator=gen) < 0.7
    dev = lambda t: t.to(cuda_device)
    for m in (mask, torch.isin(torch.arange(C), torch.tensor([4, 9, 33]))):
        (idx, val), launches = _counted("head_topk", lambda: (
            fused_head_score_topk(dev(feats), dev(rows), dev(text), dev(m),
                                  k)))
        assert launches == 1
        want_idx, want_val = head_topk_plain(
            dev(feats), dev(rows).to(dtype), dev(text).to(dtype),
            dev(m).int(), k)
        tol = 1e-5 if dtype == torch.float32 else 1e-3
        torch.testing.assert_close(val, want_val, rtol=0, atol=tol)
        agree = float((idx == want_idx).float().mean())
        assert agree >= (0.999 if dtype == torch.float32 else 0.99), agree
    assert bool((idx[:, 3:] == 0).all() and (val[:, 3:] == -1e30).all())


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
    got, launches = _counted("head_topk", lambda: predict_topk_fused(
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
    torch.library.opcheck(head_topk_op, (
        dev(torch.randn(2, 5, 6, 8, generator=gen)),
        dev(torch.randn(72, 16, generator=gen)),
        dev(l2_normalize(torch.randn(20, 16, generator=gen), dim=-1)),
        dev(torch.ones(20, dtype=torch.int32)), 3))
    x = dev(torch.randn(2, 4, 8, 16, generator=gen).bfloat16())
    torch.library.opcheck(tv_loss_op, (x.requires_grad_(),))
