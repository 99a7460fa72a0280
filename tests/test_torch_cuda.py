"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX (the machine with the card has none).  Every test here needs
a CUDA device and skips without one.  On the card, where tests/conftest.py
cannot load (it imports JAX), run them with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

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
from rangeclip_tpu_torch.ops.kernels.score_topk import score_topk


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
