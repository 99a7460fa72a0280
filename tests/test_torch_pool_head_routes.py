"""The host-side pieces of the one-pass masked_pooling kernels and of
head_topk's CUDA-core route, on the CPU: the plain versions against the
JAX package's Pallas kernels in interpret mode on the inputs the kernels'
designs turn on (spatially coherent labels; a partial mask with k = 5 and
exhausted candidate sets), the CUDA-core route's arithmetic (the live
columns gathered by ``live_table``, the scale from an f64 sum of squares
moved past the sum, picks past the live classes (0, -1e30)) written out in
plain PyTorch against the TPU kernel, and the wrappers' sizing helpers.
Inputs are made from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.ops.pallas.head_topk import (
    fused_head_score_topk as jax_head_topk,
)
from rangeclip_tpu.ops.pallas.masked_pooling import (
    fused_masked_pooling as jax_masked_pooling,
)
from rangeclip_tpu_torch.ops.kernels import head_topk as head_k
from rangeclip_tpu_torch.ops.kernels import masked_pooling as pool_k
from rangeclip_tpu_torch.ops.kernels.live_rows import live_table

t = torch.from_numpy


def _regions(rng, B, H, W, per_image):
    """[B * H * W] labels: each image split into ``per_image`` Voronoi
    regions, image b's regions numbered b * per_image + 0 .. per_image - 1
    (every id present)."""
    yy, xx = np.mgrid[0:H, 0:W]
    coords = np.stack([yy, xx], -1).reshape(-1, 2)
    out = []
    for b in range(B):
        pts = rng.uniform(0, 1, (per_image, 2)) * np.array([H, W])
        d2 = ((coords[:, None, :] - pts[None]) ** 2).sum(-1)
        out.append(b * per_image + d2.argmin(1))
    return np.concatenate(out).astype(np.int32)


@pytest.mark.parametrize("case", ["regions", "one_id", "all_padding",
                                  "duplicates"])
def test_masked_pooling_plain_matches_jax_on_regions(case):
    """Spatially coherent labels (each image in Voronoi regions, all 16 ids
    present): sums within rtol 1e-5 of the TPU kernel in interpret mode
    (f32, another summation order), counts exact; one id alone; every
    label -1 (zero sums, count 0); a list of ids with duplicates and an
    absent one (each duplicate the full sums)."""
    rng = np.random.default_rng(31)
    B, H, W, D = 4, 16, 24, 24
    emb = rng.standard_normal((B * H * W, D)).astype(np.float32)
    seg = _regions(rng, B, H, W, 4)
    objs = np.arange(16, dtype=np.int32)
    if case == "one_id":
        objs = np.array([5], np.int32)
    elif case == "all_padding":
        seg[:] = -1
    elif case == "duplicates":
        objs = np.array([3, 7, 3, 15, 40, 7, 3], np.int32)
    sums, counts = jax_masked_pooling(jnp.asarray(emb), jnp.asarray(seg),
                                      jnp.asarray(objs), tile_p=128,
                                      interpret=True)
    got_sums, got_counts = pool_k.fused_masked_pooling(t(emb), t(seg),
                                                       t(objs))
    np.testing.assert_allclose(got_sums.numpy(), np.asarray(sums), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(counts))
    if case == "all_padding":
        assert (got_counts == 0).all() and (got_sums == 0).all()
    else:
        assert (got_counts[objs < 16] > 0).all()
    for a in range(len(objs)):  # a duplicate id carries the full sums
        for b in range(a):
            if objs[a] == objs[b]:
                assert torch.equal(got_sums[a], got_sums[b])


@pytest.mark.parametrize("n_ids,want", [
    (0, [(0, 0)]), (1, [(0, 1)]), (256, [(0, 256)]), (1024, [(0, 1024)]),
    (1025, [(0, 1024), (1024, 1025)]),
    (3000, [(0, 1024), (1024, 2048), (2048, 3000)])])
def test_masked_pooling_id_groups(n_ids, want):
    """Ids run in groups of at most MAX_IDS (the kernel's id hash), in
    order, covering every id once; the plain version's per-group sums and
    counts, concatenated, are the whole call's."""
    assert pool_k.id_groups(n_ids) == want
    assert pool_k.MAX_IDS == 1024
    if n_ids == 0:
        return
    rng = np.random.default_rng(n_ids)
    emb = t(rng.standard_normal((500, 8)).astype(np.float32))
    seg = t(rng.integers(-1, 2000, 500).astype(np.int32))
    objs = t(rng.integers(0, 2000, n_ids).astype(np.int32))
    parts = [pool_k.masked_pooling_plain(emb, seg, objs[a:b])
             for a, b in pool_k.id_groups(n_ids)]
    sums, counts = pool_k.masked_pooling_plain(emb, seg, objs)
    assert torch.equal(torch.cat([c for _, c in parts]), counts)
    torch.testing.assert_close(torch.cat([s for s, _ in parts]), sums)


@pytest.mark.parametrize("n_pix,n_ids,dims", [
    (524_288, 256, 512), (1, 1, 8), (8192, 7, 40), (8193, 7, 2048),
    (70_000, 1024, 512)])
def test_masked_pooling_workspace_shapes(n_pix, n_ids, dims):
    """The chunks are ceil(P / 8192); the keys cover whole chunks; the
    partial sums [G, N, D] f32 bound the workspace traffic.  At the
    flagship field (P = 524,288, N = 256, D = 512) that worst case, every
    id present in every chunk, is 64 x 256 x 512 x 4 = 33.5 MB each way,
    6.25% of the bf16 field's bytes; the sum launch's blocks, one per
    chunk and 128-dim slice, are 256 there (64 x 4): about two an SM."""
    shapes = pool_k.workspace_shapes(n_pix, n_ids, dims)
    chunks = -(-n_pix // pool_k.CHUNK)
    assert pool_k.CHUNK == 8192
    assert shapes == {"keys": (chunks * 8192,), "pcount": (chunks, n_ids),
                      "totals": (chunks,), "first": (n_ids,),
                      "part": (chunks, n_ids, dims)}
    if (n_pix, n_ids, dims) == (524_288, 256, 512):
        part_bytes = 4 * np.prod(shapes["part"])
        assert part_bytes == 33_554_432
        assert part_bytes / (2 * n_pix * dims) == 0.0625
        assert chunks * -(-dims // 128) == 256


@pytest.mark.parametrize("dims,n_pix,want", [
    (512, 131_072, 131_072),      # the serve shape: one slab
    (512, 2_097_152, 131_072),    # the bench shape in f32: 16 slabs
    (1288, 100_000, 52_096),      # 2^26 // 1288 = 52,103 -> whole tiles
    (768, 9_800, 9_800),
    (8, 5, 5),
    (1 << 20, 1000, 128)])        # at least one 128-pixel tile
def test_head_topk_field_slab_rows(dims, n_pix, want):
    """The CUDA-core route's f32 field workspace: every pixel while [n,
    D] f32 fits 2^26 values (256 MB), else the most whole 128-pixel block
    tiles that fit, at least one."""
    assert head_k.FIELD_SLAB_VALUES == 1 << 26
    got = head_k.field_slab_rows(dims, n_pix)
    assert got == want
    assert got * dims <= max(head_k.FIELD_SLAB_VALUES, 128 * dims)


def _cuda_core_route(feats, rows, text, mask, k):
    """head_topk's CUDA-core route for f32 features, its arithmetic
    written out: the f32 conv field; the live table columns gathered
    first (``live_table``, the plain version of the gather its C entry
    point launches) with their ids and count; rs = 1 / sqrt(max(s, 1e-24))
    of the f64 sum of squares, rounded once, applied past the sum (rs *
    sum(f * t)); the top-k over the live columns only, ties to the smaller
    column (the smaller id); picks past them (0, -1e30)."""
    f = head_k.head_field(feats, rows)
    table_t, ids, count = live_table(text, torch.arange(text.shape[0]),
                                     mask != 0)
    n_live = int(count)
    sq = f.double().square().sum(dim=1, keepdim=True)
    rs = (1.0 / torch.sqrt(sq.clamp_min(1e-24))).float()
    scores = (f @ table_t[:, :n_live]) * rs
    col, val = head_k.knockout_topk(scores, min(k, n_live)) if n_live else (
        torch.zeros(f.shape[0], 0, dtype=torch.int32), torch.zeros(
            f.shape[0], 0))
    idx = torch.zeros(f.shape[0], k, dtype=torch.int32)
    vals = torch.full((f.shape[0], k), -1e30)
    idx[:, :col.shape[1]] = ids[col.long()].to(torch.int32)
    vals[:, :col.shape[1]] = val
    return idx, vals


@pytest.mark.parametrize("live,k", [("part", 5), ("part", 8), (3, 5),
                                    (0, 5), ("all", 1)])
def test_head_topk_cuda_core_route_matches_jax(live, k):
    """f32 features, C_in = 16, D = 24, C = 40: the CUDA-core route's
    arithmetic (f64 norms, the scale past the sum, the live columns only)
    and the plain version both give the TPU kernel's ids in interpret mode
    and its values within 1e-5, under a partial mask (17 of 40), 3 live
    classes, none and all; with fewer live classes than k the picks past
    them are (0, -1e30)."""
    rng = np.random.default_rng(41)
    B, h, C_in, D, C = 2, 7, 16, 24, 40
    feats = rng.standard_normal((B, h, h, C_in)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, C_in, D)) / 9).astype(np.float32)
    text = rng.standard_normal((C, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    mask = np.zeros(C, bool)
    if live == "part":
        mask[rng.choice(C, 17, replace=False)] = True
    elif live == "all":
        mask[:] = True
    else:
        mask[[4, 19, 33][:live]] = True
    want_idx, want_val = jax_head_topk(
        jnp.asarray(feats), jnp.asarray(kernel), jnp.asarray(text),
        jnp.asarray(mask), top_k=k, interpret=True)
    rows = t(kernel.reshape(9 * C_in, D))
    m = t(mask).int()
    for idx, val in (_cuda_core_route(t(feats), rows, t(text), m, k),
                     head_k.head_topk_plain(t(feats), rows, t(text), m, k)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_allclose(val.numpy(), np.asarray(want_val),
                                   rtol=1e-5, atol=1e-5)
        n_live = int(mask.sum())
        if n_live < k:
            assert (idx[:, n_live:] == 0).all()
            assert (val[:, n_live:] == -1e30).all()
