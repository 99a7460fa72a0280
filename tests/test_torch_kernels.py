"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode, as the JAX package's own tests do.
Inputs are made with numpy from a seed and fed to both.  The CUDA kernels
are held against the plain versions in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangeclip_tpu.ops.pallas.class_presence import fused_class_presence
from rangeclip_tpu.ops.pallas.conv_score_topk import (
    fused_conv_score_topk,
    fused_conv_topk_applicable as jax_applicable,
)
from rangeclip_tpu.ops.pallas.score_topk import fused_score_topk
from rangeclip_tpu_torch.ops.kernels.class_presence import class_presence
from rangeclip_tpu_torch.ops.kernels.conv_score_topk import (
    conv_kernel_fits,
    conv_score_topk,
    fold_to_rows,
    fused_conv_topk_applicable,
)
from rangeclip_tpu_torch.ops.kernels.score_topk import (
    score_topk,
    score_topk_plain,
)


def _bf16_both(x: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _selector_cases():
    """(scores, ids, max_id) cases of the JAX test's shape N=64, S=384:
    quantised bf16 ties and dead slots, then an exhausted candidate set."""
    rng = np.random.default_rng(23)
    N, S = 64, 384
    sc = np.round(rng.standard_normal((N, S)) * 4) / 4
    ids = np.full(S, -1, np.int32)
    ids[:300] = np.sort(rng.choice(2000, 300, replace=False))
    yield sc, ids, 1999
    ids2 = np.full(S, -1, np.int32)
    ids2[:3] = [4, 7, 9]
    row = np.full(S, 0.5)
    row[:3] = [2.0, 2.0, 1.0]
    yield np.tile(row, (N, 1)), ids2, 9


@pytest.mark.parametrize("selector,dtype", [("packed", "bfloat16"),
                                            ("knockout", "bfloat16"),
                                            ("knockout", "float32")])
def test_score_topk_plain_bit_equal_to_pallas(selector, dtype):
    """Ids and values bit-equal to ``fused_score_topk(interpret=True)`` for
    both selectors (packed takes bf16 only)."""
    K = 5
    for sc, ids, max_id in _selector_cases():
        if dtype == "bfloat16":
            s_jax, s_t = _bf16_both(sc)
        else:
            s_jax = jnp.asarray(sc, jnp.float32)
            s_t = torch.from_numpy(sc.astype(np.float32))
        want_idx, want_val = fused_score_topk(
            s_jax, jnp.asarray(ids), top_k=K, want_values=True,
            interpret=True, selector=selector, max_id=max_id)
        got_idx, got_val = score_topk(
            s_t, torch.from_numpy(ids), top_k=K, want_values=True,
            selector=selector, max_id=max_id)
        assert got_idx.dtype == torch.int32
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(got_val.numpy(), np.asarray(want_val))
    # the exhausted set: -1 ids and -1e30 values past the 3 valid slots
    assert (got_idx[:, 3:] == -1).all() and (got_val[:, 3:] == -1e30).all()
    assert got_idx[0, :3].tolist() == [4, 7, 9]


def test_score_topk_auto_selector_and_contract():
    """'auto' picks packed exactly when the JAX wrapper does; malformed
    calls raise instead of running."""
    sc = torch.randn(8, 128).to(torch.bfloat16)
    ids = torch.arange(128, dtype=torch.int32)
    packed = score_topk_plain(sc, ids, 3, packed=True)
    knock = score_topk_plain(sc, ids, 3, packed=False)
    auto = score_topk(sc, top_k=3, want_values=True)
    np.testing.assert_array_equal(auto[0].numpy(), packed[0].numpy())
    np.testing.assert_array_equal(auto[0].numpy(), knock[0].numpy())
    with pytest.raises(ValueError, match="packed selector"):
        score_topk(sc.float(), top_k=3, selector="packed")
    with pytest.raises(ValueError, match="packed selector"):
        score_topk(sc, ids, top_k=3, selector="packed")  # no max_id
    with pytest.raises(ValueError, match="top_k"):
        score_topk(sc, top_k=9)
    with pytest.raises(ValueError, match="top_k"):  # more picks than slots
        score_topk(sc[:, :2].contiguous(), top_k=3)
    with pytest.raises(ValueError, match="int32"):
        score_topk(sc, ids.long(), top_k=3)


def test_class_presence_plain_bit_equal_to_pallas():
    rng = np.random.default_rng(5)
    N, C = 5000, 300
    labels = rng.integers(-20, C + 20, N).astype(np.int32)  # out of range too
    valid = (rng.random(N) > 0.3).astype(np.float32)
    labels[labels == 17] = 18
    labels[:50] = 17  # class 17 appears only where valid is zero
    valid[:50] = 0.0
    want = np.asarray(fused_class_presence(
        jnp.asarray(labels), jnp.asarray(valid), C, tile_n=512,
        interpret=True))
    got = class_presence(torch.from_numpy(labels), torch.from_numpy(valid), C)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[17] and want.sum() > 100


def _conv_case(quantised: bool):
    """JAX and torch inputs of the JAX test's shape: B=8, h=4, w=16,
    C_in=8, S=128, 7 dead slots."""
    rng = np.random.default_rng(0)
    B, h, w, Cin, S = 8, 4, 16, 8, 128
    if quantised:
        # multiples of 1/4 in [-2, 2]: every f32 partial sum is exact, so
        # any summation order gives the same bf16 score
        feats = rng.integers(-8, 9, (B, h, w, Cin)) / 4
        fold = rng.integers(-8, 9, (3, 3, Cin, S)) / 4
    else:
        feats = rng.standard_normal((B, h, w, Cin))
        fold = rng.standard_normal((3, 3, Cin, S))
    f_jax, f_t = _bf16_both(feats)
    w_jax, w_t = _bf16_both(fold)
    ids = np.arange(S, dtype=np.int32)
    ids[-7:] = -1
    rows = fold_to_rows(w_t.permute(3, 2, 0, 1))  # HWIO -> [S, C, 3, 3]
    return (f_jax, w_jax, jnp.asarray(ids)), (f_t, rows, torch.from_numpy(ids))


@pytest.mark.parametrize("quantised", [True, False])
def test_conv_score_topk_plain_matches_pallas(quantised):
    """Bit-equal ids and values on quantised-exact inputs; on normal inputs
    >= 99% id agreement, every mismatch a tie within one bf16 ulp."""
    K = 5
    (f_jax, w_jax, ids_jax), (f_t, rows, ids_t) = _conv_case(quantised)
    B, h, w, _ = f_t.shape
    idx_j, val_j = fused_conv_score_topk(
        f_jax, w_jax, ids_jax, top_k=K, want_values=True, interpret=True,
        slice_cols=4)
    # JAX's [k, N] in (h, w, B) order -> [B, h, w, k]
    idx_j = np.asarray(idx_j).T.reshape(h, w, B, K).transpose(2, 0, 1, 3)
    val_j = np.asarray(val_j).T.reshape(h, w, B, K).transpose(2, 0, 1, 3)
    idx_t, val_t = conv_score_topk(f_t, rows, ids_t, top_k=K,
                                   want_values=True)
    idx_t = idx_t.numpy().reshape(B, h, w, K)
    val_t = val_t.numpy().reshape(B, h, w, K)
    if quantised:
        np.testing.assert_array_equal(idx_t, idx_j)
        np.testing.assert_array_equal(val_t, val_j)
        return
    agree = idx_t == idx_j
    assert agree.mean() >= 0.99
    ulp = 2.0 ** (np.floor(np.log2(np.abs(val_j[~agree]))) - 7)
    assert (np.abs(val_t[~agree] - val_j[~agree]) <= ulp).all()


def test_fused_conv_gate_matches_jax():
    for shape, S, bound in [((128, 128, 128, 32), 384, 383),
                            ((8, 128, 128, 32), 384, 383),
                            ((128, 128, 128, 32), 384, None),
                            ((128, 128, 128, 32), 384, 2 ** 16),
                            ((128, 64, 63, 32), 384, 10),
                            ((256, 4, 4, 12), 128, 10),
                            ((128, 16, 16, 136), 128, 99),
                            ((128, 16, 16, 144), 128, 99),
                            ((128, 16, 16, 512), 384, 99)]:
        assert fused_conv_topk_applicable(shape, S, bound) == jax_applicable(
            shape, S, bound)


def test_conv_kernel_fits_up_to_136_channels():
    """The fused kernel's block (64 im2col rows beside the TMA ring) fits
    in 227 KB of shared memory up to C_in = 136; wider features take the
    conv + score_topk path on the card, while the CPU keeps the JAX gate
    (test_fused_conv_gate_matches_jax)."""
    assert [c for c in range(8, 521, 8) if conv_kernel_fits(c)] == list(
        range(8, 137, 8))


def test_wrappers_refuse_malformed_input():
    f = torch.zeros(2, 4, 4, 8, dtype=torch.bfloat16)
    rows = torch.zeros(128, 72, dtype=torch.bfloat16)
    ids = torch.arange(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="bf16"):
        conv_score_topk(f.float(), rows, ids)
    with pytest.raises(ValueError, match="S % 128"):
        conv_score_topk(f, rows[:100], ids[:100])
    with pytest.raises(ValueError, match="contiguous"):
        conv_score_topk(f.transpose(1, 2), rows, ids)
    with pytest.raises(ValueError, match="int32"):
        class_presence(ids.long(), torch.ones(128), 4)
