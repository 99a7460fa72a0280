"""The training slice's plain kernel versions against the JAX Pallas kernels
run with ``interpret=True`` on the CPU: ``histogram``, ``pixel_text_ce``
(value, d samples, d temperature) and ``tv_rowtile`` (value and VJP).  The
CUDA kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Inputs come from numpy
seeds; each tolerance is stated where it is checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from rangeclip_tpu.losses.smoothness import _tv as jax_tv
from rangeclip_tpu.ops.pallas.histogram import fused_histogram
from rangeclip_tpu.ops.pallas.pixel_text_ce import (
    fused_pixel_text_ce as jax_ce,
)
from rangeclip_tpu.ops.pallas.tv_rowtile import (
    kernel_applicable as jax_tv_applicable,
    tv_rowtile as jax_tv_rowtile,
)
from rangeclip_tpu.utils.math import l2_normalize as jax_l2
from rangeclip_tpu_torch.ops.kernels import histogram as hist_k
from rangeclip_tpu_torch.ops.kernels import pixel_text_ce as ce_k
from rangeclip_tpu_torch.ops.kernels import tv_rowtile as tv_k

t = torch.from_numpy


def test_histogram_plain_bit_equal_to_pallas():
    """-1 padding and slot-remapped draws (the s=2 native layout)."""
    rng = np.random.default_rng(0)
    B, H, W = 3, 16, 24
    draws = rng.integers(0, H * W, (B, 700))
    y, x = draws // W, draws % W
    h, w = H // 2, W // 2
    slotted = ((y % 2) * 2 + (x % 2)) * (h * w) + (y // 2) * w + (x // 2)
    for idx in (draws, slotted):
        idx = idx.astype(np.int32)
        idx[:, ::11] = -1
        want = np.asarray(fused_histogram(jnp.asarray(idx), H * W,
                                          interpret=True))
        got = hist_k.histogram(t(idx), H * W)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def _ce_case(rng, dtype, shape, C, slots, packed, n_members=40,
             nonmember=False):
    """Inputs of both sides: samples (numpy f32, cast per side), labels and
    valid [S, N] (valid labels are members of the mask, or with
    ``nonmember`` every fifth one a class in [0, C) outside it), the
    normalised table, the mask and, packed, the class ids with sentinel
    C."""
    N = int(np.prod(shape[:-1]))
    D = shape[-1]
    samples = rng.standard_normal(shape).astype(np.float32)
    members = np.sort(rng.choice(C, n_members, replace=False))
    mask = np.zeros(C, bool)
    mask[members] = True
    labels = members[rng.integers(0, n_members, (slots, N))].astype(np.int32)
    valid = rng.integers(0, 3, (slots, N)).astype(np.float32)
    if nonmember:
        outside = np.flatnonzero(~mask)
        labels[:, ::5] = outside[rng.integers(0, outside.size,
                                              labels[:, ::5].shape)]
    text = np.array(jax_l2(jnp.asarray(
        rng.standard_normal((C, D)).astype(np.float32)), axis=-1))
    ids = None
    if packed:
        ids = np.full(128, C, np.int32)
        ids[:min(n_members, 128)] = members[:128]
    return samples, labels, valid, text, mask, ids


@pytest.mark.parametrize("dtype,shape,slots,packed,n_members,nonmember", [
    ("f32", (300, 32), 1, False, 40, False),
    ("f32", (2, 16, 16, 128), 4, False, 40, False),
    ("bf16", (2, 16, 16, 128), 4, True, 40, False),
    ("bf16", (300, 32), 1, True, 40, False),
    ("bf16", (2, 16, 16, 128), 1, False, 40, False),
    ("f32", (300, 32), 4, False, 40, True),
    ("bf16", (2, 16, 16, 128), 1, False, 40, True),
    ("bf16", (300, 32), 4, True, 40, True),
    ("f32", (300, 32), 1, False, 1, True),
    ("f32", (2, 8, 8, 128), 4, False, 1, True),
    ("bf16", (2, 8, 8, 128), 16, True, 40, True),
    ("bf16", (300, 32), 11, False, 40, True),
])
def test_pixel_text_ce_plain_matches_pallas(dtype, shape, slots, packed,
                                            n_members, nonmember):
    """Value, d samples and d temperature of the port's CPU route (the plain
    forward and the written-out backward) against ``fused_pixel_text_ce``
    in interpret mode.  Both normalise rows with rsqrt(max(sum x^2,
    1e-24)), the port summing in f64: f32 values within rtol 1e-5,
    gradients within rtol 1e-4 (atol 1e-6 of the largest entry); bf16
    rows whose scale rounds differently round their bf16 operand
    differently, so bf16 values within rtol 1e-3, d samples within 2 bf16
    ulps of the largest entry of the row, d temperature rtol 1e-3.  The
    semantics a member-only kernel must keep: a valid label of a class in
    [0, C) outside the contrast set picks that class's -1e30 over the full
    table (the row's CE near 1e30) and nothing from a packed one, and a
    contrast set of one member leaves C - 1 terms of exp(-1e30 - m) in the
    sum-exp.  bf16 at 16 and 11 slots is the route of the tensor-core pair
    past 4 slots on the card (11 padded to 16).  With one member, a row
    whose every slot is that member has a CE and a gradient of exactly 0
    here and f32 rounding noise in the JAX kernel, so those cases also
    hold non-member labels (a nonzero value) and are f32 (the gradient
    held to the array's largest entry)."""
    rng = np.random.default_rng(1)
    C = 200
    samples, labels, valid, text, mask, ids = _ce_case(
        rng, dtype, shape, C, slots, packed, n_members, nonmember)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    temp = np.float32(0.07)
    lab = labels if slots > 1 else labels[0]
    val = valid if slots > 1 else valid[0]
    if packed:
        table = text[np.minimum(ids, C - 1)]
        jmask = ids < C
    else:
        table, jmask = text, mask

    def jax_fn(s, tau):
        return jax_ce(s, tau, jnp.asarray(lab), jnp.asarray(val),
                      jnp.asarray(table), jnp.asarray(jmask), 512, True,
                      None if ids is None else jnp.asarray(ids))

    js = jnp.asarray(samples).astype(jdt)
    want, (gs, gt) = jax.value_and_grad(jax_fn, argnums=(0, 1))(js, temp)

    xs = t(samples).to(tdt).requires_grad_()
    ts = torch.tensor(temp).requires_grad_()
    ttab = t(text).to(tdt)
    packed_args = None
    if packed:
        packed_args = (t(table).to(tdt), t(ids < C), t(ids),
                       torch.tensor(True))
    got = ce_k.fused_pixel_text_ce(xs, ts, t(lab), t(val), ttab, t(mask),
                                   packed_args)
    got.backward()
    assert xs.grad.dtype == tdt and xs.grad.shape == xs.shape
    gs = np.asarray(gs.astype(jnp.float32))
    dx = xs.grad.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        np.testing.assert_allclose(dx, gs, rtol=1e-4,
                                   atol=1e-6 * np.abs(gs).max())
        np.testing.assert_allclose(float(ts.grad), float(gt), rtol=1e-4)
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-3)
        np.testing.assert_allclose(float(ts.grad), float(gt), rtol=1e-3)
        rows = dx.reshape(-1, shape[-1])
        ref = gs.reshape(-1, shape[-1])
        scale = np.abs(ref).max(axis=1, keepdims=True)
        assert (np.abs(rows - ref) <= 2 * scale * 2.0 ** -8).all()


def test_pixel_text_ce_packed_overflow_reads_the_flag():
    """A false flag scores the full table (the lax.cond's other branch):
    equal to the unpacked call; a true flag with every member packed
    equals it too, up to f32 summation order (rtol 1e-6)."""
    rng = np.random.default_rng(2)
    samples, labels, valid, text, mask, ids = _ce_case(
        rng, "bf16", (256, 32), 300, 4, True)
    args = (t(samples).bfloat16(), torch.tensor(0.07), t(labels), t(valid),
            t(text).bfloat16(), t(mask))
    full = ce_k.fused_pixel_text_ce(*args)
    ptable = t(text[np.minimum(ids, 299)]).bfloat16()
    for flag in (False, True):
        packed = (ptable, t(ids < 300), t(ids), torch.tensor(flag))
        got = ce_k.fused_pixel_text_ce(*args, packed)
        np.testing.assert_allclose(float(got), float(full), rtol=1e-6)


TC_FWD, TC_BWD = "pixel_text_ce_tc[fwd]", "pixel_text_ce_tc[bwd]"
MEM_FWD, MEM_BWD = "pixel_text_ce[fwd]", "pixel_text_ce[bwd]"
SLOTS_FWD, SLOTS_BWD = ("pixel_text_ce_slots[fwd]",
                        "pixel_text_ce_slots[bwd]")


@pytest.mark.parametrize("dtype,D,K,flag,fwd,bwd", [
    (torch.bfloat16, 512, 128, True, TC_FWD, TC_BWD),
    (torch.bfloat16, 512, 128, False, MEM_FWD, MEM_BWD),
    (torch.bfloat16, 768, 128, True, TC_FWD, TC_BWD),
    (torch.bfloat16, 1280, 40, True, TC_FWD, TC_BWD),
    (torch.bfloat16, 1288, 128, True, MEM_FWD, MEM_BWD),
    (torch.bfloat16, 512, 256, True, MEM_FWD, MEM_BWD),
    (torch.bfloat16, 512, 256, False, MEM_FWD, MEM_BWD),
    (torch.float32, 512, 128, True, MEM_FWD, MEM_BWD),
    (torch.float32, 512, 128, False, MEM_FWD, MEM_BWD),
    # (K, label slots) past 4 slots
    (torch.bfloat16, 512, (128, 16), True, SLOTS_FWD, SLOTS_BWD),
    (torch.bfloat16, 512, (128, 16), False, SLOTS_FWD, SLOTS_BWD),
    (torch.bfloat16, 512, (256, 16), True, SLOTS_FWD, SLOTS_BWD),
    (torch.bfloat16, 512, (256, 16), False, SLOTS_FWD, SLOTS_BWD),
    (torch.bfloat16, 1280, (40, 5), True, SLOTS_FWD, SLOTS_BWD),
    (torch.bfloat16, 1288, (128, 16), True, MEM_FWD, MEM_BWD),
    (torch.float32, 512, (128, 16), True, MEM_FWD, MEM_BWD),
    (torch.float32, 512, (256, 16), False, MEM_FWD, MEM_BWD),
])
def test_pixel_text_ce_tc_route_by_shape(dtype, D, K, flag, fwd, bwd):
    """The kernel that writes for each (dtype, D, K, device flag, label
    slots; K a pair where the slots are not 1): past 4 slots, bf16 up to D
    = 1280 takes the tensor-core pair past 4 slots in both directions,
    whatever the flag and K (and without a packed table); else the
    tensor-core kernels take bf16 packed tables up to D = 1280 and K =
    128, in both directions (the member-only backward reads row statistics
    that only the member-only forward writes), where the flag selects the
    packed table; the member-only kernels (launched beside them, or alone)
    take the rest: fp32 at any slot count, a full table, wider or larger
    packed tables, and the flag at 0 (a contrast set over the capacity).
    No route scores a full table.  The tensor-core backward's transposed
    table is the packed table exactly, zero-padded to a multiple of 8
    classes."""
    K, slots = K if isinstance(K, tuple) else (K, 1)
    samples = torch.zeros(3, D, dtype=dtype)
    ptable = torch.randn(K, D).to(dtype)

    def writer(backward):
        names = ((SLOTS_BWD, TC_BWD, MEM_BWD) if backward else
                 (SLOTS_FWD, TC_FWD, MEM_FWD))
        if ce_k.slots_route(samples, slots):
            return names[0]
        return names[1] if ce_k.tc_route(samples, ptable, slots) and flag \
            else names[2]

    assert writer(False) == fwd
    assert writer(True) == bwd
    assert not ce_k.tc_route(samples, None)
    ptable_t = ce_k.transposed_table(ptable[:K - 3])
    assert ptable_t.shape == (D, -(-(K - 3) // 8) * 8)
    assert torch.equal(ptable_t[:, :K - 3], ptable[:K - 3].T)
    assert not ptable_t[:, K - 3:].any()


@pytest.mark.parametrize("packed,flag", [(False, None), (True, True),
                                         (True, False)])
def test_pixel_text_ce_member_table(packed, flag):
    """The member-only kernels' table operand: the members of the table the
    flag selects (the packed one where it is set, else the full one),
    first and in table order, transposed to f32 exactly, their global ids
    and the device count; then the selected table's other rows in table
    order (what the backward scores when there is no member)."""
    rng = np.random.default_rng(5)
    C, D, K = 70, 24, 32
    text = t(rng.standard_normal((C, D)).astype(np.float32)).bfloat16()
    mask = t(rng.random(C) < 0.3).int()
    members = mask.nonzero()[:, 0].int()
    args = ()
    if packed:
        ids = torch.full((K,), C, dtype=torch.int32)
        ids[:members.numel()] = members
        args = (text[ids.clamp_max(C - 1).long()], (ids < C).int(), ids,
                torch.tensor([int(flag)], dtype=torch.int32))
    table_t, row_ids, count = ce_k.member_table(text, mask, *args)
    n = int(count)
    assert count.shape == (1,) and count.dtype == torch.int32
    assert n == members.numel()
    assert table_t.dtype == torch.float32
    rows = C + (K if packed else 0)
    assert table_t.shape == (D, -(-rows // 4) * 4)
    assert torch.equal(row_ids[:n], members)
    assert torch.equal(table_t[:, :n], text[members.long()].float().T)
    sel_ids = args[2] if packed and flag else torch.arange(C,
                                                           dtype=torch.int32)
    rest = sel_ids[~torch.isin(sel_ids, members)]
    assert torch.equal(row_ids[n:n + rest.numel()], rest)


@pytest.mark.parametrize("packed,flag", [(False, None), (True, True),
                                         (True, False)])
@pytest.mark.parametrize("members", [0, 9, 70])
def test_pixel_text_ce_member_rows(packed, flag, members):
    """The tensor-core pair past 4 slots' operands: :func:`member_table`'s
    rows, ids and count, in bf16 exactly, row-major and transposed (zero
    columns up to a multiple of 8), from no member to every class."""
    rng = np.random.default_rng(6)
    C, D, K = 70, 24, 32
    text = t(rng.standard_normal((C, D)).astype(np.float32)).bfloat16()
    mask = torch.zeros(C, dtype=torch.int32)
    mask[t(rng.permutation(C)[:members]).long()] = 1
    member_ids = mask.nonzero()[:, 0].int()
    args = ()
    if packed:
        ids = torch.full((K,), C, dtype=torch.int32)
        ids[:min(members, K)] = member_ids[:K]
        args = (text[ids.clamp_max(C - 1).long()], (ids < C).int(), ids,
                torch.tensor([int(flag)], dtype=torch.int32))
    rows, rows_t, row_ids, count = ce_k.member_rows(text, mask, *args)
    table_t, want_ids, want_count = ce_k.member_table(text, mask, *args)
    R = C + (K if packed else 0)
    assert rows.dtype == rows_t.dtype == torch.bfloat16
    assert rows.shape == (R, D) and rows_t.shape == (D, -(-R // 8) * 8)
    assert torch.equal(rows.float(), table_t[:, :R].T)
    assert torch.equal(rows_t[:, :R], rows.T)
    assert not rows_t[:, R:].any()
    assert torch.equal(row_ids, want_ids)
    assert torch.equal(count, want_count)
    assert ce_k.delta_pitch(R) % 128 == 0 and ce_k.delta_pitch(R) >= R


@pytest.mark.parametrize("slots", [5, 11])
def test_pixel_text_ce_padded_slots_add_nothing(slots):
    """5-15 slots run on the kernels' 16-slot instances (bf16: the
    tensor-core pair past 4 slots): ``padded_slots`` appends slots of
    label -1 and weight 0, and the plain forward and backward on the
    padded operands are bit-equal to those on the slots given, over the
    full and the packed table."""
    rng = np.random.default_rng(5)
    C = 200
    samples, labels, valid, text, mask, ids = _ce_case(
        rng, "bf16", (300, 64), C, slots, True)
    args = (t(samples).to(torch.bfloat16), torch.tensor(0.07))
    table = t(text).to(torch.bfloat16)
    packed = (table[t(np.minimum(ids, C - 1)).long()], t(ids < C).int(),
              t(ids), torch.tensor(True))
    lab, val = ce_k.padded_slots(t(labels), t(valid))
    assert lab.shape == val.shape == (ce_k.MAX_SLOTS, 300)
    assert bool((lab[slots:] == -1).all()) and not val[slots:].any()
    assert ce_k.slots_route(args[0], slots)
    assert ce_k.tc_route(args[0], packed[0], ce_k.TC_MAX_SLOTS)
    for pk in (None, packed):
        want = ce_k.pixel_text_ce_plain(*args, t(labels), t(valid), table,
                                        t(mask).int(), pk)
        got = ce_k.pixel_text_ce_plain(*args, lab, val, table, t(mask).int(),
                                       pk)
        assert torch.equal(got, want)
        g = torch.tensor(1.0)
        want = ce_k.pixel_text_ce_backward_plain(
            g, *args, t(labels), t(valid), table, t(mask).int(), pk)
        got = ce_k.pixel_text_ce_backward_plain(g, *args, lab, val, table,
                                                t(mask).int(), pk)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _members_backward(grad, samples, temperature, labels, valid, table,
                      mask, packed=None):
    """The member-only backward (csrc/pixel_text_ce.cu,
    ce_members_bwd_kernel) transcribed in torch: the members of the
    selected table gathered by ``member_table`` (with none, every row of
    the selected table, at -1e30), delta rounded to the samples' dtype over
    them only, and each valid label of a non-member in the selected table
    adding its row's terms: -1e30 to its pick, and its delta (minus the
    weights of the slots with that label) times its row to d_emb.  The
    non-members' exp terms are exactly 0, so the statistics need no seed
    here."""
    flat, lab, val, msk, pt, pm, pi, flag = ce_k.ce_operands(
        samples, temperature, labels, valid, table, mask, packed)
    dtype = flat.dtype
    table_t, ids, count = ce_k.member_table(table, msk, pt, pm, pi, flag)
    on = pt is not None and bool(flag)
    sel_table, sel_mask, sel_ids = ((pt, pm, pi) if on else
                                    (table, msk, torch.arange(
                                        table.shape[0], dtype=torch.int32)))
    n = int(count)
    ncol = n if n > 0 else sel_table.shape[0]
    cols = table_t[:, :ncol]
    x = flat.float()
    rs = ce_k.row_scale(x)
    emb = x * rs
    inv_temp = 1.0 / temperature.float()
    lu = (emb.to(dtype).float() @ cols) * inv_temp
    logits = lu if n > 0 else torch.full_like(lu, ce_k.NEG_INF)
    m = logits.max(dim=1, keepdim=True).values
    e = torch.exp(logits - m)
    inv_z = 1.0 / e.sum(dim=1, keepdim=True)
    w = grad.float() * val
    wsum = w.sum(dim=0)[:, None]
    delta = e * (wsum * inv_z)
    picks = []
    for s in range(lab.shape[0]):
        match = ids[None, :ncol] == lab[s][:, None]
        delta = delta - torch.where(match, w[s][:, None], 0.0)
        picks.append(torch.where(match, logits, 0.0).sum(dim=1))
    delta = delta.to(dtype).float()
    d_emb = delta @ cols.T
    if n > 0:
        rows = sel_table.float()
        for s in range(lab.shape[0]):
            hits = (sel_ids[None, :] == lab[s][:, None]) & (sel_mask == 0)
            picks[s] = picks[s] + hits.sum(dim=1) * ce_k.NEG_INF
            first = torch.ones_like(lab[s], dtype=torch.bool)
            for s2 in range(s):
                first &= lab[s2] != lab[s]
            cf = torch.zeros_like(w[s])
            for s2 in range(s, lab.shape[0]):
                cf = cf - torch.where(lab[s2] == lab[s], w[s2], 0.0)
            cf = cf.to(dtype).float()
            coef = torch.where(hits & first[:, None], cf[:, None], 0.0)
            d_emb = d_emb + coef @ rows
    wpick = sum(w[s] * picks[s] for s in range(lab.shape[0]))
    dtau = wpick - wsum[:, 0] * ((e * logits).sum(dim=1) * inv_z[:, 0])
    d_emb = d_emb * inv_temp
    proj = (emb * d_emb).sum(dim=1, keepdim=True)
    dx = rs * (d_emb - emb * proj)
    return dx.to(dtype).reshape(samples.shape), dtau.sum() / temperature


@pytest.mark.parametrize("dtype,slots,packed,flag,n_members,nonmember", [
    ("f32", 4, False, None, 40, False),
    ("f32", 4, False, None, 40, True),
    ("f32", 1, False, None, 150, True),
    ("bf16", 4, False, None, 40, True),
    ("bf16", 4, True, True, 40, True),
    ("bf16", 1, True, False, 150, True),
    ("f32", 4, True, True, 40, False),
    ("f32", 4, False, None, 0, True),
    ("bf16", 16, True, True, 40, True),
    ("f32", 16, False, None, 40, True),
])
def test_pixel_text_ce_members_backward_transcription(dtype, slots, packed,
                                                      flag, n_members,
                                                      nonmember):
    """The member-only backward's arithmetic, transcribed
    (``_members_backward``), against the plain backward and JAX's
    ``_ce_bwd_rule`` in interpret mode (``fused_pixel_text_ce``'s
    custom_vjp), on the table the flag selects (C = 200, capacity 128).
    Against the plain version: f32 d samples within 1e-5 of the row's
    largest entry (f32 summation order), bf16 within one bf16 ulp plus
    2^-10 of it (the card's check), d temperature within rtol 1e-5.
    Against JAX the tolerances of test_pixel_text_ce_plain_matches_pallas.
    With non-member labels weighted, a contrast set of 150 (past one
    128-class tile, and over the capacity: the flag at 0), none at all
    (every row of the table scored at -1e30), and 16 slots (a MiT field at
    H/4, the kernels' widest instance)."""
    rng = np.random.default_rng(7)
    C, D = 200, 64
    samples, labels, valid, text, mask, ids = _ce_case(
        rng, dtype, (300, D), C, slots, packed, max(n_members, 1), nonmember)
    if n_members == 0:
        mask[:] = False
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    temp = torch.tensor(0.07)
    args = (t(samples).to(tdt), temp, t(labels), t(valid), t(text).to(tdt),
            t(mask))
    packed_args = None
    if packed:
        packed_args = (t(text[np.minimum(ids, C - 1)]).to(tdt), t(ids < C),
                       t(ids), torch.tensor(flag))
    g = torch.tensor(1.0)
    got_dx, got_dt = _members_backward(g, *args, packed=packed_args)
    flat, lab_t, val_t, msk, pt, pm, pi, flag_t = ce_k.ce_operands(
        *args, packed_args)
    want_dx, want_dt = ce_k.pixel_text_ce_backward_plain(
        g, flat, temp, lab_t, val_t, args[4], msk,
        packed=None if pt is None else (pt, pm, pi, flag_t))
    scale = want_dx.double().abs().amax(dim=-1, keepdim=True)
    err = (got_dx.double() - want_dx.double()).abs()
    if dtype == "f32":
        assert bool((err <= 1e-5 * scale + 1e-12).all()), float(err.max())
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            want_dx.double().abs().clamp_min(1e-30))) - 7)
        assert bool((err <= ulp + scale * 2.0 ** -10).all())
    np.testing.assert_allclose(float(got_dt), float(want_dt), rtol=1e-5)

    # JAX's backward on the selected table (its lax.cond is outside)
    on = packed and flag
    jtable = text[np.minimum(ids, C - 1)] if on else text
    jmask = ids < C if on else mask
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    lab = labels if slots > 1 else labels[0]
    val = valid if slots > 1 else valid[0]
    _, (gs, gt) = jax.value_and_grad(
        lambda s, tau: jax_ce(s, tau, jnp.asarray(lab), jnp.asarray(val),
                              jnp.asarray(jtable), jnp.asarray(jmask), 512,
                              True, jnp.asarray(ids) if on else None),
        argnums=(0, 1))(jnp.asarray(samples).astype(jdt), np.float32(0.07))
    gs = np.asarray(gs.astype(jnp.float32))
    dx = got_dx.float().numpy()
    # with no member, d tau is a difference of sums of 1e30-sized terms
    # whose f32 rounding depends on their order: held to the plain version
    # above only
    if dtype == "f32":
        np.testing.assert_allclose(dx, gs, rtol=1e-4,
                                   atol=1e-6 * np.abs(gs).max())
        if n_members:
            np.testing.assert_allclose(float(got_dt), float(gt), rtol=1e-4)
    else:
        np.testing.assert_allclose(float(got_dt), float(gt), rtol=1e-3)
        ref_scale = np.abs(gs).max(axis=1, keepdims=True)
        assert (np.abs(dx - gs) <= 2 * ref_scale * 2.0 ** -8).all()


@pytest.mark.parametrize("shape", [(32, 128, 128, 512), (3, 10, 16, 128),
                                   (1, 2, 2, 8), (7, 33, 35, 136),
                                   (8193, 64, 2, 8)])
@pytest.mark.parametrize("upsample", [1, 2])
def test_tv_forward_value_arithmetic_matches_scale_sums(shape, upsample):
    """The forward kernel's last step (csrc/band_ring.cuh,
    tv_fwd_value_kernel): from the summed |dh| and |dv|, true f32 division
    by the pair counts, the upsample factors, then the add, with its
    arguments the Python floats of ``pair_scalars`` rounded once to f32.
    It reproduces ``scale_sums``' tensor arithmetic bit for bit."""
    rng = np.random.default_rng(6)
    ph, pv, rh, rv = (np.float32(v) for v in tv_k.pair_scalars(shape,
                                                                upsample))
    for _ in range(50):
        s_h, s_v = (np.float32(v) for v in rng.uniform(0, 2, 2) * ph)
        got = np.float32(np.float32(s_h / ph) * rh) + np.float32(
            np.float32(s_v / pv) * rv)
        want = tv_k.scale_sums(torch.tensor(s_h), torch.tensor(s_v), shape,
                               upsample)
        assert want.dtype == torch.float32
        assert np.float32(want.item()).tobytes() == got.tobytes()


@pytest.mark.parametrize("shape,weights,upsample", [
    ((3, 16, 16, 128), (1.0, 0.0, 1.0), 2),
    ((2, 12, 8, 128), None, 1),
])
def test_tv_rowtile_plain_matches_pallas(shape, weights, upsample):
    """bf16 with ties, several row tiles (the 1 MB forward tile is forced
    down by the image size), a zero weight: the plain value within rtol 1e-5
    (f32 partial-sum order) and its VJP bit-equal to the kernel in interpret
    mode, as the JAX package's own test finds its XLA VJP."""
    rng = np.random.default_rng(3)
    x = (rng.integers(-6, 7, shape) / 4 + rng.standard_normal(shape)
         * (rng.random(shape) > 0.5)).astype(np.float32)
    assert jax_tv_applicable(shape, jnp.bfloat16)
    assert tv_k.kernel_applicable(shape, torch.bfloat16)
    w = None if weights is None else np.asarray(weights, np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    fn = lambda v: jax_tv_rowtile(  # noqa: E731
        v, None if w is None else jnp.asarray(w), upsample, True)
    want, vjp = jax.vjp(fn, jx)
    (gx,) = vjp(jnp.float32(1.7))
    xs = t(x).bfloat16().requires_grad_()
    got = tv_k.tv_rowtile(xs, None if w is None else t(w), upsample)
    got.backward(torch.tensor(1.7))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_array_equal(xs.grad.float().numpy(),
                                  np.asarray(gx.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tv_plain_vjp_matches_jax(dtype):
    """The plain TV and its hand-derived VJP against the JAX ``_tv``: the
    gradient bit-equal (+1 at ties), the value within rtol 1e-6."""
    rng = np.random.default_rng(4)
    x = (rng.integers(-3, 4, (2, 5, 7, 6)) / 2).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    want, vjp = jax.vjp(lambda v: jax_tv(v, 2), jnp.asarray(x).astype(jdt))
    (gx,) = vjp(jnp.float32(0.3))
    xs = t(x).to(tdt).requires_grad_()
    got = tv_k.tv_plain(xs, 2)
    got.backward(torch.tensor(0.3))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_array_equal(xs.grad.float().numpy(),
                                  np.asarray(gx.astype(jnp.float32)))


def test_fake_implementations_give_the_output_metadata():
    """The operators are CUDA-only; their fake implementations (what
    ``torch.export`` and ``torch.compile`` trace with) give the shapes and
    dtypes of the real outputs.  ``opcheck`` runs on the card."""
    with FakeTensorMode():
        idx = torch.empty(3, 50, dtype=torch.int32)
        assert hist_k.histogram_op(idx, 70).shape == (3, 70)
        x = torch.empty(2, 4, 8, 16, dtype=torch.bfloat16)
        assert tv_k.tv_rowtile_op(x, None, 2).shape == ()
        dx = tv_k.tv_rowtile_backward_op(x, None, torch.empty(()), 2)
        assert dx.shape == x.shape and dx.dtype == torch.bfloat16
        s = torch.empty(64, 16, dtype=torch.bfloat16)
        args = (s, torch.empty(()), torch.empty(4, 64, dtype=torch.int32),
                torch.empty(4, 64), torch.empty(10, 16, dtype=torch.bfloat16),
                torch.empty(10, dtype=torch.int32), None, None, None, None)
        out, stats = ce_k.pixel_text_ce_op(*args)
        assert out.shape == () and out.dtype == torch.float32
        assert stats.shape == (2, 64) and stats.dtype == torch.float32
        ds, dt = ce_k.pixel_text_ce_backward_op(torch.empty(()), stats,
                                                *args)
        assert ds.shape == s.shape and ds.dtype == s.dtype and dt.shape == ()
        slot_args = (s, torch.empty(()),
                     torch.empty(16, 64, dtype=torch.int32),
                     torch.empty(16, 64), *args[4:])
        out, stats = ce_k.pixel_text_ce_slots_op(*slot_args)
        assert out.shape == () and out.dtype == torch.float32
        assert stats.shape == (2, 64) and stats.dtype == torch.float32
        ds, dt = ce_k.pixel_text_ce_slots_backward_op(torch.empty(()), stats,
                                                      *slot_args)
        assert ds.shape == s.shape and ds.dtype == s.dtype and dt.shape == ()
