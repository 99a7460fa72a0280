"""How far the bf16 backward of ``pixel_text_ce`` is from its plain version,
measured against the check that ``chip_smoke.py`` and the card tests apply
(d samples within one bf16 ulp plus 2^-10 of the row's largest entry).

    python -m rangeclip_tpu_torch.utils.ce_rounding [--seed 5] [--rows N]

The backward rounds delta to bf16 before its product with the table, as the
TPU kernel does, so a logit that differs in its last f32 bits can flip a
delta's rounding; when that delta is a label's, the row's d samples move by
a sizeable share of the bound.  At the flagship packed shape (bf16, D =
512, K = 128, S = 4, 90 members of C = 512) this prints, for each variant,
the largest ratio of error to bound and the rows past 1 and 0.5 of it:

- the tensor-core kernel and the member-only CUDA-core kernel, launched
  directly;
- the plain formula with other logits: exactly rounded (an f64 sum), an
  f32 FMA chain over D in order, which is the plain version's own sum, and
  the exact sums rounded to bf16, a rounding fault the check must see.

``--dim`` sets D; the kernels then get the operands zero-padded to a
multiple of 8, as the wrapper gives them.  The bound takes one bf16 ulp
from :func:`bf16_ulp` (``frexp``: exact on any device); the line after the
kernels counts the entries where ``exp2(floor(log2(|x|)) - 7)``, the form
the check once took, gives another ulp on the card, and each line gives
the ratio under that form too.

Needs a CUDA device (:func:`bf16_ulp` and :func:`within_bf16_ulp`, which
the card checks share, run anywhere).
"""

from __future__ import annotations

import argparse

import torch


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each |x| (the spacing of bf16 values in its binade:
    2^(e - 8) for |x| in [2^(e-1), 2^e)), in f64, exact on any device:
    exp2(floor(log2(x))) is not on the card, whose f64 log2 can fall just
    below an integer at a power of two and halve the ulp."""
    _, e = torch.frexp(x.double().abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float64), e - 8)


def within_bf16_ulp(got: torch.Tensor, want: torch.Tensor,
                    slack=0.0) -> bool:
    """Every |got - want| within one bf16 ulp of want plus ``slack``."""
    got, want = got.double(), want.double()
    return bool(((got - want).abs() <= bf16_ulp(want) + slack).all())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--rows", type=int, default=524288)
    parser.add_argument("--dim", type=int, default=512,
                        help="D; the kernels get the operands zero-padded "
                             "to a multiple of 8, as the wrapper pads them")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ce_rounding: CUDA is not available")

    from rangeclip_tpu_torch.losses.infonce import pack_contrast_set
    from rangeclip_tpu_torch.ops.kernels import _lib
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import (
        ce_operands,
        member_table,
        pixel_text_ce_backward_plain,
        transposed_table,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    N, D, C, K, S = args.rows, args.dim, 512, 128, 4
    text = l2_normalize(torch.randn(C, D, device=dev, generator=gen), dim=-1)
    samples = torch.randn(N, D, device=dev, generator=gen).bfloat16()
    perm = torch.randperm(C, device=dev, generator=gen)
    mask = torch.zeros(C, dtype=torch.bool, device=dev)
    mask[perm[:90]] = True
    members = perm[:90].sort().values.int()
    labels = members[torch.randint(0, 90, (S, N), device=dev, generator=gen)]
    valid = torch.randint(0, 3, (S, N), device=dev, generator=gen).float()
    temp = torch.tensor(0.07, device=dev)
    ids, ptable, pmask = pack_contrast_set(mask, text, K)
    packed = (ptable.bfloat16(), pmask, ids, mask.sum() <= K)
    x, lab, val, msk, pt, pm, pi, flag = ce_operands(
        samples, temp, labels, valid, text.bfloat16(), mask, packed)
    g = torch.tensor(1.0 / N, device=dev)
    want, _ = pixel_text_ce_backward_plain(g, x, temp, lab, val,
                                           text.bfloat16(), msk,
                                           packed=(pt, pm, pi, flag))
    want = want.double()
    ulp = bf16_ulp(want)
    bound = ulp + want.abs().amax(dim=-1, keepdim=True) * 2.0 ** -10
    # the form the checks took before bf16_ulp, for comparison
    log2_ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(1e-30))) - 7)

    log2_bound = log2_ulp + want.abs().amax(dim=-1, keepdim=True) * 2.0 ** -10

    def report(name, dx):
        err = (dx.double() - want).abs()
        ratio = (err / bound).amax(dim=1)
        log2_ratio = (err / log2_bound).amax(dim=1)
        print(f"{name}: largest error / bound {float(ratio.max()):.6f}, rows "
              f"past 1: {int((ratio > 1).sum())}, past 0.5: "
              f"{int((ratio > 0.5).sum())} (with the log2 form's ulp: "
              f"{float(log2_ratio.max()):.6f}, rows past 1: "
              f"{int((log2_ratio > 1).sum())})", flush=True)

    # the kernels' operands, D zero-padded as the wrapper pads it
    xk, table_bf16, ptk = (_lib.pad_dim8(x), _lib.pad_dim8(text.bfloat16()),
                           _lib.pad_dim8(pt))
    D8 = xk.shape[1]
    lib, stream = _lib.library(), _lib.stream_of(x)
    dx, dtau = torch.empty_like(xk), torch.empty(N, device=dev)
    ptable_t = transposed_table(ptk)
    _lib.check(lib.rc_pixel_text_ce_tc_bwd(
        xk.data_ptr(), temp.data_ptr(), g.data_ptr(), lab.data_ptr(),
        val.data_ptr(), S, N, D8, ptk.data_ptr(), ptable_t.data_ptr(),
        pm.data_ptr(), pi.data_ptr(), K, flag.data_ptr(), dx.data_ptr(),
        dtau.data_ptr(), stream), "pixel_text_ce_tc[bwd]")
    torch.cuda.synchronize()
    report("tensor-core kernel", dx[:, :D])
    table_t, row_ids, count = member_table(table_bf16, msk, ptk, pm, pi,
                                           flag)
    work = _lib.workspace("rc_pixel_text_ce_workspace", xk,
                          table_t.shape[1] + D8, N)
    # its forward first, for the row statistics the backward reads
    ce_rows, stats = torch.empty(N, device=dev), torch.empty(2, N, device=dev)
    _lib.check(lib.rc_pixel_text_ce_members_fwd(
        xk.data_ptr(), 1, temp.data_ptr(), lab.data_ptr(), val.data_ptr(), S,
        N, D8, table_t.data_ptr(), table_t.shape[1], row_ids.data_ptr(),
        count.data_ptr(), msk.data_ptr(), C, pm.data_ptr(), pi.data_ptr(), K,
        flag.data_ptr(), 0, ce_rows.data_ptr(), stats.data_ptr(), stream),
        "pixel_text_ce[fwd]")
    _lib.check(lib.rc_pixel_text_ce_bwd(
        xk.data_ptr(), 1, temp.data_ptr(), g.data_ptr(), lab.data_ptr(),
        val.data_ptr(), S, N, D8, table_t.data_ptr(), table_t.shape[1],
        row_ids.data_ptr(), count.data_ptr(), table_bf16.data_ptr(),
        msk.data_ptr(), C, ptk.data_ptr(), pm.data_ptr(), pi.data_ptr(), K,
        flag.data_ptr(), 0, stats.data_ptr(), dx.data_ptr(), dtau.data_ptr(),
        work.data_ptr(), stream), "pixel_text_ce[bwd]")
    torch.cuda.synchronize()
    report("CUDA-core kernel", dx[:, :D])
    print(f"the log2 form of the ulp differs from frexp's in "
          f"{int((log2_ulp != ulp).sum())} of {ulp.numel()} entries",
          flush=True)

    report("plain formula, exactly rounded logits",
           plain_dx(x, temp, g, lab, val, pt, pm, pi, "exact"))
    report("plain formula, f32 FMA-chain logits",
           plain_dx(x, temp, g, lab, val, pt, pm, pi, "chain"))
    report("plain formula, bf16-rounded logits (a fault)",
           plain_dx(x, temp, g, lab, val, pt, pm, pi, "bf16"))


def plain_dx(x, temp, g, lab, val, ptable, pmask, pids, sums: str,
             step: int = 65536) -> torch.Tensor:
    """d samples of the plain backward (``pixel_text_ce_backward_plain``)
    over the packed table, [N, D] in x's dtype, with the logits' dot
    products summed another way: ``"exact"`` (in f64, rounded once to f32),
    ``"chain"`` (an f32 FMA chain over D in order, the plain version's own
    sum) or ``"bf16"`` (the exact sums rounded to bf16, a control with a
    rounding fault).  The products run ``step`` rows at a time."""
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import row_scale

    xf = x.float()
    rs = row_scale(xf)
    emb = xf * rs
    eb, table = emb.to(ptable.dtype).float(), ptable.float()

    def sims_of(a):
        if sums == "chain":
            acc = torch.zeros(a.shape[0], table.shape[0], device=a.device)
            for k in range(a.shape[1]):
                acc = torch.addcmul(acc, a[:, k:k + 1], table[None, :, k])
            return acc
        exact = (a.double() @ table.double().T).float()
        return exact.bfloat16().float() if sums == "bf16" else exact

    sims = torch.cat([sims_of(eb[i:i + step])
                      for i in range(0, eb.shape[0], step)])
    inv_temp = 1.0 / temp
    logits = torch.where(pmask[None, :] != 0, sims * inv_temp,
                         torch.full_like(sims, -1e30))
    e = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
    inv_z = 1.0 / e.sum(dim=1, keepdim=True)
    S = lab.shape[0]
    wsum = sum(g * val[s][:, None] for s in range(S))
    delta = e * (wsum * inv_z)
    for s in range(S):
        delta = delta - torch.where(pids[None, :] == lab[s][:, None],
                                    g * val[s][:, None], 0.0)
    d_emb = (delta.to(ptable.dtype).float() @ table) * inv_temp
    proj = (emb * d_emb).sum(dim=1, keepdim=True)
    return (rs * (d_emb - emb * proj)).to(x.dtype)


if __name__ == "__main__":
    main()
