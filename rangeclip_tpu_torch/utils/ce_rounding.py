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
- the plain formula with other logits: exactly rounded (an f64 sum), and an
  f32 FMA chain over D in order, which is the plain version's own sum.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--rows", type=int, default=524288)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ce_rounding: CUDA is not available")

    from rangeclip_tpu_torch.losses.infonce import pack_contrast_set
    from rangeclip_tpu_torch.ops.kernels import _lib
    from rangeclip_tpu_torch.ops.kernels.pixel_text_ce import (
        ce_operands,
        member_table,
        pixel_text_ce_backward_plain,
        row_scale,
        transposed_table,
    )
    from rangeclip_tpu_torch.utils.math import l2_normalize

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    N, D, C, K, S = args.rows, 512, 512, 128, 4
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
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    bound = ulp + want.abs().amax(dim=-1, keepdim=True) * 2.0 ** -10

    def report(name, dx):
        ratio = ((dx.double() - want).abs() / bound).amax(dim=1)
        print(f"{name}: largest error / bound {float(ratio.max()):.6f}, rows "
              f"past 1: {int((ratio > 1).sum())}, past 0.5: "
              f"{int((ratio > 0.5).sum())}", flush=True)

    lib, stream = _lib.library(), _lib.stream_of(x)
    dx, dtau = torch.empty_like(x), torch.empty(N, device=dev)
    ptable_t = transposed_table(pt)
    _lib.check(lib.rc_pixel_text_ce_tc_bwd(
        x.data_ptr(), temp.data_ptr(), g.data_ptr(), lab.data_ptr(),
        val.data_ptr(), S, N, D, pt.data_ptr(), ptable_t.data_ptr(),
        pm.data_ptr(), pi.data_ptr(), K, flag.data_ptr(), dx.data_ptr(),
        dtau.data_ptr(), stream), "pixel_text_ce_tc[bwd]")
    torch.cuda.synchronize()
    report("tensor-core kernel", dx)
    table_bf16 = text.bfloat16()
    table_t, row_ids, count = member_table(table_bf16, msk, pt, pm, pi, flag)
    work = _lib.workspace("rc_pixel_text_ce_workspace", x,
                          table_t.shape[1] + D, N)
    # its forward first, for the row statistics the backward reads
    ce_rows, stats = torch.empty(N, device=dev), torch.empty(2, N, device=dev)
    _lib.check(lib.rc_pixel_text_ce_members_fwd(
        x.data_ptr(), 1, temp.data_ptr(), lab.data_ptr(), val.data_ptr(), S,
        N, D, table_t.data_ptr(), table_t.shape[1], row_ids.data_ptr(),
        count.data_ptr(), msk.data_ptr(), C, pm.data_ptr(), pi.data_ptr(), K,
        flag.data_ptr(), 0, ce_rows.data_ptr(), stats.data_ptr(), stream),
        "pixel_text_ce[fwd]")
    _lib.check(lib.rc_pixel_text_ce_bwd(
        x.data_ptr(), 1, temp.data_ptr(), g.data_ptr(), lab.data_ptr(),
        val.data_ptr(), S, N, D, table_t.data_ptr(), table_t.shape[1],
        row_ids.data_ptr(), count.data_ptr(), table_bf16.data_ptr(),
        msk.data_ptr(), C, pt.data_ptr(), pm.data_ptr(), pi.data_ptr(), K,
        flag.data_ptr(), 0, stats.data_ptr(), dx.data_ptr(), dtau.data_ptr(),
        work.data_ptr(), stream), "pixel_text_ce[bwd]")
    torch.cuda.synchronize()
    report("CUDA-core kernel", dx)

    # the plain backward (pixel_text_ce_backward_plain) on given sums
    xf = x.float()
    rs = row_scale(xf)
    emb = xf * rs
    eb, table = emb.bfloat16().float(), pt.float()

    def plain_dx(sims):
        inv_temp = 1.0 / temp
        logits = torch.where(pm[None, :] != 0, sims * inv_temp,
                             torch.full_like(sims, -1e30))
        e = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
        inv_z = 1.0 / e.sum(dim=1, keepdim=True)
        wsum = sum(g * val[s][:, None] for s in range(S))
        delta = e * (wsum * inv_z)
        for s in range(S):
            delta = delta - torch.where(pi[None, :] == lab[s][:, None],
                                        g * val[s][:, None], 0.0)
        d_emb = (delta.bfloat16().float() @ table) * inv_temp
        proj = (emb * d_emb).sum(dim=1, keepdim=True)
        return (rs * (d_emb - emb * proj)).bfloat16()

    def by_rows(fn, step=65536):
        return torch.cat([fn(eb[i:i + step]) for i in range(0, N, step)])

    def chain(a):
        acc = torch.zeros(a.shape[0], K, device=dev)
        for k in range(D):
            acc = torch.addcmul(acc, a[:, k:k + 1], table[None, :, k])
        return acc

    report("plain formula, exactly rounded logits",
           plain_dx(by_rows(lambda a: (a.double() @ table.double().T)
                            .float())))
    report("plain formula, f32 FMA-chain logits", plain_dx(by_rows(chain)))


if __name__ == "__main__":
    main()
