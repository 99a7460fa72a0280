"""Row L2-normalisation y = x / max(||x||_2, 1e-12) with its exact VJP.

Port of ``rangeclip_tpu/ops/pallas/l2_normalize.py``: ``fused_l2_normalize``
(flat rows or a 4-D field) and ``fused_l2_normalize_field`` (the decoder's
[B, h, w, D] field), both ``jax.custom_vjp`` functions.  The CUDA kernels
are ``csrc/l2_normalize.cu``, one forward and one backward, over contiguous
[N, D] rows; both public names run them, since the field variant's
relayout absorption is TPU layout work that the card does not need.

The pair is the operator ``rangeclip::l2_normalize`` with
``rangeclip::l2_normalize_backward`` registered as its gradient
(``torch.library.register_autograd``, PyTorch's counterpart of
``custom_vjp``).  Like the JAX function it saves x as its only residual.

Plain versions: the forward is ``utils.math.l2_normalize`` on the f32 rows,
rounded once to x's dtype, and its gradient is autograd's;
:func:`l2_normalize_backward_plain` writes that gradient out
(l2_normalize.py:52-63), for the operator's CPU implementation.
"""

from __future__ import annotations

import torch

from rangeclip_tpu_torch.ops.kernels import _lib
from rangeclip_tpu_torch.utils.math import l2_normalize

EPS = 1e-12


def l2_normalize_plain(x: torch.Tensor) -> torch.Tensor:
    """Stats in f32, the result in x's dtype; differentiable by autograd."""
    return l2_normalize(x.float(), dim=-1, eps=EPS).to(x.dtype)


def l2_normalize_backward_plain(x: torch.Tensor, g: torch.Tensor
                                ) -> torch.Tensor:
    """dx = g/m - [n >= eps] * (sum g.x) / (m^2 n) * x, m = max(n, eps),
    in f32, rounded to x's dtype.  A zero row gives dx = g / eps: finite."""
    xf, gf = x.float(), g.float()
    n = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    m = n.clamp_min(EPS)
    t = (gf * xf).sum(dim=-1, keepdim=True)
    factor = torch.where(n >= EPS, t / (m * m * n.clamp_min(EPS)), 0.0)
    return (gf / m - xf * factor).to(x.dtype)


def l2_normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Normalise the last dim of contiguous ``x`` [..., D] (f32 or bf16).
    CUDA tensors run the kernels, forward and backward; CPU tensors run
    :func:`l2_normalize_plain`."""
    _lib.require(x.dtype in (torch.float32, torch.bfloat16),
                 f"l2_normalize: x must be f32 or bf16, got {x.dtype}")
    _lib.require(x.dim() >= 1 and x.is_contiguous(),
                 "l2_normalize: x must be contiguous [..., D]")
    kind = _lib.require_device("l2_normalize", x)
    if kind == "cpu":
        return l2_normalize_plain(x)
    D = x.shape[-1]
    _lib.require(D % 8 == 0, f"l2_normalize: the kernel needs D % 8 == 0, "
                 f"got {D}")
    return l2_normalize_op(x.reshape(-1, D)).reshape(x.shape)


def field_kernel_applicable(shape) -> bool:
    """The JAX gate of the decoder's field kernel (l2_normalize.py:179),
    kept so that dispatch matches JAX: B % 8, W % 8 and D % 128 are TPU
    tiling rules and the w-tile search a VMEM budget; the CUDA kernel needs
    only D % 8.  To be re-derived from H100 measurements."""
    if len(shape) != 4:
        return False
    B, _, W, D = shape
    return (B % 8 == 0 and W % 8 == 0 and D % 128 == 0
            and _pick_wb(W, B, n_ops=2) is not None)


def _pick_wb(W: int, B: int, n_ops: int):
    """The JAX w-tile search (l2_normalize.py:192-202): the largest multiple
    of 8 dividing W with (wb * B) rows under the 2048 (forward) or 1024
    (backward) row budget; None when there is none."""
    budget_rows = 2048 if n_ops == 1 else 1024
    wb = min(budget_rows // B, W) // 8 * 8
    while wb >= 8:
        if W % wb == 0:
            return wb
        wb -= 8
    return None


def _fwd_cuda(x):
    y = torch.empty_like(x)
    if x.shape[0] == 0:
        return y
    _lib.require(x.data_ptr() % 16 == 0, "l2_normalize: x must be 16-byte "
                 "aligned")
    code = _lib.library().rc_l2_normalize_fwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
        x.shape[0], x.shape[1], _lib.stream_of(x))
    _lib.check(code, "l2_normalize[fwd]")
    return y


def _bwd_cuda(x, g):
    dx = torch.empty_like(x)
    if x.shape[0] == 0:
        return dx
    _lib.require(x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0,
                 "l2_normalize backward: x and g must be 16-byte aligned")
    code = _lib.library().rc_l2_normalize_bwd(
        x.data_ptr(), g.data_ptr(), int(x.dtype == torch.bfloat16),
        dx.data_ptr(), x.shape[0], x.shape[1], _lib.stream_of(x))
    _lib.check(code, "l2_normalize[bwd]")
    return dx


l2_normalize_op = _lib.define_op(
    "l2_normalize(Tensor x) -> Tensor", _fwd_cuda, l2_normalize_plain,
    torch.empty_like)
l2_normalize_backward_op = _lib.define_op(
    "l2_normalize_backward(Tensor x, Tensor grad) -> Tensor", _bwd_cuda,
    l2_normalize_backward_plain, lambda x, g: torch.empty_like(x))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _backward(ctx, grad):
    (x,) = ctx.saved_tensors
    return l2_normalize_backward_op(x, grad.to(x.dtype).contiguous())


torch.library.register_autograd("rangeclip::l2_normalize", _backward,
                                setup_context=_setup_context, lib=_lib.OPS)
