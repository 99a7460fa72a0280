"""Total-variation smoothness of a bf16 field, forward and backward.

Port of ``rangeclip_tpu/ops/pallas/tv_rowtile.py`` (``tv_rowtile``, a
``jax.custom_vjp``): the value is ``TV(x * w)`` of the (0/1-sample-weighted)
field without the B / sum(w) rescale, which the caller applies.  The CUDA
kernels are ``csrc/tv_rowtile.cu``; the pair is the operator
``rangeclip::tv_rowtile`` with ``rangeclip::tv_rowtile_backward`` registered
as its gradient, which turns the upstream gradient into the per-direction
scalars with :func:`pair_grads`, as the plain VJP does.  Like the JAX
function it saves x (and the weights) as its only residuals.

The plain version is :func:`tv_plain` on ``x * w``: the formulation of
``losses/smoothness.py`` (``_tv``) with its hand-derived VJP, a
``torch.autograd.Function``.  The kernels' forward differs from it by the f32 summation
order, their backward is bit-equal to it (products of exact brackets and
f32 scalars, one RNE rounding; the TPU's one-ulp difference was Mosaic's
cast).  CPU tensors go to the plain version; the operators have no CPU
implementation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from rangeclip_tpu_torch.ops.kernels import _lib

_THREADS = 256  # csrc/tv_rowtile.cu kThreads
_ROWS = 8  # csrc/tv_rowtile.cu kRows
_BWD_TILE_BYTES = 1024 * 1024  # the JAX gate's VMEM budget


def kernel_applicable(shape, dtype) -> bool:
    """The JAX gate (tv_rowtile.py:83-97), kept so that dispatch matches JAX:
    bf16 4-D fields with W % 8 == 0, D % 128 == 0, at least one pair in each
    direction and one image row within the backward's 1 MB VMEM tile.  The
    CUDA kernel needs only D % 8 == 0; to be re-derived on the H100."""
    if len(shape) != 4:
        return False
    _, H, W, D = shape
    return (dtype == torch.bfloat16 and H >= 2 and W >= 2 and W % 8 == 0
            and D % 128 == 0 and W * D * 2 <= _BWD_TILE_BYTES)


def pair_grads(g: torch.Tensor, shape, upsample: int):
    """(gh, gv): the upstream gradient of the TV value over each direction's
    pair count, with the upsample rescale (smoothness.py:127-134).  f32
    tensor arithmetic on g's device, dividing by device tensors (true
    division, as JAX does; a Python divisor may become a reciprocal)."""
    B, H, W, D = shape
    g = g.float()
    gh = g / g.new_tensor(float(B * H * (W - 1) * D))
    gv = g / g.new_tensor(float(B * (H - 1) * W * D))
    if upsample > 1:
        gh = gh * g.new_tensor((W - 1) / (upsample * W - 1))
        gv = gv * g.new_tensor((H - 1) / (upsample * H - 1))
    return gh, gv


def scale_sums(s_h: torch.Tensor, s_v: torch.Tensor, shape,
               upsample: int) -> torch.Tensor:
    """sum |dh|, sum |dv| -> the TV value (tv_rowtile.py:181-188)."""
    B, H, W, D = shape
    tv_h = s_h / s_h.new_tensor(float(B * H * (W - 1) * D))
    tv_v = s_v / s_v.new_tensor(float(B * (H - 1) * W * D))
    if upsample > 1:
        tv_h = tv_h * s_h.new_tensor((W - 1) / (upsample * W - 1))
        tv_v = tv_v * s_v.new_tensor((H - 1) / (upsample * H - 1))
    return tv_h + tv_v


def tv_value(x: torch.Tensor, upsample: int) -> torch.Tensor:
    """mean |dh| + mean |dv| of [B, H, W, D], the differences in x's dtype,
    the means in f32, with the upsample pair-count rescale
    (smoothness.py:106-115)."""
    tv_h = (x[:, :, :-1] - x[:, :, 1:]).abs().mean(dtype=torch.float32)
    tv_v = (x[:, :-1] - x[:, 1:]).abs().mean(dtype=torch.float32)
    if upsample > 1:
        H, W = x.shape[1], x.shape[2]
        tv_h = tv_h * tv_h.new_tensor((W - 1) / (upsample * W - 1))
        tv_v = tv_v * tv_v.new_tensor((H - 1) / (upsample * H - 1))
    return tv_h + tv_v


def tv_grad(x: torch.Tensor, g: torch.Tensor, upsample: int) -> torch.Tensor:
    """The hand-derived VJP (smoothness.py:127-163): slopes u >= 0 ? 1 : -1
    of the differences in x's dtype (+1 at ties, where torch's abs backward
    gives 0), padded differences in x's dtype (exact), the f32 scalars
    outside, one rounding to x's dtype."""
    gh, gv = pair_grads(g, x.shape, upsample)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    sh = torch.where(x[:, :, :-1] - x[:, :, 1:] >= 0, one, -one)
    sv = torch.where(x[:, :-1] - x[:, 1:] >= 0, one, -one)
    d_h = F.pad(sh, (0, 0, 0, 1)) - F.pad(sh, (0, 0, 1, 0))
    d_v = F.pad(sv, (0, 0, 0, 0, 0, 1)) - F.pad(sv, (0, 0, 0, 0, 1, 0))
    return (gh * d_h.float() + gv * d_v.float()).to(x.dtype)


class _TV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, upsample):
        ctx.save_for_backward(x)
        ctx.upsample = upsample
        return tv_value(x, upsample)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return tv_grad(x, g, ctx.upsample), None


def tv_plain(x: torch.Tensor, upsample: int = 1) -> torch.Tensor:
    """TV of [B, H, W, D] with the hand-derived VJP (the JAX ``_tv``)."""
    return _TV.apply(x, int(upsample))


def tv_rowtile_plain(x: torch.Tensor, sample_weight: Optional[torch.Tensor],
                     upsample: int = 1) -> torch.Tensor:
    """TV(x * w) through the plain formulation and its VJP."""
    if sample_weight is not None:
        x = x * sample_weight.to(x.dtype)[:, None, None, None]
    return tv_plain(x, upsample)


def tv_rowtile(x: torch.Tensor, sample_weight: Optional[torch.Tensor] = None,
               upsample: int = 1) -> torch.Tensor:
    """TV of the 0/1-sample-weighted field [B, H, W, D] (bf16 for the
    kernel); ``sample_weight`` [B] is not differentiated.  CUDA tensors run
    the kernels, CPU tensors :func:`tv_rowtile_plain`."""
    tensors = (x,) if sample_weight is None else (x, sample_weight)
    kind = _lib.require_device("tv_rowtile", *tensors)
    _lib.require(x.dim() == 4, "tv_rowtile: x must be [B, H, W, D]")
    if kind == "cpu":
        return tv_rowtile_plain(x, sample_weight, upsample)
    B, H, W, D = x.shape
    _lib.require(x.dtype == torch.bfloat16 and x.is_contiguous()
                 and D % 8 == 0 and H >= 2 and W >= 2,
                 "tv_rowtile: the kernel takes a contiguous bf16 "
                 f"[B, H>=2, W>=2, D % 8 == 0] field, got {x.dtype} "
                 f"{tuple(x.shape)}")
    _lib.require(sample_weight is None
                 or tuple(sample_weight.shape) == (B,),
                 f"tv_rowtile: sample_weight must be [{B}]")
    w = (None if sample_weight is None
         else sample_weight.float().contiguous())
    return tv_rowtile_op(x, w, upsample)


def _n_blocks(B, H, W, D) -> int:
    col_blocks = -(-(W * (D // 8)) // _THREADS)
    return col_blocks * B * (-(-H // _ROWS))


def _fwd_cuda(x, weight, upsample):
    B, H, W, D = x.shape
    _lib.require(x.data_ptr() % 16 == 0, "tv_rowtile: x must be 16-byte "
                 "aligned")
    partials = torch.empty(_n_blocks(B, H, W, D), 2, dtype=torch.float32,
                           device=x.device)
    code = _lib.library().rc_tv_rowtile_fwd(
        x.data_ptr(), B, H, W, D,
        weight.data_ptr() if weight is not None else None,
        partials.data_ptr(), _lib.stream_of(x))
    _lib.check(code, "tv_rowtile[fwd]")
    sums = partials.sum(dim=0)
    return scale_sums(sums[0], sums[1], x.shape, upsample)


def _bwd_cuda(x, weight, grad, upsample):
    B, H, W, D = x.shape
    g = torch.stack(pair_grads(grad, x.shape, upsample)).contiguous()
    dx = torch.empty_like(x)
    code = _lib.library().rc_tv_rowtile_bwd(
        x.data_ptr(), B, H, W, D,
        weight.data_ptr() if weight is not None else None, g.data_ptr(),
        dx.data_ptr(), _lib.stream_of(x))
    _lib.check(code, "tv_rowtile[bwd]")
    return dx


tv_rowtile_op = _lib.define_op(
    "tv_rowtile(Tensor x, Tensor? weight, int upsample) -> Tensor",
    _fwd_cuda, None,
    lambda x, weight, upsample: x.new_empty((), dtype=torch.float32))
tv_rowtile_backward_op = _lib.define_op(
    "tv_rowtile_backward(Tensor x, Tensor? weight, Tensor grad, "
    "int upsample) -> Tensor",
    _bwd_cuda, None, lambda x, weight, grad, upsample: torch.empty_like(x))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], inputs[1])
    ctx.upsample = inputs[2]


def _backward(ctx, grad):
    x, weight = ctx.saved_tensors
    return (tv_rowtile_backward_op(x, weight, grad.float(), ctx.upsample),
            None, None)


torch.library.register_autograd("rangeclip::tv_rowtile", _backward,
                                setup_context=_setup_context, lib=_lib.OPS)
