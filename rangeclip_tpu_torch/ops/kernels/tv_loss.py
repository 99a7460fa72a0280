"""Total-variation loss mean|dh| + mean|dv| of a [B, H, W, D] field, with
its gradient.

Port of ``rangeclip_tpu/ops/pallas/tv_loss.py`` (``fused_tv_loss``, a
``jax.custom_vjp``), the opt-in TV loss.  Its semantics are not
``tv_rowtile``'s: the differences are taken in f32 after widening x, and
the backward's slope is sign(.) with sign(0) = 0, where
``losses/smoothness`` takes the differences in x's dtype and gives +1 at
ties.  ``tile_r`` and ``interpret`` are the TPU kernel's row-tile and
interpret knobs and have no counterpart here: the function takes x only.

The CUDA kernels are ``csrc/tv_loss.cu``, band stencils on
``csrc/band_ring.cuh``'s shared-memory ring of row slabs (as
``tv_rowtile``'s are) with a one-dimensional grid, so any B * H runs that
makes fewer than 2^31 blocks (:func:`band_blocks`); the pair is the
operator ``rangeclip::tv_loss`` with ``rangeclip::tv_loss_backward``
registered as its gradient.  Each is one C entry point that does all of
its device work: the forward sums its per-block partials in a fixed order
and writes the value with :func:`combine`'s f32 arithmetic, the backward
forms :func:`scales`' quotients from the upstream gradient on the device.
:func:`tv_loss_value` and :func:`tv_loss_grad` are the plain versions (a
``torch.autograd.Function`` for CPU tensors, and the reference the kernels
are held against on the card): the forward differs from the kernel by the
f32 summation order (rtol 1e-5), the backward is bit-equal.
The backward rounds the horizontal and the vertical term each to x's
dtype and adds them in x's dtype, as the TPU kernel's in-tile rows do; its
tile-seam and column-chunk-seam rows round a third time, so JAX may differ
there by one ulp of x's dtype.  The kernels take D % 8 == 0; the wrapper
zero-pads any other D (``_lib.pad_dim8``) and hands the operators the true
D: zero columns add no difference, the means divide by the true pair
counts (the plain versions' ``dim``), and the gradient comes back sliced
through the pad's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rangeclip_tpu_torch.ops.kernels import _lib

# csrc/band_ring.cuh: a band is kBand rows x kPixels columns x kGroups
# 16-byte pieces (8 bf16 or 4 f32 channels each)
_BAND, _PIXELS, _GROUPS = 32, 32, 8


def band_blocks(shape, dtype) -> int:
    """Blocks of the kernels' grid (csrc/band_ring.cuh ``band_blocks``) for a
    [B, H, W, D] field of ``dtype`` with D % 8 == 0; the forward writes two
    partials per block."""
    B, H, W, D = shape
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return (B * -(-H // _BAND) * -(-(D // per) // _GROUPS)
            * -(-W // _PIXELS))


def pair_counts(shape, dim=None):
    """(B H (W-1) D, B (H-1) W D): the pairs in each direction, at D =
    ``dim`` where given (a field zero-padded past its true width)."""
    B, H, W, D = shape
    D = D if dim is None else dim
    return float(B * H * (W - 1) * D), float(B * (H - 1) * W * D)


def scales(g: torch.Tensor, shape, dim=None) -> torch.Tensor:
    """[2] f32 (scale_h, scale_v): the upstream gradient over each
    direction's pair count (tv_loss.py:187-188), divided by device tensors
    (true division, as JAX does)."""
    g = g.float()
    count_h, count_v = pair_counts(shape, dim)
    return torch.stack([g / g.new_tensor(count_h), g / g.new_tensor(count_v)])


def combine(s_h: torch.Tensor, s_v: torch.Tensor, shape,
            dim=None) -> torch.Tensor:
    """sum |dh|, sum |dv| -> mean |dh| + mean |dv| (tv_loss.py:168-170)."""
    count_h, count_v = pair_counts(shape, dim)
    return s_h / s_h.new_tensor(count_h) + s_v / s_v.new_tensor(count_v)


def tv_loss_value(x: torch.Tensor, dim=None) -> torch.Tensor:
    """mean |dh| + mean |dv| with the differences in f32; the means over
    ``dim`` channels where given (x zero-padded past them)."""
    xf = x.float()
    s_h = (xf[:, :, 1:] - xf[:, :, :-1]).abs().sum()
    s_v = (xf[:, 1:] - xf[:, :-1]).abs().sum()
    return combine(s_h, s_v, x.shape, dim)


def tv_loss_grad(x: torch.Tensor, g: torch.Tensor, dim=None) -> torch.Tensor:
    """The VJP (tv_loss.py:55-73): (sign(x - left) - sign(right - x))
    * scale_h and the same vertically, each exact in f32 and rounded to x's
    dtype, then added in x's dtype; sign(0) = 0.  ``dim`` as in
    :func:`tv_loss_value`."""
    scale_h, scale_v = scales(g, x.shape, dim)
    xf = x.float()
    sh = torch.sign(xf[:, :, 1:] - xf[:, :, :-1])
    sv = torch.sign(xf[:, 1:] - xf[:, :-1])
    d_h = F.pad(sh, (0, 0, 1, 0)) - F.pad(sh, (0, 0, 0, 1))
    d_v = F.pad(sv, (0, 0, 0, 0, 1, 0)) - F.pad(sv, (0, 0, 0, 0, 0, 1))
    return (d_h * scale_h).to(x.dtype) + (d_v * scale_v).to(x.dtype)


class _TVLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return tv_loss_value(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return tv_loss_grad(x, g)


def fused_tv_loss(x: torch.Tensor) -> torch.Tensor:
    """mean|dh| + mean|dv| of a [B, H, W, D] field (model.py:329-334),
    differentiable.  CUDA tensors run the kernels (f32 or bf16, contiguous;
    D zero-padded to a multiple of 8); CPU tensors the plain versions."""
    kind = _lib.require_device("tv_loss", x)
    _lib.require(x.dim() == 4, "tv_loss: x must be [B, H, W, D]")
    if kind == "cpu":
        return _TVLoss.apply(x)
    B, H, W, D = x.shape
    _lib.require(x.dtype in (torch.float32, torch.bfloat16)
                 and x.is_contiguous() and D >= 1
                 and band_blocks((B, H, W, D + -D % 8), x.dtype) < 2 ** 31,
                 "tv_loss: the kernel takes a contiguous f32 or bf16 "
                 f"[B, H, W, D] field, got {x.dtype} {tuple(x.shape)}")
    return tv_loss_op(_lib.pad_dim8(x), D)


def _fwd_cuda(x, dim):
    _lib.require(x.data_ptr() % 16 == 0, "tv_loss: x must be 16-byte aligned")
    B, H, W, D = x.shape
    is_bf16 = int(x.dtype == torch.bfloat16)
    # one entry point: the band kernel's per-block partials, then their sum
    # in block order and combine's f32 arithmetic on the device
    lib = _lib.library()
    partials = torch.empty(lib.rc_tv_loss_fwd_partials(is_bf16, B, H, W, D),
                           dtype=torch.float32, device=x.device)
    value = torch.empty((), dtype=torch.float32, device=x.device)
    code = lib.rc_tv_loss_fwd(
        x.data_ptr(), is_bf16, B, H, W, D, partials.data_ptr(),
        *pair_counts(x.shape, dim), value.data_ptr(), _lib.stream_of(x))
    _lib.check(code, "tv_loss[fwd]")
    return value


def _bwd_cuda(x, grad, dim):
    B, H, W, D = x.shape
    _lib.require(x.data_ptr() % 16 == 0, "tv_loss: x must be 16-byte aligned")
    # the kernel forms scales' f32 quotients itself, from the upstream
    # gradient on the device: no small launches, no copies
    grad = grad.float().contiguous()
    dx = torch.empty_like(x)
    code = _lib.library().rc_tv_loss_bwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), B, H, W, D,
        grad.data_ptr(), *pair_counts(x.shape, dim), dx.data_ptr(),
        _lib.stream_of(x))
    _lib.check(code, "tv_loss[bwd]")
    return dx


# x: [B, H, W, D8] (D8 % 8 == 0); dim: the true D <= D8 the means count
tv_loss_op = _lib.define_op(
    "tv_loss(Tensor x, int dim) -> Tensor", _fwd_cuda, None,
    lambda x, dim: x.new_empty((), dtype=torch.float32))
tv_loss_backward_op = _lib.define_op(
    "tv_loss_backward(Tensor x, Tensor grad, int dim) -> Tensor", _bwd_cuda,
    None, lambda x, grad, dim: torch.empty_like(x))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])
    ctx.dim = inputs[1]


def _backward(ctx, grad):
    (x,) = ctx.saved_tensors
    return tv_loss_backward_op(x, grad.float(), ctx.dim), None


torch.library.register_autograd("rangeclip::tv_loss", _backward,
                                setup_context=_setup_context, lib=_lib.OPS)
