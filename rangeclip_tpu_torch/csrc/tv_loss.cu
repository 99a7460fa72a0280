// Total variation of a [B, H, W, D] field, f32 or bf16: mean |dh| + mean
// |dv| (forward) and its gradient (backward).
//
// Replaces rangeclip_tpu/ops/pallas/tv_loss.py: _fwd_kernel and _bwd_kernel,
// entry point fused_tv_loss.  Same semantics, which are not tv_rowtile's:
// the differences are taken in f32 after widening x (tv_loss.py:36-47), and
// the backward's slope is sign(.) with sign(0) = 0 (tv_loss.py:60, 69).
// Backward rounding as the TPU kernel's in-tile rows (tv_loss.py:61-73): the
// horizontal term (sign(x - left) - sign(right - x)) * scale_h and the
// vertical term, each exact in f32 and rounded once to x's dtype, then
// added in x's dtype.  The plain version (ops/kernels/tv_loss.py) rounds
// at the same points, so the backward is bit-equal to it; the TPU kernel's
// tile-seam and chunk-seam rows round a third time and may differ from
// both by one ulp of x's dtype.
//
// Bound on the card: bytes.  The forward reads the field once (0.54 GB for
// bf16 [32, 128, 128, 512]), the backward reads it once and writes the
// gradient once.  Both kernels are band stencils on band_ring.cuh's ring
// of row slabs, as tv_rowtile.cu's are: a block streams a band of 32 rows x
// 32 columns x 8 pieces (64 bf16 or 32 f32 channels) down the image, every
// neighbour is read from shared memory, and each byte of x crosses device
// memory once plus its halo.  A thread owns one column x one piece and
// carries its row (and, backward, its slope to the row above) in registers
// from the step before.  Ragged W-tiles, bands and channel chunks leave
// threads idle; a zero-filled piece is never a neighbour, since a slope or
// a difference is taken only where both pixels exist.
//
// Forward: right and lower neighbours (rows h0 .. h1 of the ring, one halo
// column on the right); |a - b| of the f32 differences summed in f32 in
// registers, one (sum |dh|, sum |dv|) pair per block.  The same entry point
// launches band_ring.cuh's one-block value kernel, which sums the partials
// in block order (two calls are bit-equal) and writes sum_h / pairs_h +
// sum_v / pairs_v with f32 true division (tv_loss.py:168-170).
//
// Backward: every neighbour (rows h0-1 .. h1, a halo column on each side);
// each slope is the sign of an f32 difference taken by two comparisons,
// border slopes masked to 0.  The scales are the upstream gradient (an f32
// scalar on the device) over each direction's pair count, f32 true
// division in the kernel (tv_loss.py:187-188).  In bf16, where both lie
// within 2^-100 .. 2^100 (any real loss), an element's two rounded terms
// and their sum are one product and one FMA of the scales rounded to bf16
// (ElementGrad) instead of two products, three roundings and an add: 0.39
// against 0.43 ms at [32, 128, 128, 512] on an H100.  In f32 the rounding
// is the identity and the general path is as fast.  dx leaves in 16-byte
// stores.
//
// The TPU kernel's row tiles, column chunks and seam passes have no purpose
// here.  Requires D % 8 == 0 and 16-byte aligned rows.

#include <type_traits>

#include "band_ring.cuh"

namespace {

using rc::band::Band;
using rc::band::band_blocks;
using rc::band::band_of;
using rc::band::kBlocks;
using rc::band::kGroups;
using rc::band::kPer;
using rc::band::kSlabs;
using rc::band::kSumThreads;
using rc::band::kThreads;
using rc::band::load_piece;
using rc::band::SlabRing;
using rc::band::valid_shape;

// sign(a - b) of two f32 (or widened bf16) values, sign(0) = 0, from two
// comparisons: without flush-to-zero a nonzero difference is never rounded
// to 0, so its sign is the comparisons' verdict (NaN: 0).
__device__ __forceinline__ float sign_diff(float a, float b) {
  return (a > b ? 1.f : 0.f) - (b > a ? 1.f : 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocks)
    tv_loss_fwd_kernel(const T* __restrict__ x, int H, int W, int D,
                       float* __restrict__ partials) {
  constexpr int P = kPer<T>;
  using Ring = SlabRing<T, 0, 0>;
  __shared__ __align__(16) unsigned char ring_mem[Ring::kBytes];
  const Band t = band_of<T>(H, W, D);
  Ring ring(ring_mem, x, t, H, W, D);
  const int tid = threadIdx.x;
  for (int i = 0; i < kSlabs - 1; ++i) ring.copy_row(t.h0 + i);

  // this thread: column j of the tile, piece tid % kGroups of the chunk
  const int j = tid / kGroups;
  const int w = t.w0 + j;
  const bool active = w < W && (t.g0 + tid % kGroups) * P < D;
  const bool has_r = w < W - 1;
  const int at = j * kGroups + tid % kGroups;  // piece in a slab
  float cur[P];  // row h, widened
  T v[P];        // a neighbour
  float sh = 0.f, sv = 0.f;
  for (int h = t.h0; h < t.h1; ++h) {
    // rows <= h+1 landed; later ones in flight
    rc::tc::cp_async_wait<kSlabs - 3>();
    __syncthreads();                // ... for every thread; row h-1 is free
    ring.copy_row(h + kSlabs - 1);  // into row h-1's slot
    if (!active) continue;
    if (h == t.h0) {
      load_piece(ring.at(h, at), v);
#pragma unroll
      for (int i = 0; i < P; ++i) cur[i] = rc::to_float(v[i]);
    }
    if (has_r) {
      load_piece(ring.at(h, at + kGroups), v);
#pragma unroll
      for (int i = 0; i < P; ++i) sh += fabsf(rc::to_float(v[i]) - cur[i]);
    }
    if (h < H - 1) {
      load_piece(ring.at(h + 1, at), v);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float below = rc::to_float(v[i]);
        sv += fabsf(below - cur[i]);
        cur[i] = below;
      }
    }
  }
  rc::band::write_partials(sh, sv, 1.f, partials);
}

// The gradient of one element from its slopes d_h = sign(x - left) -
// sign(right - x) and d_v = sign(x - up) - sign(down - x), each in -2..2:
// (d_h * scale_h) and (d_v * scale_v) each exact in f32 and rounded to T,
// then added and rounded to T (tv_loss.py:61-73).  kPrerounded (bf16
// only): both scales lie within 2^-100 .. 2^100 and are given rounded to
// T; then rounding commutes with the exact products d * scale (d = 0, +-1,
// +-2: no underflow, no overflow), which are exact in T, and their f32 sum
// is one FMA: the same values with fewer instructions.
template <typename T, bool kPrerounded>
struct ElementGrad {
  float scale_h, scale_v;

  __device__ __forceinline__ T operator()(float d_h, float d_v) const {
    if (kPrerounded)
      return rc::round_to(__fmaf_rn(d_v, scale_v, __fmul_rn(d_h, scale_h)),
                          T());
    const T th = rc::round_to(__fmul_rn(d_h, scale_h), T());
    const T tv = rc::round_to(__fmul_rn(d_v, scale_v), T());
    return rc::round_to(__fadd_rn(rc::to_float(th), rc::to_float(tv)), T());
  }
};

// The backward's band, streamed with `grad_of` forming each element.
template <typename T, typename Ring, typename Grad>
__device__ __forceinline__ void bwd_band(Ring& ring, const Band& t, int H,
                                         int W, int D, const Grad& grad_of,
                                         T* __restrict__ dx) {
  constexpr int P = kPer<T>;
  const int tid = threadIdx.x;
  // this thread: column j of the tile, piece tid % kGroups of the chunk
  const int j = tid / kGroups;
  const int w = t.w0 + j;
  const int c = (t.g0 + tid % kGroups) * P;  // first channel
  const bool active = w < W && c < D;
  const bool has_l = w > 0;
  const bool has_r = w < W - 1;
  const int at = (j + 1) * kGroups + tid % kGroups;  // piece in a slab
  T* out_col = dx + (long long)t.b * H * W * D + (long long)w * D + c;
  float cur[P];  // row h, widened
  float su[P];   // sign(row h - row h-1): the previous row's sd
  T v[P];        // a neighbour
  for (int h = t.h0; h < t.h1; ++h) {
    // rows <= h+1 landed; later ones in flight
    rc::tc::cp_async_wait<kSlabs - 4>();
    __syncthreads();                // ... for every thread; row h-2 is free
    ring.copy_row(h + kSlabs - 2);  // into row h-2's slot
    if (!active) continue;
    if (h == t.h0) {
      load_piece(ring.at(h, at), v);
#pragma unroll
      for (int i = 0; i < P; ++i) cur[i] = rc::to_float(v[i]);
      if (h > 0) load_piece(ring.at(h - 1, at), v);
#pragma unroll
      for (int i = 0; i < P; ++i)
        su[i] = h > 0 ? sign_diff(cur[i], rc::to_float(v[i])) : 0.f;
    }
    float d_h[P];  // sign(x - left) + sign(x - right)
#pragma unroll
    for (int i = 0; i < P; ++i) d_h[i] = 0.f;
    if (has_l) {
      load_piece(ring.at(h, at - kGroups), v);
#pragma unroll
      for (int i = 0; i < P; ++i)
        d_h[i] = sign_diff(cur[i], rc::to_float(v[i]));
    }
    if (has_r) {
      load_piece(ring.at(h, at + kGroups), v);
#pragma unroll
      for (int i = 0; i < P; ++i)
        d_h[i] += sign_diff(cur[i], rc::to_float(v[i]));
    }
    const bool has_d = h < H - 1;
    if (has_d) load_piece(ring.at(h + 1, at), v);
    T out[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float below = rc::to_float(v[i]);
      const float sd = has_d ? sign_diff(below, cur[i]) : 0.f;
      out[i] = grad_of(d_h[i], su[i] - sd);
      su[i] = sd;
      cur[i] = below;
    }
    rc::band::store_piece(out_col + (long long)h * W * D, out);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocks)
    tv_loss_bwd_kernel(const T* __restrict__ x, int H, int W, int D,
                       const float* __restrict__ grad, float pairs_h,
                       float pairs_v, T* __restrict__ dx) {
  using Ring = SlabRing<T, 1, 1>;
  __shared__ __align__(16) unsigned char ring_mem[Ring::kBytes];
  const Band t = band_of<T>(H, W, D);
  Ring ring(ring_mem, x, t, H, W, D);
  for (int i = 0; i < kSlabs - 1; ++i) ring.copy_row(t.h0 - 1 + i);
  const float scale_h = __fdiv_rn(*grad, pairs_h);
  const float scale_v = __fdiv_rn(*grad, pairs_v);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const auto in_range = [](float s) {
      return fabsf(s) > 0x1p-100f && fabsf(s) < 0x1p100f;
    };
    if (in_range(scale_h) && in_range(scale_v)) {  // the same in every block
      const ElementGrad<T, true> grad_of{
          rc::to_float(rc::round_to(scale_h, T())),
          rc::to_float(rc::round_to(scale_v, T()))};
      bwd_band(ring, t, H, W, D, grad_of, dx);
      return;
    }
  }
  bwd_band(ring, t, H, W, D, ElementGrad<T, false>{scale_h, scale_v}, dx);
}

template <typename T>
int launch_fwd(const void* x, int B, int H, int W, int D, float* partials,
               float pairs_h, float pairs_v, float* out, cudaStream_t st) {
  if (!valid_shape<T>(B, H, W, D)) return cudaErrorInvalidValue;
  const long long blocks = band_blocks<T>(B, H, W, D);
  tv_loss_fwd_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), H, W, D, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rc::band::tv_fwd_value_kernel<<<1, kSumThreads, 0, st>>>(
      partials, (int)blocks, pairs_h, pairs_v, 1.f, 1.f, out);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, int B, int H, int W, int D, const float* grad,
               float pairs_h, float pairs_v, void* dx, cudaStream_t st) {
  if (!valid_shape<T>(B, H, W, D)) return cudaErrorInvalidValue;
  tv_loss_bwd_kernel<T><<<(unsigned)band_blocks<T>(B, H, W, D), kThreads, 0,
                          st>>>(static_cast<const T*>(x), H, W, D, grad,
                                pairs_h, pairs_v, static_cast<T*>(dx));
  return cudaGetLastError();
}

}  // namespace

// x: [B, H, W, D] f32 (is_bf16 == 0) or bf16, 16-byte aligned; partials:
// rc_tv_loss_fwd_partials(is_bf16, B, H, W, D) f32 of scratch (per block:
// sum |dh|, sum |dv|, differences in f32); pairs_h, pairs_v: each
// direction's pair count at the true width; out: [1] f32, sum_h / pairs_h
// + sum_v / pairs_v.  Two launches, the band kernel and the one-block sum,
// on the stream.  Any B, H, W >= 1 and D % 8 == 0 with fewer than 2^31
// blocks.
extern "C" int rc_tv_loss_fwd(const void* x, int is_bf16, int B, int H,
                              int W, int D, float* partials, float pairs_h,
                              float pairs_v, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(x, B, H, W, D, partials,
                                             pairs_h, pairs_v, out, st)
                 : launch_fwd<float>(x, B, H, W, D, partials, pairs_h,
                                     pairs_v, out, st);
}

// Floats of the forward's partials at (is_bf16, B, H, W, D): two per block
// (0 for a shape the kernels refuse).
extern "C" long long rc_tv_loss_fwd_partials(int is_bf16, int B, int H,
                                             int W, int D) {
  if (is_bf16)
    return valid_shape<__nv_bfloat16>(B, H, W, D)
               ? 2 * band_blocks<__nv_bfloat16>(B, H, W, D)
               : 0;
  return valid_shape<float>(B, H, W, D) ? 2 * band_blocks<float>(B, H, W, D)
                                        : 0;
}

// grad: the upstream gradient, an f32 scalar on the device; pairs_h,
// pairs_v: as the forward's; (scale_h, scale_v) = grad / pairs in f32.
// dx: [B, H, W, D] in x's dtype.  Shapes as the forward's.
extern "C" int rc_tv_loss_bwd(const void* x, int is_bf16, int B, int H,
                              int W, int D, const float* grad, float pairs_h,
                              float pairs_v, void* dx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, B, H, W, D, grad, pairs_h,
                                             pairs_v, dx, st)
                 : launch_bwd<float>(x, B, H, W, D, grad, pairs_h, pairs_v,
                                     dx, st);
}
