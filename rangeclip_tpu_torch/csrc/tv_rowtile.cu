// Total variation of a bf16 [B, H, W, D] field: weighted sums of |dh| and
// |dv| (forward) and the gradient of the scaled sums (backward).
//
// Replaces rangeclip_tpu/ops/pallas/tv_rowtile.py: _fwd_kernel and
// _bwd_kernel, entry point tv_rowtile.  Same semantics: differences in the
// input dtype (a bf16 x[q] - x[q+1] is rounded to bf16 before |.| and before
// its sign), |.| summed in f32, a per-image 0/1 weight, and the slope
// u >= 0 ? +1 : -1 (+1 at ties) in the backward, whose combine
// gh * (sh_r - sh_l) + gv * (sv_d - sv_u) has its brackets in bf16 (exact:
// values in -2..2) and the f32 scalars outside, rounded once (RNE) to bf16.
// Both products are exact, so the backward is bit-equal to the plain
// version; the forward differs from it by the f32 summation order only.
//
// Bound on the card: bytes.  The forward reads the field once (0.54 GB at
// 32 x 128 x 128 x 512) and the backward reads it once and writes the
// gradient once (1.07 GB).
//
// Forward: the backward's band, one streaming pass.  A block owns a band of
// 32 image rows x 32 pixel columns x 64 channels and streams its rows down
// the image through a shared-memory ring of six row slabs (cp.async,
// 16-byte pieces), rows h+2 .. h+5 in flight while row h is summed.  The
// forward pairs a pixel with its right-hand and lower neighbours only, so
// a slab holds the band's 32 columns and one halo column on the right, and
// the ring takes one halo row below the band: every byte of the field is
// read once, plus 1/32 for each halo.  Each thread owns one column x 8
// channels, carries its row in registers from the step before (the row
// below becomes the next row) and reads its two neighbours from shared
// memory; differences are rounded to bf16 and summed as |.| in f32 in
// registers.  Zero-filled pieces (past W or D) belong to idle threads and
// are never a right-hand neighbour: a column's right pair exists only
// where w + 1 < W.  One (sum |dh| * w, sum |dv| * w) pair leaves each block;
// a one-block kernel launched by the same entry point sums the partials in
// block order (two calls are bit-equal) and forms the TV value with the
// f32 arithmetic of tv_rowtile.py's scale_sums: true division by each
// direction's pair count, the upsample factor, the add.  The grid is
// one-dimensional, so the forward takes any B * H.
//
// Backward: a block owns a band of 32 image rows x 32 pixel columns x 64
// channels and streams it down the image through a shared-memory ring of
// six row slabs (cp.async, 16-byte pieces, the column on each side
// included), rows h+2 .. h+4 in flight while row h is computed.  Every
// neighbour comes from shared memory, so x crosses device memory once plus
// the halo (2 of 32 columns, and a row above and below each band), and dx
// leaves in 16-byte stores, 128 contiguous bytes per pixel.  The row at h
// and its slope to the row above are carried in registers from the step
// before, and slopes are taken as signs of f32 differences (equal to the
// signs of the bf16-rounded ones), so a row costs about 20 instructions a
// channel: the kernel's bytes, not its arithmetic, set its pace.  Border
// slopes are masked (never zero-padded: slope(x, 0) is not 0); ragged
// bands, W-tiles and channel chunks (D % 64 != 0) leave threads idle.  The
// grid is one-dimensional, so the backward takes any B * H.
//
// The band, its ring of row slabs and the one-block value kernel are
// band_ring.cuh's, shared with tv_loss.cu.  The TPU kernel's VMEM tile
// search has no purpose here.  Requires D % 8 == 0 and 16-byte aligned
// rows.

#include "band_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The difference a - b rounded to bf16, widened back to f32.
__device__ __forceinline__ float diff_bf16(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(a - b));
}

// The backward's slope of two widened bf16 values: +1 where the bf16
// difference a - b is >= 0, else -1, taken without the bf16 rounding: a
// nonzero difference of two bf16 values is a multiple of 2^-133, the
// smallest bf16 subnormal, so neither its f32 nor its bf16 rounding reaches
// zero or changes its sign (a - a is +0 in both; inf - inf NaN in both).
__device__ __forceinline__ float sign_of_diff(float a, float b) {
  return a - b >= 0.f ? 1.f : -1.f;
}

// the band, its ring and the value kernel: band_ring.cuh
using rc::band::Band;
using rc::band::band_blocks;
using rc::band::band_of;
using rc::band::kBlocks;
using rc::band::kGroups;
using rc::band::kSlabs;
using rc::band::kSumThreads;
using rc::band::kThreads;
using rc::band::SlabRing;
using rc::band::valid_shape;

// ---- forward: one streaming pass, then the value ---------------------------

__global__ void __launch_bounds__(kThreads, kBlocks)
    tv_fwd_kernel(const bf16* __restrict__ x, int H, int W, int D,
                  const float* __restrict__ weight,
                  float* __restrict__ partials) {
  using Ring = SlabRing<bf16, 0, 0>;
  __shared__ __align__(16) unsigned char ring_mem[Ring::kBytes];
  const Band t = band_of<bf16>(H, W, D);
  Ring ring(ring_mem, x, t, H, W, D);
  const int tid = threadIdx.x;
  for (int i = 0; i < kSlabs - 1; ++i) ring.copy_row(t.h0 + i);

  // this thread: column j of the tile, channel group tid % kGroups
  const int j = tid / kGroups;
  const int w = t.w0 + j;
  const bool active = w < W && (t.g0 + tid % kGroups) * 8 < D;
  const bool has_r = w < W - 1;
  const int at = j * kGroups + tid % kGroups;  // piece in a slab
  float cur[8];  // row h, widened
  float sh = 0.f, sv = 0.f;
  bf16 v[8];
  for (int h = t.h0; h < t.h1; ++h) {
    // rows <= h+1 landed; later ones in flight
    rc::tc::cp_async_wait<kSlabs - 3>();
    __syncthreads();             // ... for every thread; row h-1 is free
    ring.copy_row(h + kSlabs - 1);  // into row h-1's slot
    if (!active) continue;
    if (h == t.h0) {
      rc::load8(ring.at(h, at), v);
#pragma unroll
      for (int i = 0; i < 8; ++i) cur[i] = __bfloat162float(v[i]);
    }
    if (has_r) {
      rc::load8(ring.at(h, at + kGroups), v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sh += fabsf(diff_bf16(cur[i], __bfloat162float(v[i])));
    }
    if (h < H - 1) {
      rc::load8(ring.at(h + 1, at), v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float below = __bfloat162float(v[i]);
        sv += fabsf(diff_bf16(cur[i], below));
        cur[i] = below;
      }
    }
  }
  rc::band::write_partials(sh, sv, weight != nullptr ? weight[t.b] : 1.f,
                           partials);
}

// ---- backward: a shared-memory halo stencil --------------------------------

__global__ void __launch_bounds__(kThreads, kBlocks)
    tv_bwd_kernel(const bf16* __restrict__ x, int H, int W, int D,
                  const float* __restrict__ weight,
                  const float* __restrict__ grad, float pairs_h,
                  float pairs_v, float rescale_h, float rescale_v,
                  bf16* __restrict__ dx) {
  using Ring = SlabRing<bf16, 1, 1>;
  __shared__ __align__(16) unsigned char ring_mem[Ring::kBytes];
  const Band t = band_of<bf16>(H, W, D);
  Ring ring(ring_mem, x, t, H, W, D);
  const int tid = threadIdx.x;
  const long long row = (long long)W * D;  // elements per image row
  const long long image = (long long)t.b * H * row;
  for (int i = 0; i < kSlabs - 1; ++i) ring.copy_row(t.h0 - 1 + i);

  // this thread: column j of the tile, channel group gi of the chunk
  const int j = tid / kGroups;
  const int w = t.w0 + j;
  const bool active = w < W && (t.g0 + tid % kGroups) * 8 < D;
  const bool has_l = w > 0;
  const bool has_r = w < W - 1;
  const int at = (j + 1) * kGroups + tid % kGroups;  // piece in a slab
  // (gh, gv) as the wrapper's pair_grads forms them (f32 true division,
  // then the rescale), times the image's weight
  const float wt = weight != nullptr ? weight[t.b] : 1.f;
  const float gh =
      __fmul_rn(__fmul_rn(__fdiv_rn(*grad, pairs_h), rescale_h), wt);
  const float gv =
      __fmul_rn(__fmul_rn(__fdiv_rn(*grad, pairs_v), rescale_v), wt);
  float cur[8];  // row h, widened
  float sv_u[8];  // slope(row h-1, row h): the previous row's sv_d
  bf16 v[8], out[8];
  for (int h = t.h0; h < t.h1; ++h) {
    // rows <= h+1 landed; later ones in flight
    rc::tc::cp_async_wait<kSlabs - 4>();
    __syncthreads();              // ... for every thread; row h-2 is free
    ring.copy_row(h + kSlabs - 2);  // into row h-2's slot
    if (!active) continue;
    if (h == t.h0) {
      rc::load8(ring.at(h, at), v);
#pragma unroll
      for (int i = 0; i < 8; ++i) cur[i] = __bfloat162float(v[i]);
      if (h > 0) rc::load8(ring.at(h - 1, at), v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sv_u[i] = h > 0 ? sign_of_diff(__bfloat162float(v[i]), cur[i]) : 0.f;
    }
    float sh[8];  // sh_r - sh_l
    if (has_r) rc::load8(ring.at(h, at + kGroups), v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      sh[i] = has_r ? sign_of_diff(cur[i], __bfloat162float(v[i])) : 0.f;
    if (has_l) rc::load8(ring.at(h, at - kGroups), v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      sh[i] -= has_l ? sign_of_diff(__bfloat162float(v[i]), cur[i]) : 0.f;
    const bool has_d = h < H - 1;
    if (has_d) rc::load8(ring.at(h + 1, at), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float below = __bfloat162float(v[i]);
      const float sv_d = has_d ? sign_of_diff(cur[i], below) : 0.f;
      out[i] = __float2bfloat16_rn(
          __fadd_rn(__fmul_rn(gh, sh[i]), __fmul_rn(gv, sv_d - sv_u[i])));
      sv_u[i] = sv_d;
      cur[i] = below;
    }
    rc::store8(dx + image + h * row + (long long)w * D +
                   (t.g0 + tid % kGroups) * 8,
               out);
  }
}

}  // namespace

// x: [B, H, W, D] bf16, 16-byte aligned; weight: [B] f32 or NULL (all 1);
// partials: rc_tv_rowtile_fwd_partials(B, H, W, D) f32 of scratch (per
// block: sum |dh| * weight, sum |dv| * weight); pairs_h, pairs_v, rescale_h,
// rescale_v: as the backward's; out: [1] f32, the TV value
// tv_h / pairs_h * rescale_h + tv_v / pairs_v * rescale_v.  Two launches,
// the band kernel and the one-block sum, on the stream.  Any B, H, W >= 1
// and D % 8 == 0 with fewer than 2^31 blocks.
extern "C" int rc_tv_rowtile_fwd(const void* x, int B, int H, int W, int D,
                                 const float* weight, float* partials,
                                 float pairs_h, float pairs_v,
                                 float rescale_h, float rescale_v,
                                 float* out, void* stream) {
  if (!valid_shape<bf16>(B, H, W, D)) return cudaErrorInvalidValue;
  const long long blocks = band_blocks<bf16>(B, H, W, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tv_fwd_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), H, W, D, weight, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rc::band::tv_fwd_value_kernel<<<1, kSumThreads, 0, st>>>(
      partials, (int)blocks, pairs_h, pairs_v, rescale_h, rescale_v, out);
  return cudaGetLastError();
}

// Floats of the forward's partials at (B, H, W, D): two per block (0 for
// a shape the kernels refuse).
extern "C" long long rc_tv_rowtile_fwd_partials(int B, int H, int W, int D) {
  return valid_shape<bf16>(B, H, W, D) ? 2 * band_blocks<bf16>(B, H, W, D)
                                        : 0;
}

// grad: the upstream gradient, an f32 scalar on the device; pairs_h,
// pairs_v: each direction's pair count; rescale_h, rescale_v: the upsample
// rescales (1 at upsample 1); (gh, gv) = grad / pairs * rescale in f32, as
// tv_rowtile.py's pair_grads.  dx: [B, H, W, D] bf16.  Shapes as the
// forward's.
extern "C" int rc_tv_rowtile_bwd(const void* x, int B, int H, int W, int D,
                                 const float* weight, const float* grad,
                                 float pairs_h, float pairs_v,
                                 float rescale_h, float rescale_v, void* dx,
                                 void* stream) {
  if (!valid_shape<bf16>(B, H, W, D)) return cudaErrorInvalidValue;
  tv_bwd_kernel<<<(unsigned)band_blocks<bf16>(B, H, W, D), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), H, W, D, weight, grad, pairs_h, pairs_v,
      rescale_h, rescale_v, static_cast<bf16*>(dx));
  return cudaGetLastError();
}
