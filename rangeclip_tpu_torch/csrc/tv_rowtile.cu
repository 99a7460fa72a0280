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
// gradient once (1.07 GB).  Each thread owns 8 channels (one 16-byte load)
// of one pixel column and walks down a tile of 8 image rows, keeping the
// rows above, at and below in registers; the horizontal neighbours are the
// next thread group's own loads (L1/L2 hits), so device memory sees about
// one read of the field.  The forward's per-block partial sums are written
// out and summed by the caller in a fixed order (deterministic), as the TPU
// kernel's per-tile partials are.  The TPU kernel's VMEM tile search has no
// purpose here.  Requires D % 8 == 0 and 16-byte aligned rows.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // image rows per block
using bf16 = __nv_bfloat16;

// The difference a - b rounded to bf16, widened back to f32.
__device__ __forceinline__ float diff_bf16(bf16 a, bf16 b) {
  return __bfloat162float(
      __float2bfloat16_rn(__bfloat162float(a) - __bfloat162float(b)));
}

__device__ __forceinline__ float slope(bf16 a, bf16 b) {
  return diff_bf16(a, b) >= 0.f ? 1.f : -1.f;
}

struct Tile {
  long long p;  // (pixel column, channel group) pair of this thread
  int w, g;
  int b, h0, h1;
};

__device__ __forceinline__ Tile tile_of(int H, int W, int D) {
  Tile t;
  const int groups = D / 8;
  t.p = (long long)blockIdx.x * kThreads + threadIdx.x;
  t.w = (int)(t.p / groups);
  t.g = (int)(t.p % groups);
  const int tiles = (H + kRows - 1) / kRows;
  t.b = blockIdx.y / tiles;
  t.h0 = (blockIdx.y % tiles) * kRows;
  t.h1 = min(t.h0 + kRows, H);
  return t;
}

__global__ void __launch_bounds__(kThreads)
    tv_fwd_kernel(const bf16* __restrict__ x, int H, int W, int D,
                  const float* __restrict__ weight,
                  float* __restrict__ partials) {
  const Tile t = tile_of(H, W, D);
  float sh = 0.f, sv = 0.f;
  if (t.p < (long long)W * (D / 8)) {
    const long long row = (long long)W * D;
    const bf16* col = x + (long long)t.b * H * row + (long long)t.w * D +
                      t.g * 8;
    bf16 cur[8], nxt[8], right[8];
    rc::load8(col + t.h0 * row, cur);
    for (int h = t.h0; h < t.h1; ++h) {
      if (t.w < W - 1) {
        rc::load8(col + h * row + D, right);
#pragma unroll
        for (int i = 0; i < 8; ++i) sh += fabsf(diff_bf16(cur[i], right[i]));
      }
      if (h < H - 1) {
        rc::load8(col + (h + 1) * row, nxt);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          sv += fabsf(diff_bf16(cur[i], nxt[i]));
          cur[i] = nxt[i];
        }
      }
    }
  }
  __shared__ float red[2][kThreads / 32];
  sh = rc::warp_sum(sh);
  sv = rc::warp_sum(sv);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = sh;
    red[1][threadIdx.x >> 5] = sv;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float th = 0.f, tv = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      th += red[0][i];
      tv += red[1][i];
    }
    const float wt = weight != nullptr ? weight[t.b] : 1.f;
    const long long block =
        (long long)blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * block] = th * wt;
    partials[2 * block + 1] = tv * wt;
  }
}

__global__ void __launch_bounds__(kThreads)
    tv_bwd_kernel(const bf16* __restrict__ x, int H, int W, int D,
                  const float* __restrict__ weight,
                  const float* __restrict__ g, bf16* __restrict__ dx) {
  const Tile t = tile_of(H, W, D);
  if (t.p >= (long long)W * (D / 8)) return;
  const float wt = weight != nullptr ? weight[t.b] : 1.f;
  const float gh = g[0] * wt;
  const float gv = g[1] * wt;
  const long long row = (long long)W * D;
  const long long base =
      (long long)t.b * H * row + (long long)t.w * D + t.g * 8;
  const bf16* col = x + base;
  bf16 up[8], cur[8], dn[8], left[8], right[8], out[8];
  if (t.h0 > 0) rc::load8(col + (t.h0 - 1) * row, up);
  rc::load8(col + t.h0 * row, cur);
  for (int h = t.h0; h < t.h1; ++h) {
    if (h < H - 1) rc::load8(col + (h + 1) * row, dn);
    if (t.w > 0) rc::load8(col + h * row - D, left);
    if (t.w < W - 1) rc::load8(col + h * row + D, right);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sh_r = t.w < W - 1 ? slope(cur[i], right[i]) : 0.f;
      const float sh_l = t.w > 0 ? slope(left[i], cur[i]) : 0.f;
      const float sv_d = h < H - 1 ? slope(cur[i], dn[i]) : 0.f;
      const float sv_u = h > 0 ? slope(up[i], cur[i]) : 0.f;
      out[i] = __float2bfloat16_rn(
          __fadd_rn(__fmul_rn(gh, sh_r - sh_l), __fmul_rn(gv, sv_d - sv_u)));
    }
    rc::store8(dx + base + h * row, out);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      up[i] = cur[i];
      cur[i] = dn[i];
    }
  }
}

dim3 grid_of(int B, int H, int W, int D) {
  const long long pairs = (long long)W * (D / 8);
  return dim3((unsigned)((pairs + kThreads - 1) / kThreads),
              (unsigned)(B * ((H + kRows - 1) / kRows)));
}

bool valid_shape(int B, int H, int W, int D) {
  return B >= 1 && H >= 1 && W >= 1 && D >= 8 && D % 8 == 0 &&
         (long long)B * ((H + kRows - 1) / kRows) <= 65535;
}

}  // namespace

// x: [B, H, W, D] bf16, 16-byte aligned; weight: [B] f32 or NULL (all 1);
// partials: [grid.y * grid.x, 2] f32 with grid.x = ceil(W * D / 8 / 256)
// and grid.y = B * ceil(H / 8): per block (sum |dh|, sum |dv|) * weight.
extern "C" int rc_tv_rowtile_fwd(const void* x, int B, int H, int W, int D,
                                 const float* weight, float* partials,
                                 void* stream) {
  if (!valid_shape(B, H, W, D)) return cudaErrorInvalidValue;
  tv_fwd_kernel<<<grid_of(B, H, W, D), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), H, W, D, weight, partials);
  return cudaGetLastError();
}

// g: [2] f32 on the device, (gh, gv) = the upstream gradient over each
// direction's pair count (and the upsample rescale); dx: [B, H, W, D] bf16.
extern "C" int rc_tv_rowtile_bwd(const void* x, int B, int H, int W, int D,
                                 const float* weight, const float* g,
                                 void* dx, void* stream) {
  if (!valid_shape(B, H, W, D)) return cudaErrorInvalidValue;
  tv_bwd_kernel<<<grid_of(B, H, W, D), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), H, W, D, weight, g,
      static_cast<bf16*>(dx));
  return cudaGetLastError();
}
