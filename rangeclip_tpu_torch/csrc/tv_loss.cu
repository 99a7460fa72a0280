// Total variation of a [B, H, W, D] field, f32 or bf16: the sums of |dh| and
// |dv| (forward) and the gradient of mean |dh| + mean |dv| (backward).
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
// both by one ulp of x's dtype.  The forward writes per-block partial sums
// that the caller adds in a fixed order (deterministic).
//
// Bound on the card: bytes.  The forward reads the field once (0.54 GB for
// bf16 [32, 128, 128, 512]), the backward reads it once and writes the
// gradient once.  Each thread owns 8 channels (one 16-byte bf16 load, two
// for f32) of one pixel column and walks down 8 image rows, keeping the
// rows above, at and below in registers; the horizontal neighbours are the
// neighbouring threads' own loads, served from L1/L2.  The TPU kernel's
// row tiles, column chunks and seam passes have no purpose here.  Requires
// D % 8 == 0 and 16-byte aligned rows.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // image rows per block

__device__ __forceinline__ float sign_of(float u) {
  return u > 0.f ? 1.f : (u < 0.f ? -1.f : 0.f);
}

template <typename T>
__device__ __forceinline__ float diff(T a, T b) {
  return rc::to_float(a) - rc::to_float(b);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tv_loss_fwd_kernel(const T* __restrict__ x, int H, int W, int D,
                       float* __restrict__ partials) {
  const Tile t = tile_of(H, W, D);
  float sh = 0.f, sv = 0.f;
  if (t.p < (long long)W * (D / 8)) {
    const long long row = (long long)W * D;
    const T* col =
        x + (long long)t.b * H * row + (long long)t.w * D + t.g * 8;
    T cur[8], nxt[8], right[8];
    rc::load8(col + t.h0 * row, cur);
    for (int h = t.h0; h < t.h1; ++h) {
      if (t.w < W - 1) {
        rc::load8(col + h * row + D, right);
#pragma unroll
        for (int i = 0; i < 8; ++i) sh += fabsf(diff(right[i], cur[i]));
      }
      if (h < H - 1) {
        rc::load8(col + (h + 1) * row, nxt);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          sv += fabsf(diff(nxt[i], cur[i]));
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
    const long long block = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * block] = th;
    partials[2 * block + 1] = tv;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tv_loss_bwd_kernel(const T* __restrict__ x, int H, int W, int D,
                       const float* __restrict__ scales, T* __restrict__ dx) {
  const Tile t = tile_of(H, W, D);
  if (t.p >= (long long)W * (D / 8)) return;
  const float scale_h = scales[0];
  const float scale_v = scales[1];
  const long long row = (long long)W * D;
  const long long base =
      (long long)t.b * H * row + (long long)t.w * D + t.g * 8;
  const T* col = x + base;
  T up[8], cur[8], dn[8], left[8], right[8], out[8];
  if (t.h0 > 0) rc::load8(col + (t.h0 - 1) * row, up);
  rc::load8(col + t.h0 * row, cur);
  for (int h = t.h0; h < t.h1; ++h) {
    if (h < H - 1) rc::load8(col + (h + 1) * row, dn);
    if (t.w > 0) rc::load8(col + h * row - D, left);
    if (t.w < W - 1) rc::load8(col + h * row + D, right);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sl = t.w > 0 ? sign_of(diff(cur[i], left[i])) : 0.f;
      const float sr = t.w < W - 1 ? sign_of(diff(right[i], cur[i])) : 0.f;
      const float su = h > 0 ? sign_of(diff(cur[i], up[i])) : 0.f;
      const float sd = h < H - 1 ? sign_of(diff(dn[i], cur[i])) : 0.f;
      const T th = rc::round_to(__fmul_rn(sl - sr, scale_h), T());
      const T tv = rc::round_to(__fmul_rn(su - sd, scale_v), T());
      out[i] = rc::round_to(
          __fadd_rn(rc::to_float(th), rc::to_float(tv)), T());
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

// x: [B, H, W, D] f32 (is_bf16 == 0) or bf16, 16-byte aligned; partials:
// [grid.y * grid.x, 2] f32 with grid.x = ceil(W * D / 8 / 256) and grid.y =
// B * ceil(H / 8): per block (sum |dh|, sum |dv|), differences in f32.
extern "C" int rc_tv_loss_fwd(const void* x, int is_bf16, int B, int H, int W,
                              int D, float* partials, void* stream) {
  if (!valid_shape(B, H, W, D)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(B, H, W, D);
  if (is_bf16) {
    tv_loss_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), H, W, D, partials);
  } else {
    tv_loss_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), H, W, D, partials);
  }
  return cudaGetLastError();
}

// scales: [2] f32 on the device, (scale_h, scale_v) = the upstream gradient
// over each direction's pair count; dx: [B, H, W, D] in x's dtype.
extern "C" int rc_tv_loss_bwd(const void* x, int is_bf16, int B, int H, int W,
                              int D, const float* scales, void* dx,
                              void* stream) {
  if (!valid_shape(B, H, W, D)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(B, H, W, D);
  if (is_bf16) {
    tv_loss_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), H, W, D, scales,
        static_cast<__nv_bfloat16*>(dx));
  } else {
    tv_loss_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), H, W, D, scales,
        static_cast<float*>(dx));
  }
  return cudaGetLastError();
}
