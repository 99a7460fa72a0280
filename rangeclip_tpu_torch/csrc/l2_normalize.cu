// Row L2-normalisation y = x / max(||x||, eps) and its exact VJP.
//
// Replaces rangeclip_tpu/ops/pallas/l2_normalize.py: _fwd_kernel and
// _bwd_kernel (fused_l2_normalize) and the field variant's _fwd_kernel_t and
// _bwd_kernel_t (fused_l2_normalize_field).  On the card the field is the
// NHWC view of a channels_last tensor, so its pixel rows are already
// contiguous [N, D]: the field variant's relayout absorption has no purpose,
// and both names run these row kernels.
//
// Bound on the card: bytes.  The forward reads x and writes y (2 * N * D *
// sizeof(T) bytes); the backward reads x and g and writes dx.  Statistics
// are f32; outputs are rounded once, to x's dtype.
//
// Design: one warp per row, 16-byte loads (8 values a lane).  A first pass
// sums x^2 (and g.x) in f32 and reduces across the warp; a second pass reads
// the row again (an L1/L2 hit: it was just read) and writes the result, so
// no row length has to fit in registers.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr float kEps = 1e-12f;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    l2_normalize_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                            long long n, int d) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float s = 0.f;
  for (int j = lane * 8; j < d; j += 256) {
    T v[8];
    rc::load8(xr + j, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = rc::to_float(v[i]);
      s = fmaf(f, f, s);
    }
  }
  // l2_normalize.py:47-48: rows / max(sqrt(sum x^2), eps)
  const float m = fmaxf(sqrtf(rc::warp_sum(s)), kEps);
  for (int j = lane * 8; j < d; j += 256) {
    T v[8];
    rc::load8(xr + j, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = rc::round_to(rc::to_float(v[i]) / m, T());
    rc::store8(yr + j, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    l2_normalize_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            T* __restrict__ dx, long long n, int d) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + row * d;
  const T* gr = g + row * d;
  T* dr = dx + row * d;
  float s = 0.f, t = 0.f;
  for (int j = lane * 8; j < d; j += 256) {
    T xv[8], gv[8];
    rc::load8(xr + j, xv);
    rc::load8(gr + j, gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xf = rc::to_float(xv[i]);
      s = fmaf(xf, xf, s);
      t = fmaf(rc::to_float(gv[i]), xf, t);
    }
  }
  // l2_normalize.py:55-62: dx = g/m - [n >= eps] * t / (m^2 * n) * x,
  // m = max(n, eps); the masked branch never divides by zero
  const float nrm = sqrtf(rc::warp_sum(s));
  t = rc::warp_sum(t);
  const float m = fmaxf(nrm, kEps);
  const float factor = nrm >= kEps ? t / (m * m * fmaxf(nrm, kEps)) : 0.f;
  for (int j = lane * 8; j < d; j += 256) {
    T xv[8], gv[8];
    rc::load8(xr + j, xv);
    rc::load8(gr + j, gv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xv[i] = rc::round_to(rc::to_float(gv[i]) / m -
                               rc::to_float(xv[i]) * factor,
                           T());
    rc::store8(dr + j, xv);
  }
}

dim3 grid_for(long long n) {
  return dim3((unsigned)((n + kWarps - 1) / kWarps));
}

}  // namespace

// x, y: [n, d] f32 (is_bf16 == 0) or bf16, 16-byte aligned, d % 8 == 0,
// n >= 1.
extern "C" int rc_l2_normalize_fwd(const void* x, int is_bf16, void* y,
                                   long long n, int d, void* stream) {
  if (d % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    l2_normalize_fwd_kernel<__nv_bfloat16><<<grid_for(n), kWarps * 32, 0,
                                             st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, d);
  } else {
    l2_normalize_fwd_kernel<float><<<grid_for(n), kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, d);
  }
  return cudaGetLastError();
}

// x, g, dx: [n, d] of one dtype as above.
extern "C" int rc_l2_normalize_bwd(const void* x, const void* g, int is_bf16,
                                   void* dx, long long n, int d,
                                   void* stream) {
  if (d % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    l2_normalize_bwd_kernel<__nv_bfloat16><<<grid_for(n), kWarps * 32, 0,
                                             st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), n, d);
  } else {
    l2_normalize_bwd_kernel<float><<<grid_for(n), kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(dx), n, d);
  }
  return cudaGetLastError();
}
