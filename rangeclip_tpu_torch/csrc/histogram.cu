// Exact per-row histogram of draw indices: out[b, p] = #{j : idx[b, j] == p}.
//
// Replaces rangeclip_tpu/ops/pallas/histogram.py: _histogram_kernel, entry
// point fused_histogram.  Indices outside [0, n_bins) (the -1 padding) are
// ignored; counts come out as f32, as the JAX kernel gives them.
//
// Bound on the card: bytes (4 per draw read, 4 per bin written: 14.3 MB at
// 32 x 45,875 draws into 32 x 65,536 bins).  The TPU kernel builds two
// one-hots per draw chunk and multiplies them on the MXU, because a scatter
// is serial there; a scatter is what the card does well.  Each block owns
// one image and a range of 16,384 bins, counted with shared-memory atomics
// (64 KB), and scans its image's draws (L2-resident after the first block);
// then it writes its range once.  Counts are integers, so any atomic order
// gives the same result: the kernel is bit-equal to its plain version.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBins = 16384;  // bins per block

__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const int* __restrict__ idx, long long n, int n_bins,
                     float* __restrict__ out) {
  extern __shared__ unsigned int counts[];  // [min(kBins, n_bins)]
  const int lo = blockIdx.x * kBins;
  const int span = min(kBins, n_bins - lo);
  for (int i = threadIdx.x; i < span; i += kThreads) counts[i] = 0u;
  __syncthreads();
  const int* row = idx + (long long)blockIdx.y * n;
  for (long long j = threadIdx.x; j < n; j += kThreads) {
    const int p = __ldg(row + j);
    if (p >= lo && p < lo + span) atomicAdd(&counts[p - lo], 1u);
  }
  __syncthreads();
  float* o = out + (long long)blockIdx.y * n_bins + lo;
  for (int i = threadIdx.x; i < span; i += kThreads) o[i] = (float)counts[i];
}

}  // namespace

// idx: [rows, n] int32; out: [rows, n_bins] f32 (every entry written).
// rows >= 1, 1 <= rows <= 65535, n >= 0, n_bins >= 1.
extern "C" int rc_histogram(const int* idx, int rows, long long n, int n_bins,
                            float* out, void* stream) {
  if (rows < 1 || rows > 65535 || n_bins < 1 || n < 0)
    return cudaErrorInvalidValue;
  const int smem = min(kBins, n_bins) * (int)sizeof(unsigned int);
  cudaError_t err = cudaFuncSetAttribute(
      histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n_bins + kBins - 1) / kBins), (unsigned)rows);
  histogram_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(idx, n, n_bins,
                                                          out);
  return cudaGetLastError();
}
