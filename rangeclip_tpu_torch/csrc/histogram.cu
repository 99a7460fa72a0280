// Exact per-row histogram of draw indices: out[b, p] = #{j : idx[b, j] == p}.
//
// Replaces rangeclip_tpu/ops/pallas/histogram.py: _histogram_kernel, entry
// point fused_histogram.  Indices outside [0, n_bins) (the -1 padding) are
// ignored; counts come out as f32, as the JAX kernel gives them.
//
// Bound on the card: bytes (4 per draw read, 4 per bin written: 14.3 MB at
// 32 x 45,875 draws into 32 x 65,536 bins).  The TPU kernel builds two
// one-hots per draw chunk and multiplies them on the MXU, because a scatter
// is serial there; a scatter is what the card does well.  Counts are
// integers, so any atomic order gives the same result: the kernel is
// bit-equal to its plain version.  One launch per call.
//
// Each block owns one row and a range of bins in 32 KB of shared counters
// (16,384 bins of 16-bit counters while n < 2^16, else 8,192 of 32 bits),
// reads the whole row with 16-byte loads, kUnroll in flight per thread of
// 1024 (the row's start may be unaligned: a scalar head and tail), and
// writes its range once.  No global atomics and no zero pass; a row is read
// once per range, from L2 after the first.  The flagship shape is 128
// blocks, one per SM: the loads in flight per SM, not the L2 reads, set the
// pace (narrower ranges and smaller blocks were slower on the H100, and so
// was one cooperative launch of global reductions into a zero-filled
// output; see PERF.md).

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;     // one block per row and bin range
constexpr int kUnroll = 4;         // 16-byte loads in flight per thread
constexpr int kRangeWords = 8192;  // 32 KB of shared counters a block

// Leading ints of p before a 16-byte boundary, at most n.
__device__ __forceinline__ int head_of(const int* p, long long n) {
  const int h =
      (int)((4u - ((reinterpret_cast<uintptr_t>(p) & 15u) >> 2)) & 3u);
  return n < h ? (int)n : h;
}

// kNarrow: 16-bit counters, two to a shared word (a bin's count is at most
// n < 2^16), so a block owns twice the bins in the same 32 KB.
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const int* __restrict__ idx, long long n,
                            int n_bins, float* __restrict__ out) {
  constexpr int kBins = kNarrow ? 2 * kRangeWords : kRangeWords;
  __shared__ unsigned int counts[kRangeWords];
  const int lo = blockIdx.x * kBins;
  const unsigned int span = (unsigned int)min(kBins, n_bins - lo);
  const unsigned int words = kNarrow ? (span + 1) / 2 : span;
  for (unsigned int i = threadIdx.x; i < words; i += kThreads) counts[i] = 0u;
  __syncthreads();
  const int* row = idx + (long long)blockIdx.y * n;
  auto count = [&](int p) {
    const unsigned int q = (unsigned int)p - (unsigned int)lo;
    if (q < span) {
      if (kNarrow)
        atomicAdd(&counts[q >> 1], 1u << ((q & 1u) * 16));
      else
        atomicAdd(&counts[q], 1u);
    }
  };
  const int head = head_of(row, n);
  const long long body = (n - head) >> 2;
  if ((int)threadIdx.x < head) count(__ldg(row + threadIdx.x));
  {
    const long long j = head + 4 * body + threadIdx.x;
    if (j < n) count(__ldg(row + j));
  }
  const int4* row4 = reinterpret_cast<const int4*>(row + head);
  for (long long base = threadIdx.x; base < body;
       base += (long long)kThreads * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      v[u] = i < body ? __ldg(row4 + i) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      count(v[u].x);
      count(v[u].y);
      count(v[u].z);
      count(v[u].w);
    }
  }
  __syncthreads();
  float* o = out + (long long)blockIdx.y * n_bins + lo;
  for (unsigned int i = threadIdx.x; i < span; i += kThreads)
    o[i] = kNarrow ? (float)((counts[i >> 1] >> ((i & 1u) * 16)) & 0xFFFFu)
                   : (float)counts[i];
}

}  // namespace

// idx: [rows, n] int32, 4-byte aligned; out: [rows, n_bins] f32 (every
// entry written).  1 <= rows <= 65535, n >= 0, n_bins >= 1.
extern "C" int rc_histogram(const int* idx, int rows, long long n, int n_bins,
                            float* out, void* stream) {
  if (rows < 1 || rows > 65535 || n_bins < 1 || n < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = n < 65536;
  const int bins = narrow ? 2 * kRangeWords : kRangeWords;
  const dim3 grid((unsigned)((n_bins + bins - 1) / bins), (unsigned)rows);
  if (narrow)
    histogram_kernel<true><<<grid, kThreads, 0, s>>>(idx, n, n_bins,
                                                            out);
  else
    histogram_kernel<false><<<grid, kThreads, 0, s>>>(idx, n, n_bins,
                                                             out);
  return cudaGetLastError();
}
