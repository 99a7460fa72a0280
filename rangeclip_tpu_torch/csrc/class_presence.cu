// present[c] = any(labels == c && valid > 0) over a flat [N] label vector.
//
// Replaces rangeclip_tpu/ops/pallas/class_presence.py: _presence_kernel,
// entry point fused_class_presence.  Labels outside [0, C) never match.
//
// Bound on the card: bytes (8 per label: an int32 label and an f32 weight),
// so the kernel is a single streaming pass.  The TPU kernel compares each
// label tile against a [C, TN] class iota on the vector unit; here each
// block sets bits of a [C] presence bitmap in shared memory with atomicOr
// (reading the word first, so repeated labels cost no atomic), then ORs the
// set bits into the global [C] int32 output, which the caller zeroes.  OR
// does not depend on order, so the result is exact.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    class_presence_kernel(const int* __restrict__ labels,
                          const float* __restrict__ valid, long long n,
                          int num_classes, int* __restrict__ out) {
  extern __shared__ unsigned int bits[];  // [ceil(C / 32)]
  const int words = (num_classes + 31) / 32;
  for (int i = threadIdx.x; i < words; i += blockDim.x) bits[i] = 0u;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int l = __ldg(labels + i);
    if (__ldg(valid + i) > 0.f && l >= 0 && l < num_classes) {
      const unsigned int bit = 1u << (l & 31);
      if ((bits[l >> 5] & bit) == 0u) atomicOr(&bits[l >> 5], bit);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < num_classes; c += blockDim.x) {
    if ((bits[c >> 5] >> (c & 31)) & 1u) atomicOr(out + c, 1);
  }
}

}  // namespace

// labels: [n] int32; valid: [n] f32; out: [num_classes] int32, zeroed by the
// caller.  n >= 1, num_classes >= 1.
extern "C" int rc_class_presence(const int* labels, const float* valid,
                                 long long n, int num_classes, int* out,
                                 void* stream) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  const size_t smem = (size_t)((num_classes + 31) / 32) * sizeof(unsigned int);
  class_presence_kernel<<<(unsigned)blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      labels, valid, n, num_classes, out);
  return cudaGetLastError();
}
