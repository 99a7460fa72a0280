// present[c] = any(labels == c && valid > 0) over a flat [N] label vector.
//
// Replaces rangeclip_tpu/ops/pallas/class_presence.py: _presence_kernel,
// entry point fused_class_presence.  Labels outside [0, C) never match.
// Without a validity vector (valid == nullptr) every label counts, as with
// the all-ones vector the JAX callers pass.
//
// Bound on the card: bytes (8 per label with a validity vector, 4 without),
// so the kernel is a single streaming pass.  The TPU kernel compares each
// label tile against a [C, TN] class iota on the vector unit; here each
// block sets bits of a [C] presence bitmap in shared memory with atomicOr
// (reading the word first: present classes are few, so most labels find
// their bit set and cost no atomic).  OR does not depend on order, so the
// result is exact.
//
// Design, one launch and no other device event per call:
//   - Loads: 16-byte loads of labels and of valid, kUnroll of each in flight
//     per thread, over a grid of up to kBlocksPerSm blocks per SM.  An
//     unaligned start (a view with a storage offset) and N % 4 != 0 are a
//     scalar head (block 0) and tail (the last block); a validity vector
//     whose start is not aligned with the labels' is read with scalar loads.
//   - Blocks OR their non-zero bitmap words into a workspace (work[0] a
//     ticket, work[1..] the words), then take a ticket; the last block to
//     finish (__threadfence, then atomicAdd on the ticket, as in the CUDA
//     threadFenceReduction sample) writes the [C] bool output and clears the
//     workspace for the next call on its stream.  No memset before the
//     launch, no cast after, no host sync.  The workspace must be the
//     call's alone while it runs: the wrapper keeps one per stream, and
//     gives each call captured in a CUDA graph its own.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // 16-byte loads in flight per operand
constexpr int kBlocksPerSm = 4;  // fewer blocks: fewer tickets and ORs

__device__ __forceinline__ void mark(unsigned int* bits, int l,
                                     int num_classes) {
  if (static_cast<unsigned int>(l) < static_cast<unsigned int>(num_classes)) {
    const unsigned int bit = 1u << (l & 31);
    if ((bits[l >> 5] & bit) == 0u) atomicOr(&bits[l >> 5], bit);
  }
}

template <bool kValid>
__device__ __forceinline__ void mark_one(unsigned int* bits,
                                         const int* __restrict__ labels,
                                         const float* __restrict__ valid,
                                         long long i, int num_classes) {
  if (!kValid || __ldg(valid + i) > 0.f)
    mark(bits, __ldg(labels + i), num_classes);
}

// labels + head and (vec_valid) valid + head are 16-byte aligned; body int4
// groups follow the head, then n - head - 4 * body tail labels.
template <bool kValid>
__global__ void __launch_bounds__(kThreads)
    class_presence_kernel(const int* __restrict__ labels,
                          const float* __restrict__ valid, long long n,
                          int head, int vec_valid, int num_classes,
                          unsigned int* __restrict__ work,
                          unsigned char* __restrict__ out) {
  extern __shared__ unsigned int bits[];  // [ceil(C / 32)]
  __shared__ bool last;
  const int words = (num_classes + 31) >> 5;
  for (int w = threadIdx.x; w < words; w += kThreads) bits[w] = 0u;
  __syncthreads();

  const long long body = (n - head) >> 2;
  if (blockIdx.x == 0 && threadIdx.x < head)
    mark_one<kValid>(bits, labels, valid, threadIdx.x, num_classes);
  if (blockIdx.x == gridDim.x - 1) {
    const long long i = head + 4 * body + threadIdx.x;
    if (i < n) mark_one<kValid>(bits, labels, valid, i, num_classes);
  }

  const int4* lab4 = reinterpret_cast<const int4*>(labels + head);
  const float4* val4 = reinterpret_cast<const float4*>(valid + head);
  const long long step = (long long)gridDim.x * kThreads * kUnroll;
  for (long long base = (long long)blockIdx.x * kThreads * kUnroll +
                        threadIdx.x;
       base < body; base += step) {
    int4 l[kUnroll];
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      l[u] = make_int4(-1, -1, -1, -1);
      v[u] = make_float4(1.f, 1.f, 1.f, 1.f);
      if (i < body) {
        l[u] = __ldg(lab4 + i);
        if (kValid) {
          if (vec_valid) {
            v[u] = __ldg(val4 + i);
          } else {
            const float* s = valid + head + 4 * i;
            v[u] = make_float4(__ldg(s), __ldg(s + 1), __ldg(s + 2),
                               __ldg(s + 3));
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!kValid || v[u].x > 0.f) mark(bits, l[u].x, num_classes);
      if (!kValid || v[u].y > 0.f) mark(bits, l[u].y, num_classes);
      if (!kValid || v[u].z > 0.f) mark(bits, l[u].z, num_classes);
      if (!kValid || v[u].w > 0.f) mark(bits, l[u].w, num_classes);
    }
  }
  __syncthreads();

  for (int w = threadIdx.x; w < words; w += kThreads) {
    if (bits[w] != 0u) atomicOr(work + 1 + w, bits[w]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(work, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: every other block's words are in L2
  __threadfence();
  for (int w = threadIdx.x; w < words; w += kThreads)
    bits[w] = __ldcg(work + 1 + w);
  __syncthreads();
  for (int c = threadIdx.x; c < num_classes; c += kThreads)
    out[c] = (bits[c >> 5] >> (c & 31)) & 1u;
  for (int w = threadIdx.x; w < words; w += kThreads) work[1 + w] = 0u;
  if (threadIdx.x == 0) work[0] = 0u;
}

}  // namespace

// labels: [n] int32 (4-byte aligned); valid: [n] f32 or nullptr (every
// label valid); work: [1 + ceil(num_classes / 32)] uint32, zero before the
// call and left zero after it (one per stream); out: [num_classes] bool,
// every entry written.  n >= 0, num_classes >= 1.
extern "C" int rc_class_presence(const int* labels, const float* valid,
                                 long long n, int num_classes,
                                 unsigned int* work, unsigned char* out,
                                 void* stream) {
  if (n < 0 || num_classes < 1) return cudaErrorInvalidValue;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long misalign =
      (long long)(reinterpret_cast<uintptr_t>(labels) & 15u) / 4;
  const int head = (int)std::min<long long>(n, (4 - misalign) & 3);
  const int vec_valid =
      valid != nullptr &&
      (reinterpret_cast<uintptr_t>(valid + head) & 15u) == 0u;
  const long long body = (n - head) / 4;
  long long blocks = (body + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  blocks = std::max(1LL, std::min(blocks, (long long)kBlocksPerSm * sms));
  const size_t smem =
      (size_t)((num_classes + 31) / 32) * sizeof(unsigned int);
  auto kernel = valid != nullptr ? class_presence_kernel<true>
                                 : class_presence_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(labels, valid, n, head,
                                                vec_valid, num_classes, work,
                                                out);
  return cudaGetLastError();
}
