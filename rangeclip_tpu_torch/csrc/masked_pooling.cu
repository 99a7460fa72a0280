// Segment sums of pixel embeddings over object ids, and the pixel counts.
//
// Replaces rangeclip_tpu/ops/pallas/masked_pooling.py: _pool_kernel, entry
// point fused_masked_pooling.  Same contract: sums[n] is the f32 sum of the
// embedding rows p with seg[p] == obj[n], counts[n] the number of such p.
// Ids absent from the batch give zero rows and count 0; duplicate ids each
// get the full sums; labels that are not in obj (the -1 padding among them)
// contribute nothing.  The rows are read in their own dtype (f32 or bf16)
// and widened in registers: the f32 cast the JAX callers make is exact.
//
// Bound on the card: bytes.  The function must read every embedding row
// once (537 MB for a bf16 [32 * 128 * 128, 512] field) and the labels once;
// it does P * D adds.  The TPU kernel streams [N, TILE_P] one-hot match
// tiles into an MXU product, 2 * N * P * D operations of which all but one
// in N multiply by zero; on the card the same function is a segment sum.
//
// Design (deterministic, no float atomics):
//   1. Partials: one block per (object n, chunk g of kChunk pixels).  The
//      block scans the chunk's labels, 4 per thread per step, and compacts
//      the positions that match obj[n] into shared memory in pixel order
//      (per-thread counts, a warp scan, then a block scan).  Its threads
//      form R = 256 / (D / 8) groups of D / 8 lanes, each lane owning 8
//      channels (one 16-byte load of a bf16 row); matched row i goes to
//      group i % R, which adds it to f32 registers.  The groups' sums are
//      combined in group order and written to part[g][n]; the match count
//      to pcount[g][n].  Rows of absent ids are never read; their blocks
//      only scan 64 KB of labels, from L2 after the first pass.
//   2. Reduce: one block per object sums part[0..G)[n] in chunk order, and
//      the integer counts exactly.
// Every sum is taken in a fixed order, so the result does not change from
// run to run.  Requires D % 8 == 0, D <= 2048, 16-byte aligned rows.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                   // labels scanned per step
constexpr int kStep = kThreads * kPerThread;    // labels per step
constexpr int kChunk = 16384;                   // pixels per block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                      // rows in flight per group

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_partial_kernel(const T* __restrict__ emb,
                        const int* __restrict__ seg,
                        const int* __restrict__ obj, long long p_total, int d,
                        int n_obj, float* __restrict__ part,
                        int* __restrict__ pcount) {
  __shared__ int rows[kStep];
  __shared__ int warp_total[kWarps];
  __shared__ float red[kThreads * 8];  // R * D <= 2048 floats

  const int tid = threadIdx.x;
  const int lane32 = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.x;
  const int g = blockIdx.y;
  const int label = obj[n];
  const long long p0 = (long long)g * kChunk;
  const long long p1 = min(p_total, p0 + kChunk);

  const int lanes = d / 8;          // threads per row
  const int groups = kThreads / lanes;
  const int grp = tid / lanes;
  const int lane = tid % lanes;
  const bool active = grp < groups;

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  int offset = 0;    // matched rows so far, modulo groups
  int matched = 0;   // matched rows so far

  for (long long s = p0; s < p1; s += kStep) {
    // 1. this thread's kPerThread labels: a 4-bit hit mask
    const long long q = s + (long long)tid * kPerThread;
    unsigned hits = 0u;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      if (q + i < p1 && __ldg(seg + q + i) == label) hits |= 1u << i;
    const int mine = __popc(hits);
    // 2. exclusive scan of the counts over the block, in thread order
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane32 >= off) incl += up;
    }
    if (lane32 == 31) warp_total[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      const int c = warp_total[wi];
      before += wi < warp ? c : 0;
      total += c;
    }
    int at = before + incl - mine;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      if (hits & (1u << i)) rows[at++] = (int)(q + i - p0);
    __syncthreads();

    // 3. the matched rows, in order, round-robin over the groups
    if (active) {
      const T* base = emb + p0 * d + lane * 8;
      int j = grp - offset;
      if (j < 0) j += groups;
      for (; j < total; j += kUnroll * groups) {
        T v[kUnroll][8];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int jj = j + u * groups;
          if (jj < total) rc::load8(base + (long long)rows[jj] * d, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u * groups < total) {
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] += rc::to_float(v[u][i]);
          }
        }
      }
    }
    matched += total;
    offset = (offset + total) % groups;
    __syncthreads();  // rows and warp_total are reused by the next step
  }

  // 4. combine the groups in group order
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[grp * d + lane * 8 + i] = acc[i];
  }
  __syncthreads();
  float* out = part + ((long long)g * n_obj + n) * d;
  for (int e = tid; e < d; e += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < groups; ++r) sum += red[r * d + e];
    out[e] = sum;
  }
  if (tid == 0) pcount[(long long)g * n_obj + n] = matched;
}

__global__ void __launch_bounds__(kThreads)
    pool_reduce_kernel(const float* __restrict__ part,
                       const int* __restrict__ pcount, int n_chunks, int d,
                       int n_obj, float* __restrict__ sums,
                       float* __restrict__ counts) {
  const int n = blockIdx.x;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float sum = 0.f;
    for (int g = 0; g < n_chunks; ++g)
      sum += part[((long long)g * n_obj + n) * d + e];
    sums[(long long)n * d + e] = sum;
  }
  if (threadIdx.x == 0) {
    long long c = 0;
    for (int g = 0; g < n_chunks; ++g) c += pcount[(long long)g * n_obj + n];
    counts[n] = (float)c;
  }
}

template <typename T>
cudaError_t launch(const void* emb, const int* seg, const int* obj,
                   long long p_total, int d, int n_obj, float* part,
                   int* pcount, float* sums, float* counts,
                   cudaStream_t stream) {
  const long long n_chunks = (p_total + kChunk - 1) / kChunk;
  pool_partial_kernel<T><<<dim3((unsigned)n_obj, (unsigned)n_chunks),
                           kThreads, 0, stream>>>(
      static_cast<const T*>(emb), seg, obj, p_total, d, n_obj, part, pcount);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pool_reduce_kernel<<<(unsigned)n_obj, kThreads, 0, stream>>>(
      part, pcount, (int)n_chunks, d, n_obj, sums, counts);
  return cudaGetLastError();
}

}  // namespace

// emb: [p_total, d] f32 (is_bf16 == 0) or bf16, 16-byte aligned, d % 8 == 0,
// 8 <= d <= 2048; seg: [p_total] int32; obj: [n_obj] int32.  Workspace:
// part [G, n_obj, d] f32 and pcount [G, n_obj] int32, G = ceil(p_total /
// 16384) (every entry written).  Outputs: sums [n_obj, d] f32, counts
// [n_obj] f32.  p_total >= 1, 1 <= n_obj, G <= 65535.
extern "C" int rc_masked_pooling(const void* emb, int is_bf16, const int* seg,
                                 const int* obj, long long p_total, int d,
                                 int n_obj, float* part, int* pcount,
                                 float* sums, float* counts, void* stream) {
  if (d % 8 != 0 || d < 8 || d > 8 * kThreads || p_total < 1 || n_obj < 1 ||
      (p_total + kChunk - 1) / kChunk > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(emb, seg, obj, p_total, d, n_obj,
                                         part, pcount, sums, counts, st)
                 : launch<float>(emb, seg, obj, p_total, d, n_obj, part,
                                 pcount, sums, counts, st);
}
