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
// Design: one pass over the labels, deterministic (no float atomics).  The
// pixels fall in chunks of kChunk.  Three launches:
//   1. Sort, pool_sort_kernel, one block a chunk: the block hashes the ids
//      into shared memory (id -> its first slot, so a duplicate id maps to
//      the slot that carries its sums), reads each of the chunk's labels
//      once (32 warps, each with its 256 labels' loads in flight at once)
//      and maps it to a slot, counts the slots per warp, and orders the
//      chunk's matched positions by slot, in pixel order within a slot (a
//      stable counting sort: each warp places its contiguous 256 labels
//      from its own cursors, with __match_any_sync for equal slots among
//      its lanes).  It writes the sorted keys (slot * kChunk + position, 4
//      bytes a pixel), the slots' counts pcount[g][n] (0 for absent ones)
//      and the chunk's matched total.
//   2. Sums, pool_sum_kernel, one block per (128-dim slice, chunk): 16
//      row groups of 16 lanes, a lane 8 dims (16-byte loads of bf16), four
//      rows in flight.  The chunk's sorted keys are staged in shared memory
//      (so a row's address waits on no device-memory read) and cut into 16
//      contiguous segments; a group walks its segment in order and sums
//      each slot's rows into f32 registers.  A run of one slot that lies
//      inside the segment is written to part[g][slot] at once; a run that
//      crosses a segment edge leaves its pieces in shared memory, and the
//      group where it starts adds the later groups' pieces in group order
//      and writes it.  Only the slots present in the chunk are written.
//      (64-dim slices of 32 groups took 0.209 ms against 0.190 at the
//      flagship field on an H100 80GB HBM3 at 700 W: each block then reads
//      a 128-byte piece of a row, and the row's other pieces come from DRAM
//      later.)
//   3. Reduce, pool_reduce_kernel, one block per (slot, 512 dims), a
//      float4 a thread: the sum over the chunks, in chunk order, of
//      part[g][first slot] where pcount says it is present, sixteen chunks'
//      loads in flight; the counts exactly.  A duplicate slot reads its
//      first slot's partials.
// Every sum is taken in a fixed order, so the result does not change from
// run to run.  Workspace (the wrapper's, ops/kernels/masked_pooling.py:
// workspace_shapes): keys [G * kChunk], pcount [G, N], totals [G], first
// [N] int32, part [G, N, D] f32, G = ceil(P / kChunk); the worst case,
// every id present in every chunk, writes and reads G * N * D * 4 bytes of
// part (33.5 MB at P = 524,288, N = 256, D = 512: 6% of the bf16 field).
// There the sum launch has 64 chunks x 4 slices = 256 blocks, all resident
// at three an SM.
// Requires D % 8 == 0, D <= 2048, N <= kMaxIds, 16-byte aligned rows.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;                // a sum block
constexpr int kSortThreads = 1024;          // a sort block
constexpr int kWarps = kSortThreads / 32;
constexpr int kChunk = 8192;                // pixels a chunk
constexpr int kWarpSpan = kChunk / kWarps;  // a warp's part of the sort
constexpr int kMaxIds = 1024;               // ids a launch
constexpr int kMaxDims = 2048;  // the wrapper's column chunks
constexpr int kLanes = 16;                  // lanes a row slice
constexpr int kSlice = kLanes * 8;          // dims a sum block
constexpr int kGroups = kThreads / kLanes;  // row groups of a sum block
constexpr int kUnroll = 4;                  // rows in flight a lane

// --- the id hash: open addressing in shared memory, 2^bits entries ------
// An entry is (id << 32 | 1), 0 when empty; its slot the smallest n with
// obj[n] == id (atomicMin: the same whatever the insertion order).

__device__ __forceinline__ int hash_of(int id, int bits) {
  return (int)(((unsigned)id * 2654435761u) >> (32 - bits));
}

__device__ __forceinline__ unsigned long long entry_of(int id) {
  return (unsigned long long)(unsigned)id << 32 | 1ull;
}

__device__ __forceinline__ void hash_insert(unsigned long long* key,
                                            int* slot, int bits, int id,
                                            int n) {
  const unsigned long long e = entry_of(id);
  const int mask = (1 << bits) - 1;
  for (int h = hash_of(id, bits);; h = (h + 1) & mask) {
    const unsigned long long prev = atomicCAS(key + h, 0ull, e);
    if (prev == 0ull || prev == e) {
      atomicMin(slot + h, n);
      return;
    }
  }
}

// The first slot of `id`, or -1 when it is not among the ids.
__device__ __forceinline__ int hash_find(const unsigned long long* key,
                                         const int* slot, int bits, int id) {
  const unsigned long long e = entry_of(id);
  const int mask = (1 << bits) - 1;
  for (int h = hash_of(id, bits);; h = (h + 1) & mask) {
    const unsigned long long k = key[h];
    if (k == e) return slot[h];
    if (k == 0ull) return -1;
  }
}

// Dynamic shared memory of the sort: the hash (2^bits entries and slots),
// the per-warp slot counts [kWarps][n_obj], the chunk's slots [kChunk] and
// the slots' totals [n_obj].
size_t sort_smem(int bits, int n_obj) {
  return ((size_t)12 << bits) + (size_t)(kWarps + 1) * n_obj * 4 +
         (size_t)kChunk * 4;
}

__global__ void __launch_bounds__(kSortThreads)
    pool_sort_kernel(const int* __restrict__ seg, long long p_total,
                     const int* __restrict__ obj, int n_obj, int bits,
                     int* __restrict__ keys, int* __restrict__ pcount,
                     int* __restrict__ totals, int* __restrict__ first) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* hkey = reinterpret_cast<unsigned long long*>(smem);
  int* hslot = reinterpret_cast<int*>(hkey + (1 << bits));
  int* wcnt = hslot + (1 << bits);         // [kWarps][n_obj]
  int* mapped = wcnt + kWarps * n_obj;     // [kChunk]
  int* tot = mapped + kChunk;              // [n_obj]
  __shared__ int scan_part[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x;
  const long long p0 = (long long)g * kChunk;

  for (int i = tid; i < (1 << bits); i += kSortThreads) {
    hkey[i] = 0ull;
    hslot[i] = INT_MAX;
  }
  for (int i = tid; i < kWarps * n_obj; i += kSortThreads) wcnt[i] = 0;
  __syncthreads();
  for (int n = tid; n < n_obj; n += kSortThreads)
    hash_insert(hkey, hslot, bits, __ldg(obj + n), n);
  __syncthreads();
  if (g == 0)
    for (int n = tid; n < n_obj; n += kSortThreads)
      first[n] = hash_find(hkey, hslot, bits, __ldg(obj + n));

  // 1. each label read once (the warp's all in flight at once) and mapped
  // to its slot; counts per warp
  const int w0 = warp * kWarpSpan;
  int lab[kWarpSpan / 32];
#pragma unroll
  for (int s = 0; s < kWarpSpan / 32; ++s) {
    const long long p = p0 + w0 + s * 32 + lane;
    lab[s] = p < p_total ? __ldg(seg + p) : 0;
  }
#pragma unroll
  for (int s = 0; s < kWarpSpan / 32; ++s) {
    const int i = w0 + s * 32 + lane;
    const int f =
        p0 + i < p_total ? hash_find(hkey, hslot, bits, lab[s]) : -1;
    mapped[i] = f;
    if (f >= 0) atomicAdd(wcnt + warp * n_obj + f, 1);
  }
  __syncthreads();

  // 2. per slot: its count, and each warp's count before it
  for (int f = tid; f < n_obj; f += kSortThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w * n_obj + f];
      wcnt[w * n_obj + f] = run;
      run += c;
    }
    tot[f] = run;
    pcount[(long long)g * n_obj + f] = run;
  }
  __syncthreads();

  // 3. exclusive scan of the slots' counts (in slot order): each thread
  // scans kMaxIds / kSortThreads consecutive slots, then the warps
  constexpr int kPerThread = kMaxIds / kSortThreads;
  int mine[kPerThread];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int f = tid * kPerThread + j;
    mine[j] = f < n_obj ? tot[f] : 0;
    sum += mine[j];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) scan_part[warp] = incl;
  __syncthreads();
  int before = incl - sum, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? scan_part[w] : 0;
    all += scan_part[w];
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int f = tid * kPerThread + j;
    if (f < n_obj) tot[f] = before;
    before += mine[j];
  }
  if (tid == 0) totals[g] = all;
  __syncthreads();
  // each warp's cursor of a slot: the slot's start + the warps before it
  for (int i = tid; i < kWarps * n_obj; i += kSortThreads)
    wcnt[i] += tot[i % n_obj];
  __syncthreads();

  // 4. stable placement: a warp's labels in order, equal slots among its
  // lanes ranked by lane, its cursor advanced by their number
  int* out = keys + p0;
  const unsigned below = (1u << lane) - 1u;
  for (int s = 0; s < kWarpSpan; s += 32) {
    const int i = w0 + s + lane;
    const int f = mapped[i];
    const unsigned peers = __match_any_sync(0xffffffffu, f);
    const int leader = __ffs(peers) - 1;
    int at = lane == leader && f >= 0 ? wcnt[warp * n_obj + f] : 0;
    at = __shfl_sync(0xffffffffu, at, leader);
    if (f >= 0) out[at + __popc(peers & below)] = f * kChunk + i;
    __syncwarp();
    if (lane == leader && f >= 0)
      wcnt[warp * n_obj + f] = at + __popc(peers);
    __syncwarp();
  }
}

template <typename T>
__device__ __forceinline__ void add8(float (&acc)[8], const T (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] += rc::to_float(v[e]);
}

// Dynamic shared memory of a sum block: the chunk's keys, then the run
// pieces at the segments' edges.
struct SumSmem {
  int key[kChunk];
  float head[kGroups][kSlice];  // a run from before the segment
  float tail[kGroups][kSlice];  // a run that starts in it and goes on
  int head_f[kGroups], tail_f[kGroups];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_sum_kernel(const T* __restrict__ emb, int d,
                    const int* __restrict__ keys,
                    const int* __restrict__ totals, int n_obj,
                    float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SumSmem& sm = *reinterpret_cast<SumSmem*>(smem_raw);
  auto& head = sm.head;
  auto& tail = sm.tail;
  auto& head_f = sm.head_f;
  auto& tail_f = sm.tail_f;
  const int tid = threadIdx.x;
  const int grp = tid / kLanes;
  const int lane = tid % kLanes;
  const int g = blockIdx.y;
  const int dim0 = blockIdx.x * kSlice + lane * 8;
  const bool active = dim0 < d;
  const long long p0 = (long long)g * kChunk;
  const int* key = sm.key;
  const T* rows = emb + p0 * d + dim0;
  float* part_g = part + (long long)g * n_obj * d + dim0;

  // the chunk's sorted keys, read once with 16-byte loads (the walks'
  // reads then cost no device-memory latency)
  const int m = __ldg(totals + g);
  const int4* src = reinterpret_cast<const int4*>(keys + p0);
  for (int q = tid; q < (m + 3) / 4; q += kThreads)
    reinterpret_cast<int4*>(sm.key)[q] = __ldg(src + q);
  __syncthreads();
  const int len = (m + kGroups - 1) / kGroups;
  const int e0 = min(m, grp * len);
  const int e1 = min(m, e0 + len);
  // the slots of the runs that cross this segment's edges, or -1
  const int prev_f = e0 > 0 && e0 < e1 ? key[e0 - 1] / kChunk : -1;
  const int next_f = e1 < m && e0 < e1 ? key[e1] / kChunk : -1;
  if (lane == 0) head_f[grp] = tail_f[grp] = -1;

  float acc[8];
  int cur = -1;         // the slot of the run being summed
  bool from = false;    // it started before e0
  auto flush = [&](bool on) {  // the run ends here (on: it goes on past e1)
    if (from || on) {
      float* piece = from ? head[grp] : tail[grp];
      if (lane == 0) (from ? head_f : tail_f)[grp] = cur;
#pragma unroll
      for (int e = 0; e < 8; ++e) piece[lane * 8 + e] = acc[e];
    } else if (active) {
      float* dst = part_g + (long long)cur * d;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  };
  for (int e = e0; e < e1; e += kUnroll) {
    int k[kUnroll];
    T v[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      k[u] = e + u < e1 ? key[e + u] : -1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k[u] >= 0 && active)
        rc::load8(rows + (long long)(k[u] % kChunk) * d, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k[u] < 0) break;
      const int f = k[u] / kChunk;
      if (f != cur) {
        if (cur >= 0) flush(false);
        cur = f;
        from = e + u == e0 && f == prev_f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      }
      if (active) add8(acc, v[u]);
    }
  }
  if (cur >= 0) flush(cur == next_f);
  __syncthreads();

  // a run that starts in this segment and goes on: its pieces in order
  const int f = tail_f[grp];
  if (f < 0 || !active) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = tail[grp][lane * 8 + i];
  for (int r = grp + 1; r < kGroups && head_f[r] == f; ++r) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += head[r][lane * 8 + i];
  }
  float* dst = part_g + (long long)f * d;
  *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(acc[4], acc[5], acc[6], acc[7]);
}

constexpr int kReduceThreads = 128;  // a float4 each: 512 dims a block
constexpr int kReduceAhead = 16;     // chunks' loads in flight

// One block per (slot n, 512-dim slice): sum over the chunks, in chunk
// order, of the partials of obj[n]'s first slot where it is present.
__global__ void __launch_bounds__(kReduceThreads)
    pool_reduce_kernel(const float* __restrict__ part,
                       const int* __restrict__ pcount,
                       const int* __restrict__ first, int n_chunks, int d,
                       int n_obj, float* __restrict__ sums,
                       float* __restrict__ counts) {
  __shared__ int here[kReduceThreads];  // a tile of the chunks' counts
  const int n = blockIdx.x;
  const int f = __ldg(first + n);  // the slot that carries obj[n]'s sums
  const int dim = blockIdx.y * kReduceThreads * 4 + threadIdx.x * 4;
  const bool active = dim < d;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  long long c = 0;
  for (int g0 = 0; g0 < n_chunks; g0 += kReduceThreads) {
    const int tile = min(kReduceThreads, n_chunks - g0);
    __syncthreads();
    if (threadIdx.x < tile)
      here[threadIdx.x] =
          __ldg(pcount + (long long)(g0 + threadIdx.x) * n_obj + f);
    __syncthreads();
    for (int j0 = 0; j0 < tile; j0 += kReduceAhead) {
      float4 v[kReduceAhead];
#pragma unroll
      for (int u = 0; u < kReduceAhead; ++u) {
        const int j = j0 + u;
        // absent: part[g][f] was not written
        v[u] = j < tile && here[j] > 0 && active
                   ? __ldg(reinterpret_cast<const float4*>(
                         part + ((long long)(g0 + j) * n_obj + f) * d + dim))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kReduceAhead; ++u) {
        const int j = j0 + u;
        if (j < tile && here[j] > 0) {
          acc.x += v[u].x;
          acc.y += v[u].y;
          acc.z += v[u].z;
          acc.w += v[u].w;
          c += here[j];
        }
      }
    }
  }
  if (active)
    *reinterpret_cast<float4*>(sums + (long long)n * d + dim) = acc;
  if (blockIdx.y == 0 && threadIdx.x == 0) counts[n] = (float)c;
}

template <typename T>
cudaError_t launch(const void* emb, const int* seg, const int* obj,
                   long long p_total, int d, int n_obj, int* keys,
                   int* pcount, int* totals, int* first, float* part,
                   float* sums, float* counts, cudaStream_t stream) {
  const long long n_chunks = (p_total + kChunk - 1) / kChunk;
  int bits = 5;  // a table at least twice the ids
  while ((1 << bits) < 2 * n_obj) ++bits;
  const size_t smem = sort_smem(bits, n_obj);
  cudaError_t err = cudaFuncSetAttribute(
      pool_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  pool_sort_kernel<<<(unsigned)n_chunks, kSortThreads, smem, stream>>>(
      seg, p_total, obj, n_obj, bits, keys, pcount, totals, first);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int sum_smem = sizeof(SumSmem);
  err = cudaFuncSetAttribute(pool_sum_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sum_smem);
  if (err != cudaSuccess) return err;
  pool_sum_kernel<T>
      <<<dim3((unsigned)((d + kSlice - 1) / kSlice), (unsigned)n_chunks),
         kThreads, sum_smem, stream>>>(static_cast<const T*>(emb), d, keys,
                                       totals, n_obj, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pool_reduce_kernel<<<dim3((unsigned)n_obj, (unsigned)((d + 511) / 512)),
                       kReduceThreads, 0, stream>>>(
      part, pcount, first, (int)n_chunks, d, n_obj, sums, counts);
  return cudaGetLastError();
}

}  // namespace

// emb: [p_total, d] f32 (is_bf16 == 0) or bf16, 16-byte aligned, d % 8 == 0,
// 8 <= d <= 2048; seg: [p_total] int32; obj: [n_obj] int32, 1 <= n_obj <=
// 1024.  Workspace, G = ceil(p_total / 8192) <= 65535 chunks: keys [G *
// 8192], pcount [G, n_obj], totals [G], first [n_obj] int32, part [G,
// n_obj, d] f32 (written only where present).  Outputs: sums [n_obj, d]
// f32, counts [n_obj] f32.  p_total >= 1.
extern "C" int rc_masked_pooling(const void* emb, int is_bf16, const int* seg,
                                 const int* obj, long long p_total, int d,
                                 int n_obj, int* keys, int* pcount,
                                 int* totals, int* first, float* part,
                                 float* sums, float* counts, void* stream) {
  if (d % 8 != 0 || d < 8 || d > kMaxDims || p_total < 1 || n_obj < 1 ||
      n_obj > kMaxIds || (p_total + kChunk - 1) / kChunk > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(emb, seg, obj, p_total, d, n_obj,
                                         keys, pcount, totals, first, part,
                                         sums, counts, st)
                 : launch<float>(emb, seg, obj, p_total, d, n_obj, keys,
                                 pcount, totals, first, part, sums, counts,
                                 st);
}
