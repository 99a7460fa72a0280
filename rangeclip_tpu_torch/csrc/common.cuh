// Shared device helpers for the port's Hopper kernels.
//
// The packed selection key is the one of rangeclip_tpu/ops/pallas/score_topk.py
// (_select_kernel_packed): a bf16 score widened to f32 has its low 16 mantissa
// bits zero, so the sign-magnitude -> two's-complement map of its bits is a
// monotone int32 key with 16 free low bits.  Those bits carry 0xFFFF - id, so
// equal scores break ties to the smallest id.  Dead slots (id -1) get INT_MIN.
#pragma once

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace rc {

constexpr float kNegInf = -1e30f;  // the mask value of the JAX kernels

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Key of a bf16 value (already widened to f32) at global class id `id`
// (0 <= id < 2^16); score_topk.py:159-164.
__device__ __forceinline__ int packed_key(float widened_bf16, int id) {
  const int b = __float_as_int(widened_bf16);
  return (b ^ ((b >> 31) & 0x7FFF0000)) + (0xFFFF - id);
}

// Inverse of packed_key: the id and the exact f32 bits of the stored bf16
// score; INT_MIN (no valid slot left) decodes to -1 and kNegInf
// (score_topk.py:176-187).
__device__ __forceinline__ void decode_packed(int m, int* id, float* value) {
  if (m == INT_MIN) {
    *id = -1;
    *value = kNegInf;
    return;
  }
  const int g = 0xFFFF - (m & 0xFFFF);
  const int bu = (m + g) & -65536;
  const int vb = (bu ^ ((bu >> 31) & 0x7FFFFFFF)) & -65536;
  *id = g;
  *value = __int_as_float(vb);
}

// Insert `key` into the descending register list keys[0..K).
template <int K>
__device__ __forceinline__ void insert_key(int (&keys)[K], int key) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int hi = max(keys[i], key);
    key = min(keys[i], key);
    keys[i] = hi;
  }
}

// (a_v, a_id) ranks above (b_v, b_id): larger value, ties to the smaller id
// (the knockout selectors' order, score_topk.py:91-120).
__device__ __forceinline__ bool better(float a_v, int a_id, float b_v,
                                       int b_id) {
  return a_v > b_v || (a_v == b_v && a_id < b_id);
}

// Insert (cv, cid) into the register list (v, id)[0..K), kept in `better`
// order.  Empty entries are (-inf, INT_MAX).
template <int K>
__device__ __forceinline__ void insert_pair(float (&v)[K], int (&id)[K],
                                            float cv, int cid) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (better(cv, cid, v[i], id[i])) {
      const float tv = v[i];
      const int ti = id[i];
      v[i] = cv;
      id[i] = cid;
      cv = tv;
      cid = ti;
    }
  }
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 round_to(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}

// Eight consecutive values through 16-byte accesses (p 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load8(const T* p, T (&v)[8]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < 8 / kPer; ++q) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[q];
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[q * kPer + i] = t[i];
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const T (&v)[8]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < 8 / kPer; ++q) {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < kPer; ++i) t[i] = v[q * kPer + i];
    reinterpret_cast<uint4*>(p)[q] = u;
  }
}

// Streaming multiprocessors of the current device (0 if unknown): bounds
// the grids whose blocks each hold a workspace slice.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// Tensor-core scoring with a register top-k epilogue (pixel_text_topk.cu's
// bf16 path and conv_score_topk.cu; pixel_text_ce.cu's tensor-core kernels
// use the ring, the layout and the A-tile build, with a producer warpgroup
// and their own main loop).
//
// Both kernels score a tile of rows A [rows, K] against a table B [R, K],
// both bf16 and K-major, with f32 sums, and keep a top-k of each row.  A
// block has one or two consumer warpgroups (128 threads each), which own 64
// rows of A each, resident in shared memory, and one producer warp.  The
// producer streams B through a ring of kStages shared-memory stages, one
// [kTileN rows, 64 dims] chunk at a time, with TMA (cp.async.bulk.tensor,
// zero-filled past the table's rows and dims): a `full` mbarrier per stage
// says its bytes have landed, an `empty` one that every consumer warpgroup
// is done with it.  Each chunk is at most four wgmma m64n128k16 products
// into 64 f32 accumulators per thread, left in flight while the next chunk
// is waited for; after the last dim chunk of a class tile the accumulators
// go straight into per-row register lists (the [rows, R] scores never
// touch memory).
//
// Shared-memory layout of both operands: blocks of 64 dims (128 bytes a row)
// with the 128-byte swizzle that wgmma's SW128 K-major descriptor reads and
// TMA's SWIZZLE_128B writes: the 16-byte chunk j of row r sits at r * 128 +
// ((j ^ (r % 8)) * 16), and each block starts on a 1024-byte boundary.  The
// k-th 16-dim step of a block is the same descriptor with its start address
// advanced by 32 * k bytes.
//
// Accumulator fragment of m64nNk16 (f32): register i of lane `lane` in warp
// w of the warpgroup holds row 16 * w + lane / 4 + 8 * ((i / 2) % 2) and
// column 8 * (i / 4) + 2 * (lane % 4) + i % 2.  So a thread holds two rows
// (the two halves below), and the 4 threads of a quad hold the same rows.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kTileN = 128;                 // table rows per class tile
constexpr int kBlockDims = 64;              // dims per swizzled block
constexpr int kRowBytes = 128;              // one row of a block
constexpr int kChunkBytes = kTileN * kRowBytes;  // one B stage
constexpr int kStages = 4;                  // B ring depth
constexpr int kWarpRows = 64;               // A rows per warpgroup
constexpr int kAlign = 1024;                // swizzle-atom alignment
constexpr int kBarrierBytes = 2 * kStages * 8;  // full and empty mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk j (0..7) of row r inside a swizzled block.
__device__ __forceinline__ int swizzle(int r, int j) {
  return r * kRowBytes + ((j ^ (r & 7)) << 4);
}

// SW128 K-major shared-memory descriptor: start address >> 4 in bits 0-13,
// leading byte offset 1 (unused for swizzled K-major), stride byte offset
// 1024 >> 4 (the next group of 8 rows) in bits 32-45, layout 1 (128-byte
// swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// 16-byte global -> shared copy; zero-fills when !valid (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// The same through L1, for data that the block reads again (im2col taps).
__device__ __forceinline__ void cp_async16_l1(uint32_t dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Close the thread's open cp.async copies into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of the consumer warpgroups only (the producer warp is busy).
__device__ __forceinline__ void consumer_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The mbarrier gets one arrival (counted in its init) once every cp.async
// this thread issued before has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `parity` to complete.  A wait that outlasts about
// ten seconds traps, so a broken protocol fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

// TMA: the [kTileN rows, 64 dims] box at (dim k0, row r0) of the tensor
// map's 2-D bf16 matrix into shared memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k0, int r0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(r0)
      : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] * B[128 x 16]^T, both from shared memory; scale_d == 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= A[64 x 16] * B[64 x 16]^T, both from shared memory: the same
// fragment layout over 64 columns (32 registers).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// One wgmma of N = 128 or 64 columns.
template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t a,
                                          uint64_t b, int scale_d) {
  if constexpr (N == 128) {
    wgmma_m64n128k16(d, a, b, scale_d);
  } else {
    static_assert(N == 64, "wgmma_k16: N is 64 or 128");
    wgmma_m64n64k16(d, a, b, scale_d);
  }
}

// Two floats as a bf16 pair, the first in the low half (the lower address).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ int frag_col(int i, int lane) {
  return ((i >> 2) << 3) + ((lane & 3) << 1) + (i & 1);
}

// Row of this thread's accumulator half (0 or 1) within its warpgroup.
__device__ __forceinline__ int frag_row(int half, int wg_tid) {
  return ((wg_tid >> 5) << 4) + ((wg_tid & 31) >> 2) + (half << 3);
}

// The dead-slot mask of one class tile for this thread: bit 2 * nb + e
// stands for column c0 + 8 * nb + 2 * (lane % 4) + e (registers i with
// i / 4 == nb and i % 2 == e), set where ids[col] < 0 or col >= rows.  The
// 32 loads are issued together.
__device__ __forceinline__ unsigned dead_mask(const int* __restrict__ ids,
                                              int c0, int rows, int lane) {
  int v[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int col = c0 + (b >> 1) * 8 + ((lane & 3) << 1) + (b & 1);
    v[b] = __ldg(ids + min(col, rows - 1));
  }
  unsigned m = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int col = c0 + (b >> 1) * 8 + ((lane & 3) << 1) + (b & 1);
    m |= (unsigned)(col >= rows || v[b] < 0) << b;
  }
  return m;
}

__device__ __forceinline__ int mask_bit(int i) {
  return ((i >> 2) << 1) + (i & 1);
}

// The shared-memory ring of B and its barriers.
struct Ring {
  uint32_t stages;  // kStages * kChunkBytes, 1024-aligned
  uint32_t bars;    // full[kStages], then empty[kStages]

  __device__ __forceinline__ uint32_t stage(int s) const {
    return stages + s * kChunkBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (kStages + s);
  }

  // One thread, before the block's first barrier.
  __device__ __forceinline__ void init(int consumer_warpgroups) const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumer_warpgroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The producer: every chunk of every class tile of the [rows, dims]
  // matrix behind `map`, in the consumers' order (score_tiles: tiles in
  // groups of `group`, dims-major within a group, its tiles inner; tile-
  // major for one), as the ring's chunks first, first + 1, ...; returns the
  // number after the last (a kernel that streams several matrices chains
  // the calls).
  __device__ __forceinline__ int produce(const CUtensorMap* map, int rows,
                                         int k16, int first = 0,
                                         int group = 1) const {
    const int blocks_k = (k16 + 3) / 4;
    const int tiles = (rows + kTileN - 1) / kTileN;
    int i = first;
    for (int t0 = 0; t0 < tiles; t0 += group) {
      const int n = min(group, tiles - t0);
      for (int kb = 0; kb < blocks_k; ++kb) {
        for (int u = 0; u < n; ++u, ++i) {
          const int s = i % kStages;
          if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
          mbar_expect_tx(full(s), kChunkBytes);
          tma_load(stage(s), map, kb * kBlockDims, (t0 + u) * kTileN,
                   full(s));
        }
      }
    }
    return i;
  }
};

// The consumers' main loop, shared by the kernels: every class tile of B
// against this warpgroup's 64 rows of A.  `a` is the shared address of
// this warpgroup's rows in dim block 0, `a_block_bytes` the distance
// between dim blocks; k16 is the number of 16-dim steps (dims rounded up to
// 16, zero-filled past the end in both operands).  A is in shared memory
// and fenced for the async proxy.  The tiles go in groups of G, each tile
// of a group into accumulators of its own, the group's chunks dims-major
// with its tiles inner (Ring::produce's order): a kernel that needs
// several tiles' sums at once (head_topk.cu's conv, whose epilogue needs
// every dim of a row) takes them as one group.  prep(t) runs as a group
// starts, for each of its tiles t (their loads have the products to land
// in); after the group's last dim block, epi(acc, t) takes tile t's
// accumulators (G = 1), or epi(acc, t0) the group's (acc[u] for tile t0 +
// u, u < min(G, tiles - t0)).  Chunk i's products stay in flight while
// chunk i + 1 is waited for; a warpgroup releases a stage once the
// products that read it are done.  N = 128 scores a stage's 128 rows; N =
// 64 the 64 at `b_offset` bytes into it (two warpgroups sharing one A tile
// take a half each).  The tiles are the ring's chunks first, first + 1,
// ...; returns the number after the last.
template <int N = kTileN, int G = 1, class Prep, class Epi>
__device__ __forceinline__ int score_tiles(const Ring& ring, uint32_t a,
                                           int a_block_bytes, int rows,
                                           int k16, int wg_tid, Prep&& prep,
                                           Epi&& epi, int first = 0,
                                           uint32_t b_offset = 0) {
  const int blocks_k = (k16 + 3) / 4;
  const int tiles = (rows + kTileN - 1) / kTileN;
  float acc[G][N / 2];
  int i = first;
  int released = first;  // chunks whose stage this warpgroup gave back
  for (int t0 = 0; t0 < tiles; t0 += G) {
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (t0 + u < tiles) prep(t0 + u);
    for (int kb = 0; kb < blocks_k; ++kb) {
      const int steps = min(4, k16 - kb * 4);
      const uint32_t a_kb = a + kb * a_block_bytes;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (t0 + u < tiles) {
          const int s = i % kStages;
          mbar_wait(ring.full(s), (i / kStages) & 1);
          const uint32_t b = ring.stage(s) + b_offset;
          fence_regs(acc[u]);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k < steps)
              wgmma_k16<N>(acc[u], sw128_desc(a_kb + k * 32),
                           sw128_desc(b + k * 32), kb > 0 || k > 0);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          for (; released < i; ++released)
            if (wg_tid == 0) mbar_arrive(ring.empty(released % kStages));
          ++i;
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    for (; released < i; ++released)
      if (wg_tid == 0) mbar_arrive(ring.empty(released % kStages));
#pragma unroll
    for (int u = 0; u < G; ++u) fence_regs(acc[u]);
    if constexpr (G == 1) {
      epi(acc[0], t0);
    } else {
      epi(acc, t0);
    }
  }
  return i;
}

// The (x, y) of pixels p0 .. p0 + rows (flattened (b, y, x) order, npix
// of them) into `coords`, y = -h past the last pixel (every tap then
// falls outside the image), by `nthreads` threads, `thread` being the
// caller's index among them.  The caller synchronises before im2col reads
// them.
__device__ __forceinline__ void pixel_coords(int2* coords, int p0, int rows,
                                             int npix, int h, int w,
                                             int nthreads, int thread) {
  for (int r = thread; r < rows; r += nthreads) {
    const int p = p0 + r;
    coords[r] = p < npix ? make_int2(p % w, (p / w) % h) : make_int2(0, -h);
  }
}

// The im2col A tile of pixel rows p0 .. p0 + rows of bf16 features [npix,
// c_in] (npix = batch * h * w < 2^31, c_in % 8 == 0), each row's (x, y) in
// `coords` (pixel_coords), issued by `nthreads` threads, `thread` being
// the caller's index among them, a warp per pixel: row r gets pixel p0 +
// r's 9 taps x c_in channels, K ordered (dy, dx, c) as the weight rows are,
// copied with cp.async through L1 (neighbouring pixels share their taps)
// into the swizzled layout at `a`.  Taps outside the image (the SAME
// border), rows past npix and K past 9 * c_in up to k16 * 16 are zero-
// filled by the copies themselves.  The caller commits, waits and fences.
__device__ __forceinline__ void im2col(uint32_t a, int a_block_bytes,
                                       const __nv_bfloat16* __restrict__ feats,
                                       int p0, int rows,
                                       const int2* __restrict__ coords, int h,
                                       int w, int c_in, int k16, int nthreads,
                                       int thread) {
  const int lane = thread & 31;
  const int chunks = k16 * 2;   // 16-byte chunks of a padded row
  const int groups = c_in / 8;  // 16-byte chunks of one tap
  for (int r = thread >> 5; r < rows; r += nthreads >> 5) {
    const int2 xy = coords[r];
    for (int j = lane; j < chunks; j += 32) {
      const int tap = j / groups;
      const int dy = tap / 3 - 1;
      const int dx = tap - 3 * (tap / 3) - 1;
      const bool ok = j < 9 * groups && xy.x + dx >= 0 && xy.x + dx < w &&
                      xy.y + dy >= 0 && xy.y + dy < h;
      const long long q = (long long)p0 + r + dy * w + dx;  // the tap's pixel
      cp_async16_l1(a + (j >> 3) * a_block_bytes + swizzle(r, j & 7),
                    ok ? feats + q * c_in + (j - tap * groups) * 8 : feats,
                    ok);
    }
  }
}

// The A tile of pixel rows row0 .. row0 + rows of the un-normalised bf16
// matrix x [n, d] (16-byte aligned, d % 8 == 0), built by the `nthreads`
// consumer threads: the rows are copied once (cp.async) into the swizzled
// layout at `a` (`smem` is its generic address), rows past n and dims past
// d zero-filled up to k16 * 16 dims; then 8 lanes per row sum x^2 in f64
// from that copy and rewrite the row in place as bf16(x * rs), rs =
// 1/sqrt(max(sum x^2, 1e-24)) rounded once to f32 (rs_out[r] gets it when
// not NULL).  Ends fenced for the async proxy and synchronised.
__device__ __forceinline__ void normalized_rows(
    unsigned char* smem, uint32_t a, int a_block_bytes, int rows,
    const __nv_bfloat16* __restrict__ x, long long n, int d, long long row0,
    int nthreads, float* rs_out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunks = (d + 15) / 16 * 2;  // 16-byte chunks of a padded row
  for (int r = warp; r < rows; r += nthreads / 32) {
    for (int j = lane; j < chunks; j += 32) {
      const bool ok = row0 + r < n && j * 8 < d;
      cp_async16(a + (j >> 3) * a_block_bytes + swizzle(r, j & 7),
                 ok ? x + (row0 + r) * d + j * 8 : x, ok);
    }
  }
  cp_async_wait_all();
  consumer_sync(nthreads);
  const int sub = lane & 7;
  for (int r = warp * 4 + (lane >> 3); r < rows; r += nthreads / 8) {
    double sq = 0.0, sq2 = 0.0;
    for (int j = sub; j < d / 8; j += 8) {
      __nv_bfloat16 v[8];
      load8(reinterpret_cast<const __nv_bfloat16*>(
                smem + (j >> 3) * a_block_bytes + swizzle(r, j & 7)),
            v);
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        const double p = __bfloat162float(v[i]);
        const double q = __bfloat162float(v[i + 1]);
        sq = fma(p, p, sq);
        sq2 = fma(q, q, sq2);
      }
    }
    sq += sq2;
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float scale = (float)(1.0 / sqrt(fmax(sq, 1e-24)));
    if (rs_out != nullptr && sub == 0) rs_out[r] = scale;
    for (int j = sub; j < d / 8; j += 8) {
      __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(
          smem + (j >> 3) * a_block_bytes + swizzle(r, j & 7));
      __nv_bfloat16 v[8];
      load8(p, v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = __float2bfloat16_rn(__bfloat162float(v[i]) * scale);
      store8(p, v);
    }
  }
  fence_proxy_async();
  consumer_sync(nthreads);
}

// The dynamic shared memory of `a_rows` rows of A over k16 steps, the B
// ring and its barriers, and `row_extra` bytes per row, plus slack to align
// the base to kAlign.
inline size_t smem_bytes(int a_rows, int k16, int row_extra = 0) {
  const int blocks_k = (k16 + 3) / 4;
  return (size_t)blocks_k * a_rows * kRowBytes + kStages * kChunkBytes +
         kBarrierBytes + (size_t)a_rows * row_extra + kAlign;
}

constexpr int kMaxWarpgroups = 2;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use

// Consumer warpgroups of a block whose A tile spans k16 16-dim steps: two
// while their rows fit in shared memory beside the ring, else one; 0 when
// not even 64 rows fit.
inline int warpgroups_for(int k16, int row_extra = 0) {
  for (int wgs = kMaxWarpgroups; wgs > 0; --wgs)
    if (smem_bytes(wgs * kWarpRows, k16, row_extra) <= kMaxSmem) return wgs;
  return 0;
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t off =
      (kAlign - (smem_addr(raw) & (kAlign - 1))) & (kAlign - 1);
  return raw + off;
}

// The tensor map of a [rows, dims] row-major bf16 matrix (dims % 8 == 0,
// 16-byte aligned) in [kTileN, 64] boxes with the 128-byte swizzle; the
// encoder, cuTensorMapEncodeTiled, is looked up once through the runtime.
inline cudaError_t make_tensor_map(CUtensorMap* map, const void* base,
                                   int rows, int dims) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dim[2] = {(cuuint64_t)dims, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)dims * 2};
  const cuuint32_t box[2] = {kBlockDims, kTileN};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dim,
      stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tc

// Per-row register top-k lists of the tensor-core epilogue, for the two
// rows a thread holds.  push() is branchless: every list entry is computed
// from the old entries at depth two or three, with no insertion chain and
// no divergence between the lanes of a warp (the epilogue's cost is its
// instruction count).  After the last class tile, merge_quad() merges the
// lists of the 4 threads of a quad (the same rows, disjoint columns) with
// two butterfly shuffles; the orders are total, so the merge is exact.

// (value, id) lists in `better` order; empty entries are (-inf, INT_MAX).
// push() compares values only and ranks a tie below the entries already
// held: exact in `better` order when a thread pushes its ids in ascending
// order, as the tensor-core epilogue does (ids ascend with the column).
template <int K>
struct PairTopK {
  float v[2][K];
  int id[2][K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int t = 0; t < K; ++t) {
        v[h][t] = -CUDART_INF_F;
        id[h][t] = INT_MAX;
      }
  }

  __device__ __forceinline__ void push(int h, float cv, int cid) {
    bool gt[K];  // cv ranks above entry t (monotone in t)
#pragma unroll
    for (int t = 0; t < K; ++t) gt[t] = cv > v[h][t];
#pragma unroll
    for (int t = K - 1; t > 0; --t) {
      const float sv = gt[t - 1] ? v[h][t - 1] : cv;
      const int sid = gt[t - 1] ? id[h][t - 1] : cid;
      v[h][t] = gt[t] ? sv : v[h][t];
      id[h][t] = gt[t] ? sid : id[h][t];
    }
    v[h][0] = gt[0] ? cv : v[h][0];
    id[h][0] = gt[0] ? cid : id[h][0];
  }

  // Insertion in full `better` order, for lists from other threads.
  __device__ __forceinline__ void insert(int h, float cv, int cid) {
    if (better(cv, cid, v[h][K - 1], id[h][K - 1]))
      insert_pair(v[h], id[h], cv, cid);
  }

  __device__ __forceinline__ void merge_quad() {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ov[K];
        int oid[K];
#pragma unroll
        for (int t = 0; t < K; ++t) {
          ov[t] = __shfl_xor_sync(0xffffffffu, v[h][t], off);
          oid[t] = __shfl_xor_sync(0xffffffffu, id[h][t], off);
        }
#pragma unroll
        for (int t = 0; t < K; ++t) insert(h, ov[t], oid[t]);
      }
  }
};

// Packed-key lists (descending); empty entries are INT_MIN.
template <int K>
struct KeyTopK {
  int key[2][K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int t = 0; t < K; ++t) key[h][t] = INT_MIN;
  }

  // Entry t becomes max(entry t, min(entry t - 1, k)); INT_MIN is a no-op.
  __device__ __forceinline__ void push(int h, int k) {
#pragma unroll
    for (int t = K - 1; t > 0; --t)
      key[h][t] = max(key[h][t], min(key[h][t - 1], k));
    key[h][0] = max(key[h][0], k);
  }

  __device__ __forceinline__ void merge_quad() {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int other[K];
#pragma unroll
        for (int t = 0; t < K; ++t)
          other[t] = __shfl_xor_sync(0xffffffffu, key[h][t], off);
#pragma unroll
        for (int t = 0; t < K; ++t) push(h, other[t]);
      }
  }
};

// ---------------------------------------------------------------------------
// CUDA-core f32 scoring of normalised pixel rows against a dim-major table
// (pixel_text_topk.cu's fp32 kernel and pixel_text_ce.cu's member-only
// forward; they differ only in their epilogues).
//
// A block of 256 threads (two per SM) owns 128 pixel rows of an [n, d]
// field (f32, or bf16 widened) and walks the first c columns of a [d, ldt]
// f32 table in class tiles of 128.  (class tile, 32-dim chunk) steps stream
// through a three-stage shared-memory ring by cp.async with no register
// staging: the pixel chunk row-major in the field's dtype (f32 rows
// XOR-swizzled), the table chunk dim-major in f32, zero-filled past n, c
// and d.  The steps run on across class tiles, so the next tile's first
// copies are in flight while a tile's epilogue runs; the pixel tile is read
// again for each class tile (from L2 mostly) and never re-scaled.  The 8
// warps tile the 128 x 128 sums as 4 (rows) x 2 (class halves of 64), a
// warp's lanes as 4 x 8; each thread holds 8 rows x 8 classes, and per 4
// dims 8 float4 reads of pixel rows and 8 of table classes feed 256 FMAs,
// one shared-memory wavefront each.  One barrier per step.  A class half
// with no column below c skips its products; each SM sub-partition (warp %
// 4) holds one warp of each half, so a ragged last tile of at most 64
// columns halves the work of every sub-partition.
//
// Row scales rs = 1/sqrt(max(sum x^2, 1e-24)), the sum in f64 and rounded
// once.  f32: the scale moves past the sum (rs * sum(x * t)); during the
// first class tile each thread sums x^2 of half a row's dims from the
// landed chunks.  bf16 keeps the TPU kernels' rounding point: a first pass
// over the rows gives rs (warp-reduced, overlapping the first copies), and
// each landed chunk is rounded to bf16(x * rs) and widened before its
// product.  After each class tile's last chunk the epilogue gets the sums
// (f32: unscaled) and the row scales.
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 256;
constexpr int kRows = 128;   // pixel rows per block
constexpr int kCols = 128;   // classes per tile
constexpr int kChunk = 32;   // dims per ring stage: an f32 row of 128 bytes
constexpr int kStages = 3;   // ring depth: two steps in flight

// Dynamic shared memory of the loop: the ring (each stage a pixel chunk
// [kRows, kChunk] in the field's dtype, f32 rows swizzled, then a table
// chunk [kChunk, kCols] f32), for bf16 the chunk rounded and widened to f32
// (swizzled), and the row scales.  A kernel's own region starts at kEnd.
template <typename T>
struct Layout {
  static constexpr bool kRoundFirst = sizeof(T) == 2;
  static constexpr int kRowBytes = kChunk * (int)sizeof(T);
  static constexpr int kABytes = kRows * kRowBytes;
  static constexpr int kStageBytes = kABytes + kChunk * kCols * 4;
  static constexpr int kWideOffset = kStages * kStageBytes;
  static constexpr int kScaleOffset =
      kWideOffset + (kRoundFirst ? kRows * kChunk * 4 : 0);
  static constexpr int kEnd = kScaleOffset + kRows * 4;
};

// Byte offset of the 16-byte piece q (4 dims) of f32 row r in a chunk: the
// pieces of a row are XOR-swizzled by r % 8, so that the float4 reads of
// rows r .. r+3 at one dim fall in distinct banks (and a row's 8 pieces
// still fill one 128-byte line).
__device__ __forceinline__ int swz(int r, int q) {
  return r * kChunk * 4 + ((q ^ (r & 7)) << 4);
}

// Thread roles.  The 8 warps tile the block's 128 x 128 sums as 4 (rows) x
// 2 (class halves); a warp's lanes as 4 (wy) x 8 (wx); each thread holds 8
// rows (row0 + 4 i) and 8 classes (col0 + col_of(j, wx)).  A quarter warp
// (the 8 lanes of one wy) holds the same 8 rows, and lane wx of it owns
// row row0 + 4 wx for the epilogues' per-row state.  A quarter warp then
// reads one 128-byte line of the table chunk, and the four rows a warp
// reads at one dim fall in distinct banks (swz), so every shared load is
// one wavefront.
struct Roles {
  int row0;  // wm * 32 + wy
  int col0;  // wn * 64
  int wx, wn, lane;
};

__device__ __forceinline__ Roles roles_of(int tid) {
  Roles r;
  const int warp = tid >> 5;
  r.lane = tid & 31;
  r.wx = r.lane & 7;
  r.wn = warp >> 2;  // each sub-partition (warp % 4) has both halves
  r.row0 = (warp & 3) * 32 + (r.lane >> 3);
  r.col0 = r.wn * 64;
  return r;
}

__device__ __forceinline__ int col_of(int j, int wx) {
  return (j < 4 ? 0 : 32) + wx * 4 + (j & 3);
}

// acc[i][j] += sum over the chunk's dims of A[row0 + 4 i][k] * B[k][col]:
// per 4 dims, 8 float4 reads of pixel rows (swz) and 2 float4 reads of
// table classes per dim feed 256 FMAs.
__device__ __forceinline__ void product(const float* __restrict__ a,
                                        const float* __restrict__ b,
                                        float (&acc)[8][8], const Roles& r) {
  const char* ar = reinterpret_cast<const char*>(a) + r.row0 * kChunk * 4;
  // row row0 + 4 i is wy + 4 (i % 2) modulo 8
  const int wy16 = (r.row0 & 7) << 4;
  const float* br = b + r.col0 + r.wx * 4;
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(
          ar + 4 * i * kChunk * 4 + ((((q ^ ((i & 1) << 2))) << 4) ^ wy16));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(br + (4 * q + kk) * kCols);
      const float4 b1 =
          *reinterpret_cast<const float4*>(br + (4 * q + kk) * kCols + 32);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = kk == 0   ? av[i].x
                        : kk == 1 ? av[i].y
                        : kk == 2 ? av[i].z
                                  : av[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
      }
    }
  }
}

// Thread t's share of sum x^2 of row t / 2 in an f32 chunk (half its
// dims, f64).
__device__ __forceinline__ double chunk_sumsq(const float* __restrict__ a,
                                              int tid) {
  const char* p = reinterpret_cast<const char*>(a);
  const int r = tid >> 1;
  double s = 0.0;
#pragma unroll
  for (int q = 0; q < kChunk / 8; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(
        p + swz(r, (tid & 1) * (kChunk / 8) + q));
    s = fma((double)v.x, (double)v.x, s);
    s = fma((double)v.y, (double)v.y, s);
    s = fma((double)v.z, (double)v.z, s);
    s = fma((double)v.w, (double)v.w, s);
  }
  return s;
}

// bf16: thread t rounds x * rs of its half of row t / 2 to bf16 (the TPU
// kernels' rounding point) and writes it widened to the f32 chunk.
template <typename T>
__device__ __forceinline__ void round_chunk(const T* __restrict__ raw,
                                            float* __restrict__ wide,
                                            const float* __restrict__ rs,
                                            int tid) {
  const int r = tid >> 1;
  const float scale = rs[r];
  char* w = reinterpret_cast<char*>(wide);
#pragma unroll
  for (int q = 0; q < kChunk / 16; ++q) {
    const int dim = (tid & 1) * (kChunk / 2) + q * 8;
    T v[8];
    load8(raw + r * kChunk + dim, v);
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = to_float(round_to(to_float(v[e]) * scale, T()));
    *reinterpret_cast<float4*>(w + swz(r, dim / 4)) =
        make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(w + swz(r, dim / 4 + 1)) =
        make_float4(o[4], o[5], o[6], o[7]);
  }
}

// The block's loop: rows base .. base + kRows of `field` [n, d] (row
// stride ldf, 16-byte aligned rows) against columns [0, c) of `table_t`
// [d, ldt] f32 (ldt % 4 == 0), class tile by class tile.  After a tile's
// last chunk, epilogue(acc, rs, tile) gets the thread's 8 x 8 sums (rows
// row0 + 4 i, columns tile * kCols + col0 + col_of(j, wx); columns >= c
// hold no meaning) and the row scales in shared memory; the sums are
// zeroed after.  No tile runs when c == 0.  Past d the table is
// zero-filled, the field only in whole 16-byte pieces: a field row's piece
// that straddles d (d not a multiple of 4 f32 or 8 bf16 values) is read
// whole, so its values past d must be finite (they meet zeros).
template <typename T, typename Epilogue>
__device__ __forceinline__ void score_tiles(unsigned char* smem,
                                            const T* __restrict__ field,
                                            long long ldf, long long base,
                                            const float* __restrict__ table_t,
                                            int ldt, int c, long long n,
                                            int d, const Roles& roles,
                                            Epilogue&& epilogue) {
  using L = Layout<T>;
  float* rs = reinterpret_cast<float*>(smem + L::kScaleOffset);
  float* wide = reinterpret_cast<float*>(smem + L::kWideOffset);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunks = (d + kChunk - 1) / kChunk;
  const int steps = chunks * ((c + kCols - 1) / kCols);

  // Copies: step s (class tile s / chunks, dim chunk s % chunks) into stage
  // s % kStages, 16-byte pieces zero-filled past n, c and d, one commit
  // group per step (empty past the last).  Each thread's sources and places
  // are fixed but for the step's offsets.
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kRowPieces = kChunk / kPer;
  constexpr int kRowStep = kThreads / kRowPieces;  // a thread's rows apart
  constexpr int kAIters = kRows / kRowStep;
  const int a_row = tid / kRowPieces;
  const int a_dim = (tid % kRowPieces) * kPer;
  const T* a_src = field + (base + a_row) * ldf + a_dim;
  unsigned a_ok = 0;
#pragma unroll
  for (int i = 0; i < kAIters; ++i)
    if (base + a_row + i * kRowStep < n) a_ok |= 1u << i;
  // f32 rows are swizzled (swz); a thread's rows are 32 apart, the same % 8
  const uint32_t a_dst =
      tc::smem_addr(smem) +
      (L::kRoundFirst ? a_row * L::kRowBytes + (tid % kRowPieces) * 16
                      : swz(a_row, tid % kRowPieces));
  const int b_dim = tid >> 5;
  const int b_col = (tid & 31) * 4;
  const float* b_src = table_t + (long long)b_dim * ldt + b_col;
  const uint32_t b_dst = tc::smem_addr(smem) + L::kABytes + tid * 16;
  int next_tile = 0, next_dim0 = 0;
  auto copy_step = [&](int s) {
    if (s < steps) {
      const uint32_t stage = (s % kStages) * L::kStageBytes;
      const bool dim_ok = next_dim0 + a_dim < d;
#pragma unroll
      for (int i = 0; i < kAIters; ++i) {
        const bool ok = dim_ok && ((a_ok >> i) & 1u);
        tc::cp_async16(
            a_dst + stage + i * kRowStep * L::kRowBytes,
            ok ? a_src + (long long)i * kRowStep * ldf + next_dim0 : field,
            ok);
      }
      const bool col_ok = next_tile * kCols + b_col < c;
      const float* b = b_src + (long long)next_dim0 * ldt + next_tile * kCols;
#pragma unroll
      for (int i = 0; i < kChunk / 8; ++i) {
        const bool ok = col_ok && next_dim0 + b_dim + 8 * i < d;
        tc::cp_async16(b_dst + stage + i * 8 * kCols * 4,
                       ok ? b + (long long)8 * i * ldt : table_t, ok);
      }
      next_dim0 += kChunk;
      if (next_dim0 >= d) {
        next_dim0 = 0;
        ++next_tile;
      }
    }
    tc::cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) copy_step(s);

  if constexpr (L::kRoundFirst) {
    // bf16 rounds x * rs before the product, so the scales come first: a
    // pass over the rows (f64 sums, warp-reduced), overlapping the copies.
    constexpr int kRowsPerWarp = kRows / (kThreads / 32);
    for (int r = warp * kRowsPerWarp; r < (warp + 1) * kRowsPerWarp; ++r) {
      double sq = 0.0;
      if (base + r < n) {
        for (int g = lane * 8; g < d; g += 256) {
          T v[8];
          load8(field + (base + r) * ldf + g, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const double x = to_float(v[e]);
            sq = fma(x, x, sq);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      if (lane == 0) rs[r] = (float)(1.0 / sqrt(fmax(sq, 1e-24)));
    }
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  double sq = 0.0;  // f32: this thread's share of sum x^2 of row tid / 2
  int tile = 0, chunk = 0;
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed everywhere; stage (s - 1) is free
    copy_step(s + kStages - 1);
    const unsigned char* stage = smem + (s % kStages) * L::kStageBytes;
    const float* a;
    if constexpr (L::kRoundFirst) {
      round_chunk(reinterpret_cast<const T*>(stage), wide, rs, tid);
      __syncthreads();
      a = wide;
    } else {
      a = reinterpret_cast<const float*>(stage);
      if (tile == 0) sq += chunk_sumsq(a, tid);
    }
    const float* b = reinterpret_cast<const float*>(stage + L::kABytes);
    if (tile * kCols + roles.col0 < c)  // the half holds live classes
      product(a, b, acc, roles);
    if (++chunk == chunks) {
      if constexpr (!L::kRoundFirst) {
        if (tile == 0) {  // rs[r] = 1/sqrt(max(sum x^2, 1e-24))
          sq += __shfl_xor_sync(0xffffffffu, sq, 1);
          if ((tid & 1) == 0)
            rs[tid >> 1] = (float)(1.0 / sqrt(fmax(sq, 1e-24)));
          __syncthreads();
        }
      }
      epilogue(acc, rs, tile);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      chunk = 0;
      ++tile;
    }
  }
}

}  // namespace simt

}  // namespace rc
