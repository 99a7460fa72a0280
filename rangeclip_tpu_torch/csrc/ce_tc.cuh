// The tensor-core CE kernels' block: two consumer warpgroups of 64 pixel
// rows each and a producer warpgroup driving the TMA ring of table chunks
// (common.cuh: tc::), the A tile of normalised rows, and the logits' main
// loop.  Shared by pixel_text_ce.cu (1-4 label slots, a packed table) and
// pixel_text_ce_slots.cu (16 slots, the gathered members).
#pragma once

#include "common.cuh"

namespace rc {
namespace tc {

// Reductions over the 4 lanes of a quad (a fragment row's 32 columns).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Registers a thread after the producer warpgroup gives its own up: 2 x
// 128 x 232 + 128 x 40 = 64,512 of the SM's 65,536 (the block's share at
// 384 threads and 168 registers, the compiler's cap).
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kTcThreads = rc::tc::kMaxWarpgroups * 128 + 128;

// Shared set-up of the kernels: the block's layout and its A tile.  The
// consumer warpgroups come first, then a producer warpgroup, whose first
// thread drives the ring; setmaxnreg moves the producer's registers to the
// consumers, which hold the logits, their step sums, delta and the d_emb
// chunk at once.
struct TcBlock {
  unsigned char* smem;
  uint32_t a;
  int nthreads, rows, k16, blocks_k, a_blocks, a_block_bytes, wg, wg_tid,
      lane;
  long long row0;
  rc::tc::Ring ring;
  long long row[2];  // this thread's two rows (consumers)

  // The A tile spans max(min_blocks, blocks_k) 64-dim blocks.
  __device__ __forceinline__ void init(unsigned char* raw, int d,
                                       int min_blocks) {
    using namespace rc::tc;
    smem = aligned_smem(raw);
    const int tid = threadIdx.x;
    nthreads = blockDim.x - 128;  // consumer threads; then the producer
    rows = nthreads / 128 * kWarpRows;
    k16 = (d + 15) / 16;
    blocks_k = (k16 + 3) / 4;
    a_blocks = max(min_blocks, blocks_k);
    a_block_bytes = rows * kRowBytes;
    a = smem_addr(smem);
    ring = Ring{a + a_blocks * a_block_bytes,
                a + a_blocks * a_block_bytes + kStages * kChunkBytes};
    row0 = (long long)blockIdx.x * rows;
    wg = tid >> 7;
    wg_tid = tid & 127;
    lane = tid & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row[h] = row0 + wg * kWarpRows + frag_row(h, wg_tid);
    if (tid == 0) ring.init(nthreads / 128);
    __syncthreads();
  }

  // The producer warpgroup gives up its registers; true for its threads.
  // The consumers take theirs.
  __device__ __forceinline__ bool producer() const {
    if ((int)threadIdx.x >= nthreads) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
      return true;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    return false;
  }
  __device__ __forceinline__ uint32_t a_rows() const {
    return a + wg * rc::tc::kWarpRows * rc::tc::kRowBytes;
  }
  // Past the A tile, the ring and its barriers.
  __device__ __forceinline__ unsigned char* extra() const {
    return smem + a_blocks * a_block_bytes +
           rc::tc::kStages * rc::tc::kChunkBytes + rc::tc::kBarrierBytes;
  }
};

// The cosine sums of this warpgroup's 64 rows against one class tile, the
// table's next blocks_k chunks in the ring from `chunk` on.  Each 16-dim
// step is a wgmma from zero whose result is added to acc in f32, rounded to
// nearest: the tensor cores' own accumulation truncates at every step, and
// over the 32 steps of D = 512 that moves the logits further from an f32
// sum than exact sums are, which flips more of delta's bf16 roundings.  A
// step's products are waited for before the next issues; the block's other
// warpgroup keeps the tensor cores busy.
__device__ __forceinline__ void tile_sims(const rc::tc::Ring& ring,
                                          uint32_t a, int a_block_bytes,
                                          int k16, int wg_tid, int& chunk,
                                          float (&acc)[64]) {
  using namespace rc::tc;
  const int blocks_k = (k16 + 3) / 4;
  for (int kb = 0; kb < blocks_k; ++kb, ++chunk) {
    const int s = chunk % kStages;
    mbar_wait(ring.full(s), (chunk / kStages) & 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (kb * 4 + k >= k16) break;
      float part[64];
      fence_regs(part);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_m64n128k16(part, sw128_desc(a + kb * a_block_bytes + k * 32),
                       sw128_desc(ring.stage(s) + k * 32), 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(part);
      const bool first = kb == 0 && k == 0;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = first ? part[i] : acc[i] + part[i];
    }
    if (wg_tid == 0) mbar_arrive(ring.empty(s));
  }
}

}  // namespace tc
}  // namespace rc
