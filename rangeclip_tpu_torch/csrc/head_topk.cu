// The whole segmentation head: 3x3 SAME conv of the pre-head features to
// the embedding field, per-pixel L2 normalisation, scoring
// against the normalised text table, masked top-k.
//
// Replaces rangeclip_tpu/ops/pallas/head_topk.py: _head_kernel, entry point
// fused_head_score_topk.  Same contract, at the TPU kernel's rounding
// points: the conv of the features (f32 or bf16) with the bias-free
// weights [9 * C_in, D] (rows ordered (dy, dx, c_in), in the features'
// dtype, zero borders) accumulated in f32; s = sum f^2 in f32; the
// embedding f * (1 / sqrt(max(s, 1e-24))) rounded to the features' dtype;
// scores against the table (in the features' dtype) summed in f32; classes
// off the mask score -1e30; top-k with ties to the smallest class id.  The
// TPU kernel's knockout keeps masked and picked classes at -1e30 and
// competing, so once the live classes are picked every later pick is
// (id 0, -1e30); these kernels never insert a masked class and fill the
// picks left empty with exactly that.
//
// Bound on the card: operations.  A pixel costs 9 * C_in * D MACs of conv
// and D for each class that can win (C_in = 32, D = 512, 340 live of C =
// 512: 147,456 + 174,080), against 2 * C_in bytes of features read and k *
// 8 bytes written; the [N, C] scores never touch device memory, nor the
// [B, h, w, D] field on the tensor-core route.
//
// Two routes, chosen by the features' dtype and widths (the wrapper names
// the route, ops/kernels/head_topk.py: kernel_route):
//
// bf16 with C_in <= 64 and D <= 512 (every model config of the repo):
// tensor cores, head_topk_tc_kernel.  A persistent block per SM walks tiles
// of 64 consecutive pixels of the flattened (b, y, x) order, so ragged rows
// and images need no special case.  It has two consumer warpgroups and a
// producer warpgroup, which hands its registers to the consumers
// (setmaxnreg: 232 each); its first thread drives the TMA ring, its last
// three warps load the im2col tiles.
//   1. im2col (common.cuh: tc::im2col, shared with conv_score_topk.cu): each
//      pixel's 9 taps x C_in channels copied with cp.async into wgmma's
//      swizzled A layout, zero-filled at the SAME border and up to a
//      multiple of 16 (40 KB at C_in = 32).  The loader warps copy the next
//      tile's as soon as both warpgroups' conv has read this tile's (an
//      mbarrier each way; the copies complete on theirs), so they land
//      while this one is scored: issued by the consumers, the copies
//      stalled them.
//   2. The conv as an implicit GEMM [64 pixels, 9 * C_in] x [9 * C_in, D]:
//      the producer streams the weights (the wrapper hands them transposed,
//      [D, 9 * C_in]) as [128 dims, 64 taps] chunks through the TMA ring
//      (common.cuh: tc::Ring), taps outer and dim tiles inner, and each
//      warpgroup takes half of every chunk (wgmma m64n64k16) into the
//      accumulators of its dim tile (common.cuh: tc::score_tiles, the dim
//      tiles as one group).  So the two hold the tile's whole f32 conv in
//      registers, 128 a thread at D = 512: warpgroup g has dims n * 128 +
//      64 * g + [0, 64), n < 4.
//   3. The rounding point bf16(f * rs) needs the whole f32 row first: each
//      thread sums f^2 of its two rows (f32), a quad adds its parts by
//      shuffles and the two warpgroups theirs through shared memory; then
//      each thread writes bf16(f * rs) of its accumulators straight into the
//      scoring A tile (swizzled, 64 KB at D = 512).  The conv runs once and
//      no f32 tile is stored.
//   4. Scores over the live classes only, with tc::score_tiles: the wrapper
//      gathers the mask's live table rows first, ascending, with their ids
//      and a device count (no host sync), and the kernel reads the count and
//      streams only the class tiles below it (3 of 4 at 340 live of 512);
//      each warpgroup takes half of every [128 classes, 64 dims] chunk.  The
//      accumulators feed register lists (common.cuh: PairTopK) that hold
//      gathered rows, which rank as their ids (live ids ascend with the
//      row); the quad merges them by shuffles, the two warpgroups through
//      shared memory, and the rows map to ids at the end; picks past the
//      live classes are (id 0, -1e30).
// One block per SM (174 KB of shared memory at C_in = 32, D = 512).  What
// holds it back: each block runs conv, normalisation, scoring and the list
// epilogues in turn, and the epilogues leave the tensor cores idle.

// f32, and bf16 beyond those widths: the CUDA cores in f32 FMA (the tensor
// cores take f32 only as TF32, which would break the fp32 contract; bf16
// features wider than the tensor-core kernel's registers and shared memory
// hold).  Three launches on the port's f32 loop (common.cuh: rc::simt: 8 x
// 8 sums a thread, 128 x 128 a block, two blocks per SM, a three-stage
// cp.async ring with no register staging), over slabs of pixels whose f32
// field fits the wrapper's workspace (ops/kernels/head_topk.py:
// field_slab_rows; one slab at the serve shape):
//   0. The live table rows: live_rows.cu's gather (rc_live_rows): the
//      mask's rows first and ascending, transposed to [D, Cp] f32, with
//      their ids and a device count; no host sync.
//   1. The conv, head_conv_kernel: the loop's product of the im2col rows
//      (common.cuh: Im2colSource: each 16-byte piece one tap's channels of
//      a neighbour pixel, copied by cp.async and zero-filled at the SAME
//      border; at C_in % 32 == 0 a 32-dim chunk is 128 contiguous bytes)
//      with the weight rows [9 * C_in, D] f32, which already are the loop's
//      dim-major table.  Its 128-dim tiles of D are the loop's class tiles.
//      The f32 field goes to the workspace [slab, D] (268 MB at the serve
//      shape, written and read back).
//   2. Scores, head_score_kernel: the loop over the field's rows against
//      the live columns only, the selection in registers (common.cuh:
//      select_tile, as pixel_text_topk.cu's fp32 kernel).  Rounding: the
//      scale is 1 / sqrt(max(s, 1e-24)) of the f64 sum of squares s,
//      rounded once, in place of the TPU kernel's f32 sum; f32 features
//      move it past the sum (rs * sum(f * t)), bf16 ones keep the TPU
//      kernel's rounding point, bf16(f * rs) of the f32 conv before the
//      product (one block per SM: the rounded chunk takes 16 KB more).
//      Picks past the live classes are (id 0, -1e30).
// A 128-pixel f32 embedding tile does not fit in shared memory (256 KB at
// D = 512), so the field takes the workspace and both launches run the
// loop at its own tile.  Any C >= 1 and D; C_in % 8 == 0 and D % 8 == 0
// (the wrapper zero-pads other widths), 1 <= k <= 8, h and w < 32768.

#include "common.cuh"

extern "C" int rc_live_rows(const void* a, const int* a_ids,
                            const int* a_mask, int ca, const void* b,
                            const int* b_ids, const int* b_mask, int cb,
                            const int* use_packed, int d, int is_bf16,
                            float* table_t, int ldt, int* ids, int* count,
                            void* stream);

namespace {

namespace fma_head {

using rc::simt::Im2colSource;
using rc::simt::kCols;
using rc::simt::kRows;
using rc::simt::kThreads;
using rc::simt::Layout;
using rc::simt::Lists;
using rc::simt::merged_list;
using rc::simt::own_list;
using rc::simt::Roles;
using rc::simt::roles_of;
using rc::simt::RowSource;
using rc::simt::select_tile;
using rc::simt::tiles;

// Pixels [p0, p1) of the features [.., h, w, c_in] -> field [p1 - p0, d]
// f32, the conv with wrows [9 * c_in, d] f32.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    head_conv_kernel(const T* __restrict__ feats,
                     const float* __restrict__ wrows, long long p0,
                     long long p1, int h, int w, int c_in, int d,
                     float* __restrict__ field) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Roles roles = roles_of(threadIdx.x);
  const long long base = p0 + (long long)blockIdx.x * kRows;
  tiles<T, float, false>(
      smem, Im2colSource<T>{feats, h, w, c_in}, base, wrows, d, d, p1,
      9 * c_in, roles, [&](float (&acc)[8][8], const float*, int tile) {
        // columns col .. col + 3 and col + 32 .. col + 35 (col_of)
        const int col = tile * kCols + roles.col0 + roles.wx * 4;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const long long row = base + roles.row0 + 4 * i;
          if (row >= p1) continue;
          float* out = field + (row - p0) * d + col;
          if (col < d)
            *reinterpret_cast<float4*>(out) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if (col + 32 < d)
            *reinterpret_cast<float4*>(out + 32) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      });
}

// Rows [0, rows) of the field [rows, d] f32 against the live columns of
// table_t [d, ldt] (*count of them, with their ids): the top-k of rs * f .
// t (R = float) or of bf16(f * rs) . t (R = bf16), picks past the live
// classes (0, -1e30).
template <int K, typename R>
__global__ void __launch_bounds__(kThreads, 2)
    head_score_kernel(const float* __restrict__ field, long long rows, int d,
                      const float* __restrict__ table_t, int ldt,
                      const int* __restrict__ ids,
                      const int* __restrict__ count, int* __restrict__ idx,
                      float* __restrict__ vals) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Roles roles = roles_of(threadIdx.x);
  const int c = __ldg(count);  // live classes: the table's first columns
  float* lv;
  int* lc;
  own_list<K>(smem + Lists<float, R>::kOffset, roles, lv, lc);
  float thr_v = -CUDART_INF_F;
  int thr_c = INT_MAX;
  const long long base = (long long)blockIdx.x * kRows;
  tiles<float, R, true>(
      smem, RowSource<float>{field, d}, base, table_t, ldt, c, rows, d, roles,
      [&](float (&acc)[8][8], const float* rs, int tile) {
        select_tile<K, !Layout<float, R>::kRoundFirst>(
            acc, rs, tile * kCols, c, lv, lc, thr_v, thr_c, roles);
      });

  __syncthreads();
  if (roles.wn != 0) return;
  const long long row = base + roles.row0 + 4 * roles.wx;
  if (row >= rows) return;
  float v[K];
  int col[K];
  merged_list(lv, lc, v, col);
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const bool empty = col[t] >= c;  // the live classes ran out
    idx[row * K + t] = empty ? 0 : __ldg(ids + col[t]);
    vals[row * K + t] = empty ? rc::kNegInf : v[t];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // all of the SM's shared memory, so that two blocks are resident
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

template <int K, typename T>
cudaError_t launch(const T* feats, const float* wrows, const T* table,
                   const int* mask, long long npix, int h, int w, int c_in,
                   int d, int c, float* table_t, int ldt, int* ids,
                   int* count, float* field, long long slab, int* idx,
                   float* vals, cudaStream_t stream) {
  cudaError_t err = static_cast<cudaError_t>(rc_live_rows(
      table, nullptr, mask, c, nullptr, nullptr, nullptr, 0, nullptr, d,
      sizeof(T) == 2, table_t, ldt, ids, count, stream));
  if (err != cudaSuccess) return err;
  constexpr int conv_smem = Layout<T, float>::kEnd;
  constexpr int score_smem = Lists<float, T>::kBytes;
  if ((err = allow_smem(head_conv_kernel<T>, conv_smem)) != cudaSuccess ||
      (err = allow_smem(head_score_kernel<K, T>, score_smem)) != cudaSuccess)
    return err;
  for (long long p0 = 0; p0 < npix; p0 += slab) {
    const long long p1 = std::min(npix, p0 + slab);
    const dim3 grid((unsigned)((p1 - p0 + kRows - 1) / kRows));
    head_conv_kernel<T><<<grid, kThreads, conv_smem, stream>>>(
        feats, wrows, p0, p1, h, w, c_in, d, field);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    head_score_kernel<K, T><<<grid, kThreads, score_smem, stream>>>(
        field, p1 - p0, d, table_t, ldt, ids, count, idx + p0 * K,
        vals + p0 * K);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* feats, const float* wrows, const void* table,
                     const int* mask, long long npix, int h, int w, int c_in,
                     int d, int c, int k, float* table_t, int ldt, int* ids,
                     int* count, float* field, long long slab, int* idx,
                     float* vals, cudaStream_t st) {
  const T* f = static_cast<const T*>(feats);
  const T* t = static_cast<const T*>(table);
  switch (k) {
#define RC_HEAD_CASE(KK)                                                   \
  case KK:                                                                 \
    return launch<KK, T>(f, wrows, t, mask, npix, h, w, c_in, d, c,        \
                         table_t, ldt, ids, count, field, slab, idx, vals, \
                         st);
    RC_HEAD_CASE(1)
    RC_HEAD_CASE(2)
    RC_HEAD_CASE(3)
    RC_HEAD_CASE(4)
    RC_HEAD_CASE(5)
    RC_HEAD_CASE(6)
    RC_HEAD_CASE(7)
    RC_HEAD_CASE(8)
#undef RC_HEAD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fma_head

// ---- bf16: tensor cores ---------------------------------------------------

namespace tc_head {

using rc::tc::kChunkBytes;
using rc::tc::kRowBytes;
using rc::tc::kStages;
using rc::tc::kTileN;

// The route's limits (ops/kernels/head_topk.py: TC_MAX_C_IN, TC_MAX_DIMS,
// held to fits() by a card test).
constexpr int kMaxCIn = 64;     // the im2col tile beside the others
constexpr int kMaxDims = 512;   // the conv's f32 accumulators in registers
constexpr int kDimTiles = kMaxDims / kTileN;
constexpr int kPix = 64;        // pixels of a tile: both warpgroups' rows
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // then the producer warpgroup
constexpr int kLoaders = 96;  // its last three warps: the im2col copies
// Registers a thread after the producer warpgroup gives its own up: 2 x
// 128 x 232 + 128 x 40 = 64,512 of the SM's 65,536 (the block's share at
// 384 threads and 168 registers, the compiler's cap, and all the consumers
// can take: 224 spills the conv's 128 accumulators).
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kMaxK = 8;
constexpr int kBlockBytes = kPix * kRowBytes;  // a 64-dim block of a tile

// A barrier of the loaders only (the consumers use barrier 1).
__device__ __forceinline__ void loader_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kLoaders) : "memory");
}

__host__ __device__ int dim_tiles(int d) { return (d + kTileN - 1) / kTileN; }
__host__ __device__ int k16_conv(int c_in) { return (9 * c_in + 15) / 16; }

// Dynamic shared memory: the scoring A tile (64-dim blocks over the conv's
// dim tiles), the im2col tile, the ring and its barriers, the im2col
// tile's two barriers, the warpgroups' sums of f^2 [2][kPix], warpgroup 1's
// lists [kPix][kMaxK] (values, then rows), the loaders' pixel coordinates
// [kPix], and slack to align the base.
size_t smem_bytes(int c_in, int d) {
  return (size_t)(2 * dim_tiles(d) + (k16_conv(c_in) + 3) / 4) *
             kBlockBytes +
         kStages * kChunkBytes + rc::tc::kBarrierBytes + 16 +
         2 * kPix * sizeof(float) +
         kPix * kMaxK * (sizeof(float) + sizeof(int)) + kPix * sizeof(int2) +
         rc::tc::kAlign;
}

bool fits(int c_in, int d) {
  return c_in % 8 == 0 && c_in >= 8 && c_in <= kMaxCIn && d % 8 == 0 &&
         d >= 8 && d <= kMaxDims && smem_bytes(c_in, d) <= rc::tc::kMaxSmem;
}

// Threads: two consumer warpgroups, then the producer warpgroup.
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    head_topk_tc_kernel(const __grid_constant__ CUtensorMap w_map,
                        const __grid_constant__ CUtensorMap t_map,
                        const __nv_bfloat16* __restrict__ feats,
                        const int* __restrict__ ids,
                        const int* __restrict__ count, long long npix, int h,
                        int w, int c_in, int d, int* __restrict__ idx,
                        float* __restrict__ vals) {
  using namespace rc::tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n_dim = dim_tiles(d);
  const int k16c = k16_conv(c_in);
  const int k16s = (d + 15) / 16;
  const int blocks_c = (k16c + 3) / 4;
  const int col_off = 2 * n_dim * kBlockBytes;  // the im2col tile
  const int ring_off = col_off + blocks_c * kBlockBytes;
  const uint32_t a_emb = smem_addr(smem);
  const uint32_t a_col = a_emb + col_off;
  const Ring ring{a_emb + ring_off,
                  a_emb + ring_off + kStages * kChunkBytes};
  // the im2col tile: landed (the loaders' copies), free (both convs done)
  const uint32_t col_full = ring.bars + kBarrierBytes;
  const uint32_t col_free = col_full + 8;
  float* sq_part = reinterpret_cast<float*>(
      smem + ring_off + kStages * kChunkBytes + kBarrierBytes + 16);
  float* list_v = sq_part + 2 * kPix;
  int* list_c = reinterpret_cast<int*>(list_v + kPix * kMaxK);
  int2* coords = reinterpret_cast<int2*>(list_c + kPix * kMaxK);
  const int live = __ldg(count);  // the table's first rows
  const int tiles = (npix + kPix - 1) / kPix;
  if (tid == 0) {
    mbar_init(col_full, kLoaders);
    mbar_init(col_free, 2);
    ring.init(2);
  }
  __syncthreads();
  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid == kConsumers) {  // the ring: weights, then table, a tile
      int i = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        i = ring.produce(&w_map, d, k16c, i, kDimTiles);
        i = ring.produce(&t_map, live, k16s, i);
      }
    } else if (tid >= kThreads - kLoaders) {  // 1. the im2col tiles
      const int lt = tid - (kThreads - kLoaders);
      int k = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
        pixel_coords(coords, t * kPix, kPix, (int)npix, h, w, kLoaders, lt);
        loader_sync();
        if (k > 0) mbar_wait(col_free, (k - 1) & 1);
        im2col(a_col, kBlockBytes, feats, t * kPix, kPix, coords, h, w, c_in,
               k16c, kLoaders, lt);
        cp_async_arrive(col_full);
        loader_sync();  // coords are read before the next tile's
      }
      cp_async_wait<0>();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int wg = tid >> 7;
  const int wg_tid = tid & 127;
  const int q = lane & 3;
  const uint32_t b_half = wg * kWarpRows * kRowBytes;  // its 64 chunk rows
  const int rows[2] = {frag_row(0, wg_tid), frag_row(1, wg_tid)};
  const int out_row = q ? rows[1] : rows[0];  // q < 2: the row it writes
  int chunk = 0;  // the ring's next chunk
  int k = 0;      // the block's tiles so far
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
    const long long p0 = (long long)tile * kPix;
    mbar_wait(col_full, k & 1);  // the tile's im2col has landed
    fence_proxy_async();

    // 2-3. the conv, its dim tiles as one group (n_dim accumulator chains):
    // f[n] holds dims n * 128 + 64 * wg + [0, 64).  Then s = sum f^2 per
    // row (the thread's part, its quad's, then both warpgroups' through
    // shared memory) and bf16(f * rs) into the scoring A tile, whose block
    // 2n + wg holds f[n].
    chunk = score_tiles<64, kDimTiles>(
        ring, a_col, kBlockBytes, d, k16c, wg_tid, [](int) {},
        [&](float(&f)[kDimTiles][32], int) {
          if (wg_tid == 0) mbar_arrive(col_free);  // the conv has read it
          float sq[2] = {0.f, 0.f};
#pragma unroll
          for (int n = 0; n < kDimTiles; ++n) {
            if (n < n_dim) {
#pragma unroll
              for (int i = 0; i < 32; ++i)
                sq[(i >> 1) & 1] =
                    fmaf(f[n][i], f[n][i], sq[(i >> 1) & 1]);
            }
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            sq[hh] += __shfl_xor_sync(0xffffffffu, sq[hh], 1);
            sq[hh] += __shfl_xor_sync(0xffffffffu, sq[hh], 2);
            if (q == 0) sq_part[wg * kPix + rows[hh]] = sq[hh];
          }
          consumer_sync(kConsumers);  // both warpgroups' sums are in
          float rs[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            rs[hh] = 1.f / sqrtf(fmaxf(
                sq_part[rows[hh]] + sq_part[kPix + rows[hh]], 1e-24f));
#pragma unroll
          for (int n = 0; n < kDimTiles; ++n) {
            if (n < n_dim) {
              unsigned char* blk = smem + (2 * n + wg) * kBlockBytes + q * 4;
#pragma unroll
              for (int i = 0; i < 32; i += 2) {
                const int hh = (i >> 1) & 1;
                *reinterpret_cast<uint32_t*>(blk +
                                             swizzle(rows[hh], i >> 2)) =
                    pack_bf16x2(__fmul_rn(f[n][i], rs[hh]),
                                __fmul_rn(f[n][i + 1], rs[hh]));
              }
            }
          }
        },
        chunk, b_half);
    fence_proxy_async();
    consumer_sync(kConsumers);

    // 4. scores over the live rows, selection from the accumulators; the
    // lists hold gathered rows, which rank as their ids do
    rc::PairTopK<K> top;
    top.init();
    chunk = score_tiles<64>(
        ring, a_emb, kBlockBytes, live, k16s, wg_tid, [](int) {},
        [&](const float(&acc)[32], int t) {
          const int c0 = t * kTileN + wg * 64;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = c0 + frag_col(i, lane);
            top.push((i >> 1) & 1, col < live ? acc[i] : -CUDART_INF_F, col);
          }
        },
        chunk, b_half);
    top.merge_quad();

    // warpgroup 1's lists (the second class half) go to warpgroup 0, whose
    // thread 0 of a quad writes the first row, thread 1 the second
    if (wg == 1 && q < 2) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        list_v[out_row * kMaxK + t] = q ? top.v[1][t] : top.v[0][t];
        list_c[out_row * kMaxK + t] = q ? top.id[1][t] : top.id[0][t];
      }
    }
    consumer_sync(kConsumers);
    if (wg == 0 && q < 2) {
      float v[K];
      int col[K];
#pragma unroll
      for (int t = 0; t < K; ++t) {
        v[t] = q ? top.v[1][t] : top.v[0][t];
        col[t] = q ? top.id[1][t] : top.id[0][t];
      }
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const float ov = list_v[out_row * kMaxK + t];
        const int oc = list_c[out_row * kMaxK + t];
        if (rc::better(ov, oc, v[K - 1], col[K - 1]))
          rc::insert_pair(v, col, ov, oc);
      }
      const long long p = p0 + out_row;
      if (p < npix) {
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const bool empty = col[t] == INT_MAX;  // the live classes ran out
          idx[p * K + t] = empty ? 0 : __ldg(ids + col[t]);
          vals[p * K + t] = empty ? rc::kNegInf : v[t];
        }
      }
    }
  }
}

template <int K>
cudaError_t launch(const __nv_bfloat16* feats, const __nv_bfloat16* wt,
                   const __nv_bfloat16* table, const int* ids,
                   const int* count, int batch, int h, int w, int c_in, int d,
                   int c, int* idx, float* vals, cudaStream_t stream) {
  CUtensorMap w_map, t_map;
  cudaError_t err = rc::tc::make_tensor_map(&w_map, wt, d, 9 * c_in);
  if (err != cudaSuccess) return err;
  err = rc::tc::make_tensor_map(&t_map, table, c, d);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(c_in, d);
  err = cudaFuncSetAttribute(head_topk_tc_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const long long npix = (long long)batch * h * w;
  const dim3 grid((unsigned)std::min<long long>(
      (npix + kPix - 1) / kPix, std::max(rc::sm_count(), 1)));
  head_topk_tc_kernel<K><<<grid, kThreads, smem, stream>>>(
      w_map, t_map, feats, ids, count, npix, h, w, c_in, d, idx, vals);
  return cudaGetLastError();
}

}  // namespace tc_head

}  // namespace

// The CUDA-core route.  feats: [batch, h, w, c_in] f32 (is_bf16 == 0) or
// bf16, c_in % 8 == 0, h and w < 32768; wrows: [9 * c_in, d] f32, the
// weight rows (ordered (dy, dx, c_in)) in f32 whatever the features' dtype,
// d % 8 == 0; table: [c, d] in the features' dtype, L2-normalised; mask:
// [c] int32 (non-zero = candidate); all 16-byte aligned.  Workspace:
// table_t [d, ldt] f32 (ldt >= c, ldt % 4 == 0), ids [c] and count [1]
// int32 (the live rows' gather), field [slab, d] f32.  idx: [batch*h*w, k]
// int32 and vals: [batch*h*w, k] f32, pixels in (b, y, x) order.  1 <= k
// <= 8, c >= 1, batch * h * w >= 1, slab >= 1.
extern "C" int rc_head_topk(const void* feats, int is_bf16,
                            const float* wrows, const void* table,
                            const int* mask, int batch, int h, int w,
                            int c_in, int d, int c, int k, float* table_t,
                            int ldt, int* ids, int* count, float* field,
                            long long slab, int* idx, float* vals,
                            void* stream) {
  const long long npix = (long long)batch * h * w;
  if (c_in % 8 != 0 || c_in < 8 || d % 8 != 0 || d < 8 || c < 1 ||
      npix < 1 || h >= 32768 || w >= 32768 || ldt < c || ldt % 4 != 0 ||
      slab < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fma_head::dispatch<__nv_bfloat16>(
                       feats, wrows, table, mask, npix, h, w, c_in, d, c, k,
                       table_t, ldt, ids, count, field, slab, idx, vals, st)
                 : fma_head::dispatch<float>(
                       feats, wrows, table, mask, npix, h, w, c_in, d, c, k,
                       table_t, ldt, ids, count, field, slab, idx, vals, st);
}

// The tensor-core kernel.  feats: [batch, h, w, c_in] bf16, c_in % 8 == 0,
// 8 <= c_in <= 64; wt: [d, 9 * c_in] bf16, the weight rows transposed
// (row j holds dim j's taps in (dy, dx, c_in) order); table: [c, d] bf16,
// L2-normalised, its live rows first in ascending id order, *count (device
// memory) of them; ids: [c] int32, the class id of each table row; d % 8 ==
// 0, 8 <= d <= 512; feats, wt and table 16-byte aligned.  idx: [batch*h*w,
// k] int32 and vals: [batch*h*w, k] f32, pixels in (b, y, x) order.  1 <= k
// <= 8, c >= 1, batch * h * w >= 1.
extern "C" int rc_head_topk_tc(const void* feats, const void* wt,
                               const void* table, const int* ids,
                               const int* count, int batch, int h, int w,
                               int c_in, int d, int c, int k, int* idx,
                               float* vals, void* stream) {
  if (!tc_head::fits(c_in, d) || c < 1 || (long long)batch * h * w < 1 ||
      (long long)batch * h * w >= INT_MAX)
    return cudaErrorInvalidValue;
  const auto* f = static_cast<const __nv_bfloat16*>(feats);
  const auto* wb = static_cast<const __nv_bfloat16*>(wt);
  const auto* t = static_cast<const __nv_bfloat16*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define RC_HEAD_TC_CASE(KK)                                                 \
  case KK:                                                                  \
    return tc_head::launch<KK>(f, wb, t, ids, count, batch, h, w, c_in, d, \
                               c, idx, vals, st);
    RC_HEAD_TC_CASE(1)
    RC_HEAD_TC_CASE(2)
    RC_HEAD_TC_CASE(3)
    RC_HEAD_TC_CASE(4)
    RC_HEAD_TC_CASE(5)
    RC_HEAD_TC_CASE(6)
    RC_HEAD_TC_CASE(7)
    RC_HEAD_TC_CASE(8)
#undef RC_HEAD_TC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
