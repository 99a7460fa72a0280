// Fused pixel L2-normalisation + pixel x text scoring + masked top-k.
//
// Replaces rangeclip_tpu/ops/pallas/pixel_text_topk.py: _topk_kernel, entry
// point fused_pixel_text_topk.  Same contract: each pixel row of the
// un-normalised field is normalised in f32 as x * 1/sqrt(max(sum x^2,
// 1e-24)) and rounded to the field's dtype, scored against the
// pre-normalised table (already in the field's dtype) with f32 sums, and the
// top-k is taken with global ids: ties to the smallest id, slots of id -1
// (non-candidates or padding) score -1e30, and once one of them wins every
// later pick is (-1, -1e30).  A pick whose score is <= -1e29 emits id -1.
//
// One departure from the TPU kernel: sum x^2 is taken in f64 (exact for
// bf16 rows, so independent of the order) and 1/sqrt is rounded once to
// f32, where the TPU kernel sums in f32 and takes an f32 rsqrt.  The plain
// version (pixel_text_topk.py: normalize_rows_rsqrt) does the same, so the
// kernel and it round every pixel identically; an f32 sum in another order
// moves the scale by an ulp and flips bf16 roundings of the pixel.
//
// Bound on the card: arithmetic, with the field's bytes close behind.  Each
// pixel costs C * D multiply-adds (C=384, D=512: 196,608) against D *
// sizeof(T) bytes of field read and k * 4 bytes written; the [N, C] score
// field never touches device memory.
//
// Two kernels, chosen by the field's dtype:
//
// bf16 (D <= kMaxTcDims): tensor cores, as the TPU kernel's bf16 MXU
// product with f32 sums (pixel_text_topk.py:95-100).  A block of one or two
// consumer warpgroups owns 64 pixel rows each (two while both fit in shared
// memory beside the ring: D <= 640).
//   1. The rows are copied once from device memory (cp.async) into shared
//      memory in wgmma's 128-byte-swizzled A layout, dims zero-filled up to
//      a multiple of 16.  Each warp then sums x^2 of its rows from that copy
//      (f64, warp-reduced) and rewrites them in place as bf16(x * rs).
//   2. A producer warp streams class tiles of 128 table rows through a
//      four-stage ring of [128, 64-dim] chunks with TMA (zero-filled past C
//      and D, mbarriers for full and empty stages); each chunk is up to four
//      wgmma m64n128k16 into f32 registers, left in flight while the next
//      chunk is waited for (common.cuh: tc::score_tiles).
//   3. After a tile's last chunk each thread feeds its 64 accumulators (two
//      rows, 32 classes) into the rows' register lists with a branchless
//      insertion (common.cuh: PairTopK); dead classes (a bit mask per tile,
//      loaded as the tile starts) enter at -1e30, classes past C never.  The
//      lists hold table rows, which rank as their ids (ids ascend with the
//      row, the wrapper's contract), mapped to ids at the end.  The 4
//      threads of a quad merge their lists by shuffles.
//
// fp32, and bf16 beyond kMaxTcDims: CUDA-core FMA.  The tensor cores take
// f32 only as TF32, which would break the fp32 contract (labels equal,
// values within f32 rounding of the f32 product).  Masked classes cannot
// change the answer, so the wrapper hands the kernel the live table rows
// only: gathered first in ascending order, with their ids and a device
// count, and transposed to [D, C] f32 (C padded to a multiple of 4); the
// columns past the count are never read.  A block of 256 threads (two per
// SM) owns 128 pixel rows and walks the live classes in tiles of 128.
//   1-3. The loop it shares with pixel_text_ce.cu's member-only forward
//      (common.cuh: rc::simt::score_tiles): (class tile, 32-dim chunk)
//      steps through a three-stage cp.async ring with no register
//      staging, running on across class tiles; 8 x 8 sums a thread of a
//      128 x 128 tile; a ragged last tile of at most 64 live classes skips
//      its second half's products.  Scale.  f32: the scale moves past the
//      sum, rs * sum(x * t) where the TPU kernel sums f32(x * rs) * t; the
//      two differ by f32 rounding only, which the fp32 contract allows (and
//      on power-of-two norms not at all).  bf16 keeps the TPU kernel's
//      rounding point, bf16(x * rs) before the product.
//   4. Selection from the registers, no score tile (common.cuh:
//      select_tile, shared with head_topk.cu's CUDA-core route): the 8
//      lanes of a quarter warp hold the same 8 rows; a round takes, for
//      several rows at once, each lane's best untaken class and the
//      quarter's best by three shuffles, and the row's owner lane inserts
//      it into the row's list (shared memory) if it ranks above the last
//      entry (kept in the owner's registers); rounds stop when no row of
//      the warp gains one.
//      Classes past the count never enter; the lists hold live columns
//      (ranked as their ids, which ascend with the column), one list per
//      row and class half, merged at the end and mapped to ids; picks past
//      the live classes are dead slots: (-1, -1e30), as the knockout gives
//      once a masked class (score -1e30) wins.
// The TPU kernel's [H, W, B, D] transpose, class-major score tile and
// row-tile search have no purpose here.  Any N, any C >= k, D % 8 == 0.

#include "common.cuh"

namespace {

// ---- fp32 (and bf16 beyond kMaxTcDims): CUDA cores -------------------------

namespace simt {

// the loop: common.cuh
using rc::simt::kCols;
using rc::simt::kRows;
using rc::simt::kThreads;
using rc::simt::Layout;
using rc::simt::Lists;
using rc::simt::merged_list;
using rc::simt::own_list;
using rc::simt::Roles;
using rc::simt::roles_of;
using rc::simt::score_tiles;
using rc::simt::select_tile;

template <int K, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    pixel_text_topk_fma_kernel(const T* __restrict__ field,
                               const float* __restrict__ table_t, int ldt,
                               const int* __restrict__ ids,
                               const int* __restrict__ count, long long n,
                               int d, int* __restrict__ idx,
                               float* __restrict__ vals) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Roles roles = roles_of(threadIdx.x);
  const int c = __ldg(count);  // live classes: the table's first columns
  float* lv;
  int* lc;
  own_list<K>(smem + Lists<T>::kOffset, roles, lv, lc);
  float thr_v = -CUDART_INF_F;
  int thr_c = INT_MAX;

  score_tiles<T>(smem, field, d, (long long)blockIdx.x * kRows, table_t, ldt,
                 c, n, d, roles,
                 [&](float (&acc)[8][8], const float* rs, int tile) {
                   select_tile<K, !Layout<T>::kRoundFirst>(
                       acc, rs, tile * kCols, c, lv, lc, thr_v, thr_c, roles);
                 });

  // The lists of the two class halves of a row merge in the owner of the
  // first; list columns map to ids, and picks past the live classes are
  // dead slots.
  __syncthreads();
  if (roles.wn != 0) return;
  const long long row = (long long)blockIdx.x * kRows + roles.row0 +
                        4 * roles.wx;
  if (row >= n) return;
  float v[K];
  int col[K];
  merged_list(lv, lc, v, col);
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const bool dead = col[t] >= c;
    const int id = dead ? -1 : __ldg(ids + col[t]);
    idx[row * K + t] = (dead || v[t] <= -1e29f) ? -1 : id;
    if (vals != nullptr) vals[row * K + t] = dead ? rc::kNegInf : v[t];
  }
}

template <int K, typename T>
cudaError_t launch(const T* field, const float* table_t, int ldt,
                   const int* ids, const int* count, long long n, int d,
                   int* idx, float* vals, cudaStream_t stream) {
  constexpr int smem = Lists<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      pixel_text_topk_fma_kernel<K, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // all of the SM's shared memory, so that two blocks are resident
  err = cudaFuncSetAttribute(pixel_text_topk_fma_kernel<K, T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + kRows - 1) / kRows));
  pixel_text_topk_fma_kernel<K, T><<<grid, kThreads, smem, stream>>>(
      field, table_t, ldt, ids, count, n, d, idx, vals);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* field, const float* t, int ldt,
                     const int* ids, const int* live, long long n, int d,
                     int k, int* idx, float* vals, cudaStream_t st) {
  const T* f = static_cast<const T*>(field);
  switch (k) {
    case 1: return launch<1, T>(f, t, ldt, ids, live, n, d, idx, vals, st);
    case 2: return launch<2, T>(f, t, ldt, ids, live, n, d, idx, vals, st);
    case 3: return launch<3, T>(f, t, ldt, ids, live, n, d, idx, vals, st);
    case 4: return launch<4, T>(f, t, ldt, ids, live, n, d, idx, vals, st);
    case 5: return launch<5, T>(f, t, ldt, ids, live, n, d, idx, vals, st);
    case 6: return launch<6, T>(f, t, ldt, ids, live, n, d, idx, vals, st);
    case 7: return launch<7, T>(f, t, ldt, ids, live, n, d, idx, vals, st);
    case 8: return launch<8, T>(f, t, ldt, ids, live, n, d, idx, vals, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int kMaxTcDims = 1280;  // A (64 rows) + the B ring within 227 KB

// Threads: 128 per consumer warpgroup, then the producer warp.
template <int K>
__global__ void __launch_bounds__(rc::tc::kMaxWarpgroups * 128 + 32, 1)
    pixel_text_topk_tc_kernel(const __grid_constant__ CUtensorMap table_map,
                              const __nv_bfloat16* __restrict__ field,
                              const int* __restrict__ ids, long long n,
                              int d, int c, int* __restrict__ idx,
                              float* __restrict__ vals) {
  using namespace rc::tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x - 32;  // consumer threads
  const int rows = nthreads / 128 * kWarpRows;  // pixel rows of the block
  const int lane = tid & 31;
  const int k16 = (d + 15) / 16;
  const int blocks_k = (k16 + 3) / 4;
  const int a_block_bytes = rows * kRowBytes;
  const uint32_t a = smem_addr(smem);
  const Ring ring{a + blocks_k * a_block_bytes,
                  a + blocks_k * a_block_bytes + kStages * kChunkBytes};
  const long long row0 = (long long)blockIdx.x * rows;
  if (tid == 0) ring.init(nthreads / 128);
  __syncthreads();
  if (tid >= nthreads) {  // the producer warp: the table's chunks
    if (tid == nthreads) ring.produce(&table_map, c, k16);
    return;
  }

  // 1. the rows, normalised, into the swizzled A tile (common.cuh)
  normalized_rows(smem, a, a_block_bytes, rows, field, n, d, row0, nthreads,
                  nullptr);

  // 2-3. scores on the tensor cores, selection from the accumulators.  The
  // lists hold table rows (columns), which rank as their ids do (ids ascend
  // with the row); dead rows enter at -1e30, rows past c never.
  const int wg = tid >> 7;
  const int wg_tid = tid & 127;
  rc::PairTopK<K> top;
  top.init();
  unsigned dead = 0;  // the tile's dead mask, loaded as the tile starts
  score_tiles(
      ring, a + wg * kWarpRows * kRowBytes, a_block_bytes, c, k16, wg_tid,
      [&](int t) { dead = dead_mask(ids, t * kTileN, c, lane); },
      [&](const float(&acc)[64], int t) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = t * kTileN + frag_col(i, lane);
          const float sv = col >= c                     ? -CUDART_INF_F
                           : (dead >> mask_bit(i)) & 1u ? rc::kNegInf
                                                     : acc[i];
          top.push((i >> 1) & 1, sv, col);
        }
      });
  top.merge_quad();

  // thread 0 of a quad writes the first row, thread 1 the second
  const int h = lane & 3;
  if (h > 1) return;
  const long long row = row0 + wg * kWarpRows + frag_row(h, wg_tid);
  if (row >= n) return;
  bool dead_won = false;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float v = h ? top.v[1][t] : top.v[0][t];
    const int col = h ? top.id[1][t] : top.id[0][t];
    const int id = col < c ? __ldg(ids + col) : -1;
    dead_won = dead_won || id == -1;
    idx[row * K + t] = (dead_won || v <= -1e29f) ? -1 : id;
    if (vals != nullptr) vals[row * K + t] = dead_won ? rc::kNegInf : v;
  }
}

template <int K>
cudaError_t launch_tc(const __nv_bfloat16* field,
                      const __nv_bfloat16* table, const int* ids,
                      long long n, int d, int c, int* idx, float* vals,
                      cudaStream_t stream) {
  const int k16 = (d + 15) / 16;
  const int wgs = rc::tc::warpgroups_for(k16);
  const int rows = wgs * rc::tc::kWarpRows;
  const size_t smem = rc::tc::smem_bytes(rows, k16);
  CUtensorMap map;
  cudaError_t err = rc::tc::make_tensor_map(&map, table, c, d);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(pixel_text_topk_tc_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + rows - 1) / rows));
  pixel_text_topk_tc_kernel<K><<<grid, wgs * 128 + 32, smem, stream>>>(
      map, field, ids, n, d, c, idx, vals);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* field, const void* table, const int* ids,
                        long long n, int d, int c, int k, int* idx,
                        float* vals, cudaStream_t st) {
  const auto* f = static_cast<const __nv_bfloat16*>(field);
  const auto* t = static_cast<const __nv_bfloat16*>(table);
  switch (k) {
    case 1: return launch_tc<1>(f, t, ids, n, d, c, idx, vals, st);
    case 2: return launch_tc<2>(f, t, ids, n, d, c, idx, vals, st);
    case 3: return launch_tc<3>(f, t, ids, n, d, c, idx, vals, st);
    case 4: return launch_tc<4>(f, t, ids, n, d, c, idx, vals, st);
    case 5: return launch_tc<5>(f, t, ids, n, d, c, idx, vals, st);
    case 6: return launch_tc<6>(f, t, ids, n, d, c, idx, vals, st);
    case 7: return launch_tc<7>(f, t, ids, n, d, c, idx, vals, st);
    case 8: return launch_tc<8>(f, t, ids, n, d, c, idx, vals, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The tensor-core kernel.  field: [n, d] bf16, un-normalised, d <= 1280;
// table: [c, d] bf16, L2-normalised; both 16-byte aligned, d % 8 == 0.
// ids: [c] int32 output id per table row, ascending over the rows that may
// win, -1 for rows that may not (ties between equal scores go to the
// smaller row, which is the smaller id).  idx: [n, k] int32; vals: [n, k]
// f32 or NULL.  1 <= k <= 8, k <= c, n >= 1.
extern "C" int rc_pixel_text_topk(const void* field, const void* table,
                                  const int* ids, long long n, int d, int c,
                                  int k, int* idx, float* vals,
                                  void* stream) {
  if (d % 8 != 0 || d <= 0 || d > kMaxTcDims || c < k)
    return cudaErrorInvalidValue;
  return dispatch_tc(field, table, ids, n, d, c, k, idx, vals,
                     static_cast<cudaStream_t>(stream));
}

// The CUDA-core kernel: field [n, d] f32 (is_bf16 == 0) or bf16, 16-byte
// aligned, d % 8 == 0; table_t: [d, ldt] f32, 16-byte aligned, ldt % 4 ==
// 0 and ldt >= c: the table transposed, its live rows first and ascending,
// *count (device memory) of them, with their ids (the wrapper gathers
// them); the columns past the count are not read.  idx, vals, k as above,
// k <= c.
extern "C" int rc_pixel_text_topk_fma(const void* field, int is_bf16,
                                      const float* table_t, int ldt,
                                      const int* ids, const int* count,
                                      long long n, int d, int c, int k,
                                      int* idx, float* vals, void* stream) {
  if (d % 8 != 0 || d <= 0 || c < k || ldt < c || ldt % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? simt::dispatch<__nv_bfloat16>(field, table_t, ldt, ids,
                                                 count, n, d, k, idx, vals, st)
                 : simt::dispatch<float>(field, table_t, ldt, ids, count, n, d,
                                        k, idx, vals, st);
}

// Dynamic shared memory of the bf16 tensor-core kernel's block at dim d (0
// where d takes the CUDA-core kernel), for reports.
extern "C" long long rc_pixel_text_topk_tc_smem(int d) {
  if (d <= 0 || d > kMaxTcDims) return 0;
  const int k16 = (d + 15) / 16;
  return (long long)rc::tc::smem_bytes(
      rc::tc::warpgroups_for(k16) * rc::tc::kWarpRows, k16);
}

// Dynamic shared memory of the CUDA-core kernel's block for an f32
// (is_bf16 == 0) or bf16 field, for reports.
extern "C" long long rc_pixel_text_topk_fma_smem(int is_bf16) {
  return is_bf16 ? simt::Lists<__nv_bfloat16>::kBytes
                 : simt::Lists<float>::kBytes;
}
