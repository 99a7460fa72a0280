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
//   1. Copies: (class tile, dim chunk) steps stream through a shared-memory
//      ring by cp.async (simt::kStages stages of simt::kChunk dims), with
//      no register staging: the pixel chunk row-major in the field's dtype,
//      the table chunk dim-major in f32, zero-filled past N, the count and
//      D; each thread's sources and places are fixed but for the step's
//      offsets.  The steps run on across class tiles, so the next tile's
//      first copies are in flight while a tile's selection runs.  The
//      pixel tile is read again for each class tile (from L2 mostly); it
//      is never re-scaled.
//   2. Scores: the 8 warps tile the 128 x 128 sums as 4 (rows) x 2 (class
//      halves of 64), a warp's lanes as 4 x 8; each thread holds 8 rows x 8
//      classes.  Per 4 dims, 8 float4 reads of pixel rows and 8 of table
//      classes feed 256 FMAs, each read one shared-memory wavefront (the
//      pixel rows' 16-byte pieces are XOR-swizzled).  One barrier per step.
//      A ragged last tile of at most 64 live classes skips its second
//      half's products; each SM sub-partition (warp % 4) holds one warp of
//      each half, so that halves the work of every sub-partition.
//   3. Scale.  f32: the scale moves past the sum, rs * sum(x * t) where
//      the TPU kernel sums f32(x * rs) * t; the two differ by f32 rounding
//      only, which the fp32 contract allows (and on power-of-two norms not
//      at all).  During the first class tile each thread sums x^2 of half a
//      row's dims from the landed chunks (f64).  bf16 keeps the TPU
//      kernel's rounding point: a first pass over the rows gives rs (f64,
//      warp-reduced, overlapping the first copies), and each landed chunk
//      is rounded to bf16(x * rs) and widened before its product.
//   4. Selection from the registers, no score tile: the 8 lanes of a
//      quarter warp hold the same 8 rows; a round takes, for several rows
//      at once, each lane's best untaken class and the quarter's best by
//      three shuffles, and the row's owner lane inserts it into the row's
//      list (shared memory) if it ranks above the last entry (kept in the
//      owner's registers); rounds stop when no row of the warp gains one.
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

constexpr int kThreads = 256;
constexpr int kRows = 128;   // pixel rows per block
constexpr int kCols = 128;   // classes per tile
constexpr int kChunk = 32;   // dims per ring stage: an f32 row of 128 bytes
constexpr int kStages = 3;   // ring depth: two steps in flight
constexpr int kMaxK = 8;
constexpr int kSelRows = 4;  // rows a selection round takes at once

// Dynamic shared memory of a block: the ring (each stage a pixel chunk
// [kRows, kChunk] in the field's dtype, f32 rows swizzled, then a table
// chunk [kChunk, kCols] f32), for bf16 the chunk rounded and widened to f32
// (swizzled), the row scales, and two top-k lists (value, table column)
// per row, one per class half.  115,200 bytes for f32: two blocks per SM.
template <typename T>
struct Layout {
  static constexpr bool kRoundFirst = sizeof(T) == 2;
  static constexpr int kRowBytes = kChunk * (int)sizeof(T);
  static constexpr int kABytes = kRows * kRowBytes;
  static constexpr int kStageBytes = kABytes + kChunk * kCols * 4;
  static constexpr int kWideOffset = kStages * kStageBytes;
  static constexpr int kScaleOffset =
      kWideOffset + (kRoundFirst ? kRows * kChunk * 4 : 0);
  static constexpr int kListOffset = kScaleOffset + kRows * 4;
  static constexpr int kBytes = kListOffset + 2 * kRows * kMaxK * 8;
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
// then reads one 128-byte line of the table chunk, and the four rows a
// warp reads at one dim fall in distinct banks (swz), so every shared load
// is one wavefront.
struct Roles {
  int row0;  // wm * 32 + wy
  int col0;  // wn * 64
  int wx, wn, lane;
};

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
// kernel's rounding point) and writes it widened to the f32 chunk.
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
    rc::load8(raw + r * kChunk + dim, v);
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = rc::to_float(rc::round_to(rc::to_float(v[e]) * scale, T()));
    *reinterpret_cast<float4*>(w + swz(r, dim / 4)) =
        make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(w + swz(r, dim / 4 + 1)) =
        make_float4(o[4], o[5], o[6], o[7]);
  }
}

// Merge one class tile's sums into the lists.  The 8 lanes of a quarter
// warp hold the same 8 rows (8 classes each, 64 in all); lane wx owns the
// list of its quarter's row wx (shared memory) and keeps its last entry in
// registers.  A round takes, for all 8 rows at once, each lane's best
// untaken class and the quarter's best by three shuffles, and each owner
// inserts its row's best if it ranks above its last entry; the rounds stop
// when no row of the warp has one to insert (at most K rounds).
template <int K, bool kScale>
__device__ __forceinline__ void select_tile(
    float (&acc)[8][8], const float* __restrict__ rs, int c0,
    int c, float* __restrict__ lv, int* __restrict__ lc, float& thr_v,
    int& thr_c, const Roles& r) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float scale = kScale ? rs[r.row0 + 4 * i] : 1.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + r.col0 + col_of(j, r.wx);
      acc[i][j] = col >= c ? -CUDART_INF_F : acc[i][j] * scale;
    }
  }
  const int quarter = r.lane & 24;
#pragma unroll
  for (int g = 0; g < 8; g += kSelRows) {  // rows g .. g + kSelRows - 1
#pragma unroll 1
    for (int round = 0; round < K; ++round) {
      float gv[kSelRows];
      int gc[kSelRows], bj[kSelRows];
#pragma unroll
      for (int i = 0; i < kSelRows; ++i) {  // columns ascend with j: ties
        gv[i] = -CUDART_INF_F;            // keep the first
        bj[i] = -1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc[g + i][j] > gv[i]) {
            gv[i] = acc[g + i][j];
            bj[i] = j;
          }
        }
        gc[i] = bj[i] < 0 ? INT_MAX : c0 + r.col0 + col_of(bj[i], r.wx);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < kSelRows; ++i) {
          const float ov = __shfl_xor_sync(0xffffffffu, gv[i], off);
          const int oc = __shfl_xor_sync(0xffffffffu, gc[i], off);
          if (rc::better(ov, oc, gv[i], gc[i])) {
            gv[i] = ov;
            gc[i] = oc;
          }
        }
      }
      unsigned want = 0;
#pragma unroll
      for (int i = 0; i < kSelRows; ++i) {
        const float tv = __shfl_sync(0xffffffffu, thr_v, quarter | (g + i));
        const int tc = __shfl_sync(0xffffffffu, thr_c, quarter | (g + i));
        if (rc::better(gv[i], gc[i], tv, tc)) want |= 1u << i;
      }
      if (!__any_sync(0xffffffffu, want != 0)) break;
      // the owner of row g + i (lane wx == g + i) inserts its row's best
      const int mine = r.wx - g;
      float ov = gv[0];
      int oc = gc[0];
#pragma unroll
      for (int i = 1; i < kSelRows; ++i) {
        ov = mine == i ? gv[i] : ov;
        oc = mine == i ? gc[i] : oc;
      }
      if (mine >= 0 && mine < kSelRows && ((want >> mine) & 1u)) {
        float v[K];
        int id[K];
#pragma unroll
        for (int t = 0; t < K; ++t) {
          v[t] = lv[t];
          id[t] = lc[t];
        }
        rc::insert_pair(v, id, ov, oc);
#pragma unroll
        for (int t = 0; t < K; ++t) {
          lv[t] = v[t];
          lc[t] = id[t];
        }
        thr_v = v[K - 1];
        thr_c = id[K - 1];
      }
      if (K > 1) {  // the winning lane marks its class taken
#pragma unroll
        for (int i = 0; i < kSelRows; ++i) {
          const bool won = ((want >> i) & 1u) && bj[i] >= 0 &&
                           c0 + r.col0 + col_of(bj[i], r.wx) == gc[i];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (won && j == bj[i]) acc[g + i][j] = -CUDART_INF_F;
        }
      }
    }
  }
}

template <int K, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    pixel_text_topk_fma_kernel(const T* __restrict__ field,
                               const float* __restrict__ table_t, int ldt,
                               const int* __restrict__ ids,
                               const int* __restrict__ count, long long n,
                               int d, int* __restrict__ idx,
                               float* __restrict__ vals) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem + L::kScaleOffset);
  float* wide = reinterpret_cast<float*>(smem + L::kWideOffset);
  float* list_v = reinterpret_cast<float*>(smem + L::kListOffset);
  int* list_c = reinterpret_cast<int*>(list_v + 2 * kRows * kMaxK);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  Roles roles;
  roles.lane = lane;
  roles.wx = lane & 7;
  roles.wn = warp >> 2;  // each sub-partition (warp % 4) has both halves
  roles.row0 = (warp & 3) * 32 + (lane >> 3);
  roles.col0 = roles.wn * 64;
  const long long base = (long long)blockIdx.x * kRows;  // first pixel row
  const int c = __ldg(count);  // live classes: the table's first columns
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
  const T* a_src = field + (base + a_row) * d + a_dim;
  unsigned a_ok = 0;
#pragma unroll
  for (int i = 0; i < kAIters; ++i)
    if (base + a_row + i * kRowStep < n) a_ok |= 1u << i;
  // f32 rows are swizzled (swz); a thread's rows are 32 apart, the same % 8
  const uint32_t a_dst =
      rc::tc::smem_addr(smem) +
      (L::kRoundFirst ? a_row * L::kRowBytes + (tid % kRowPieces) * 16
                      : swz(a_row, tid % kRowPieces));
  const int b_dim = tid >> 5;
  const int b_col = (tid & 31) * 4;
  const float* b_src = table_t + (long long)b_dim * ldt + b_col;
  const uint32_t b_dst = rc::tc::smem_addr(smem) + L::kABytes + tid * 16;
  int next_tile = 0, next_dim0 = 0;
  auto copy_step = [&](int s) {
    if (s < steps) {
      const uint32_t stage = (s % kStages) * L::kStageBytes;
      const bool dim_ok = next_dim0 + a_dim < d;
#pragma unroll
      for (int i = 0; i < kAIters; ++i) {
        const bool ok = dim_ok && ((a_ok >> i) & 1u);
        rc::tc::cp_async16(
            a_dst + stage + i * kRowStep * L::kRowBytes,
            ok ? a_src + (long long)i * kRowStep * d + next_dim0 : field, ok);
      }
      const bool col_ok = next_tile * kCols + b_col < c;
      const float* b = b_src + (long long)next_dim0 * ldt + next_tile * kCols;
#pragma unroll
      for (int i = 0; i < kChunk / 8; ++i) {
        const bool ok = col_ok && next_dim0 + b_dim + 8 * i < d;
        rc::tc::cp_async16(b_dst + stage + i * 8 * kCols * 4,
                           ok ? b + (long long)8 * i * ldt : table_t, ok);
      }
      next_dim0 += kChunk;
      if (next_dim0 >= d) {
        next_dim0 = 0;
        ++next_tile;
      }
    }
    rc::tc::cp_async_commit();
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
          rc::load8(field + (base + r) * d + g, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const double x = rc::to_float(v[e]);
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
  // this lane's list: row row0 + 4 wx of its quarter, class half wn
  const int own_row = roles.row0 + 4 * roles.wx;
  float* lv = list_v + (roles.wn * kRows + own_row) * kMaxK;
  int* lc = list_c + (roles.wn * kRows + own_row) * kMaxK;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    lv[t] = -CUDART_INF_F;
    lc[t] = INT_MAX;
  }
  float thr_v = -CUDART_INF_F;
  int thr_c = INT_MAX;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  double sq = 0.0;  // f32: this thread's share of sum x^2 of row tid / 2
  int tile = 0, chunk = 0;
  for (int s = 0; s < steps; ++s) {
    rc::tc::cp_async_wait<kStages - 2>();
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
      select_tile<K, !L::kRoundFirst>(acc, rs, tile * kCols, c, lv, lc,
                                      thr_v, thr_c, roles);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      chunk = 0;
      ++tile;
    }
  }

  // The lists of the two class halves of a row merge in the owner of the
  // first; list columns map to ids, and picks past the live classes are
  // dead slots.
  __syncthreads();
  if (roles.wn != 0) return;
  const long long row = base + own_row;
  if (row >= n) return;
  float v[K];
  int col[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    v[t] = lv[t];
    col[t] = lc[t];
  }
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float ov = lv[kRows * kMaxK + t];
    const int oc = lc[kRows * kMaxK + t];
    if (rc::better(ov, oc, v[K - 1], col[K - 1]))
      rc::insert_pair(v, col, ov, oc);
  }
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
  constexpr int smem = Layout<T>::kBytes;
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
  return is_bf16 ? simt::Layout<__nv_bfloat16>::kBytes
                 : simt::Layout<float>::kBytes;
}
