// Fused pixel-text InfoNCE cross-entropy, forward and backward.
//
// Replaces rangeclip_tpu/ops/pallas/pixel_text_ce.py: _fwd_kernel and
// _bwd_kernel, entry point fused_pixel_text_ce.  Per pixel row i with label
// slots (l_s, w_s), s < S:
//   emb   = x * rs, rs = 1/sqrt(max(sum x^2, 1e-24))   (f32)
//   logit = mask_c ? (round_T(emb) . table_c) * (1/tau) : -1e30
//   ce_i  = W * lse - sum_s w_s * logit[l_s]         W = sum_s w_s
// where logit[l] is the row's logit at the class whose id is l (0 when no
// class has it), ids being the global class ids of the table rows (packed
// form) or 0..C-1.  The backward recomputes the logits and writes
//   delta_c = e_c * (W / Z) - sum_s [id_c == l_s] w_s   (rounded to T)
//   d_emb   = (delta . table) * (1/tau)
//   dx      = rs * (d_emb - emb * (emb . d_emb))        (rounded to x's T)
//   dtau_i  = sum_s w_s logit[l_s] - W * (sum_c e_c logit_c) / Z
// with w_s scaled by the upstream gradient; the caller sums dtau / tau.
// The sum of squares is taken in f64 and 1/sqrt rounded once to f32, as in
// pixel_text_topk.cu, so kernel and plain version round every pixel alike.
//
// Packed or full table, chosen on the device: when ``use_packed`` points to
// a non-zero int the kernel scores the gathered [K, D] member table (ids =
// the members' global ids); otherwise the full [C, D] table.  The caller
// computes the flag (n_contrast <= K) on the device, so no host sync.
//
// Bound on the card: the forward does 2 N K D FLOP (68.7 GFLOP packed at
// N = 524,288, K = 128, D = 512) against N (D * sizeof(T) + 8 S + 4) bytes
// (0.54 GB): bytes at the tensor cores' bf16 rate (0.07 ms of products
// against 0.16 ms of reads), operations on the CUDA cores, counted over
// the members (2 N D count FLOP: 0.18 ms at N = 131,072, D = 512 and 90
// members in f32).  The backward
// does the product twice or more (see below) and writes dx too.  The
// [N, C] logits never touch device memory.
//
// Three designs, chosen by shape on the host and by the device flag:
//
// bf16 with a packed table, d <= 1280 (the backward: k <= 128): tensor
// cores (ce_tc_fwd_kernel, ce_tc_bwd_kernel).  A block of one or two
// consumer warpgroups owns 64 pixel rows each, and a producer warpgroup
// streams the table through a four-stage TMA ring (common.cuh: tc::); it
// hands its registers to the consumers (setmaxnreg: 232 each), and nothing
// spills.
//   1. The rows are copied once into shared memory in wgmma's swizzled A
//      layout, their f64 scale taken from that copy and the tile rewritten
//      as bf16(x * rs) in place (common.cuh: tc::normalized_rows).
//   2. Logits: wgmma m64n128k16 over the packed [k, d] table into 64 f32
//      registers per thread (two rows x 32 classes), summed step by step
//      (tile_sims); the epilogue runs on the fragment: masked members at
//      -1e30, an online max / sum-exp across class tiles reduced over the
//      quad by shuffles, and the slot picks (the column whose packed id
//      equals the label).
//   3. Backward: the row statistics, dtau and delta in registers; delta,
//      rounded to bf16, goes to the warpgroup's own rows of the A tile,
//      which the logits are done with, as the A operand of the second
//      product, d_emb = delta [64, k] x table [k, d], against the
//      transposed table [d, k8] (a copy the wrapper makes per call) in
//      128-dim chunks through the same ring.  The normalisation VJP needs
//      proj = emb . d_emb over all of d, so the chunks run twice: pass 0
//      sums proj, pass 1 writes dx.  emb = x * rs in f32 re-reads x (L2),
//      staged with dx through other free rows of the A tile.
// The kernels return at once unless *use_packed != 0; the CUDA-core kernel,
// launched beside them with skip_packed, returns at once otherwise.
//
// Against the plain version, whose logits are an f32 FMA chain over d in
// order, no other summation order agrees on every bf16 rounding of delta:
// even exactly rounded logits flip a label's delta in a few rows of a
// flagship-sized draw, and such a flip moves the row's dx by about the
// checks' bound (utils/ce_rounding.py measures it).  The CUDA-core kernel
// sums in the plain version's order.
//
// The forward where no tensor-core kernel runs beside it (f32, and bf16
// without a tensor-core packed table): the members only
// (member::ce_members_kernel).  A non-member's logit is -1e30 and its exp
// term is exactly 0 in f32, so only the members' logits are needed: the
// wrapper gathers the members of the table the device flag selects on the
// device (no host sync), first and transposed to [D, C] f32 with their
// global ids and a device count, and the kernel runs ceil(count / 128)
// class tiles of pixel_text_topk.cu's fp32 loop (common.cuh:
// rc::simt::score_tiles: 128 rows x 128 classes a block, a three-stage
// cp.async ring of 32-dim chunks, two blocks per SM; the f32 scale moves
// past the sum, bf16 rounds bf16(x * rs) on the landed chunk).  The
// epilogue runs on the accumulators: 1/tau, an online max / sum-exp per
// row and class half reduced over a quarter warp by shuffles, and the slot
// picks found by comparing the members' global ids with the labels; the
// halves merge at the end.  What the full table gave and a member-only
// product must keep: the C - count non-member terms of the sum-exp seed
// the online state (m = -1e30, z = C - count), so they vanish at the first
// member tile's rescale as in f32 and no member gives -1e30 + log C; a
// label of a non-member in [0, C) picks its -1e30 (mask[label] read per
// slot), a label outside picks 0.
//
// The full-table CUDA-core kernel (ce_kernel): the backward of every route
// but the tensor-core one, and the forward launched beside the tensor-core
// kernel (skip_packed), which returns at once unless the flag selects the
// full table (a contrast set over the capacity).  A block of 256 threads
// owns 64 pixel rows and walks the table in tiles of 128 classes.
//   1. Scale: each warp sums x^2 of 8 rows in f64.
//   2. Logits: a 64 x 128 register-tiled product over D in chunks of 16
//      dims, double-buffered in shared memory; staging rounds x * rs to T.
//      Each thread holds 4 x 8 sums.  The tile lands class-major in shared
//      memory with the mask and 1/tau applied.
//   3. Row statistics: four threads per row scan the tile (pitch 72 floats:
//      conflict-free), with an online max / sum-exp across tiles (one tile:
//      the plain formula exactly) and the slot picks.
//   4. Backward only: per tile, delta into the same shared tile, then
//      d_emb [64, D] += delta_tile [64, 128] x table_tile [128, D]; last,
//      one warp per row applies the normalisation VJP.  The backward does
//      the product twice for one class tile and three times for several
//      (pass 1 for the row statistics, pass 2 recomputes each tile).  The
//      d_emb tile [64, D + 4] f32 is in shared memory up to D = 648; beyond,
//      it lives in a device workspace, one slice per block, and a grid of
//      at most one block per SM strides over the row tiles.
// The TPU kernel's class-major [C, TILE_N] layout and row-tile search are
// TPU work; here rows are the block's axis.  Any N, C, K; D % 8 == 0;
// S <= 4.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;              // pixel rows per block
constexpr int kCols = 128;             // classes (or dims) per tile
constexpr int kChunk = 16;             // k per staging step
constexpr int kAPitch = kRows + 4;
constexpr int kBPitch = kCols + 4;
constexpr int kLPitch = kRows + 8;     // == 8 mod 32: conflict-free scans
constexpr int kMaxSmem = 232448;

struct Smem {
  float a[2][kChunk][kAPitch];  // A operand, k-major
  float b[2][kChunk][kBPitch];  // B operand, k-major
  float l[kCols][kLPitch];      // logits (then delta) of a tile, class-major
  float rs[kRows];
  int ids[kCols];
  int mask[kCols];
};

struct Params {
  const void* x;
  const float* temperature;
  const float* coeff;  // backward: the upstream gradient of the sum
  const int* labels;   // [S, n]
  const float* valid;  // [S, n]
  long long n;
  int d;
  const void* table;   // [c, d]
  const int* mask;     // [c]
  int c;
  const void* ptable;  // [k, d] packed members, or NULL
  const int* pmask;    // [k]
  const int* pids;     // [k] global ids
  int k;
  const int* use_packed;  // device flag, or NULL (full table)
  int skip_packed;        // return at once where the flag selects packed
  float* ce;              // forward: [n] per-row CE
  void* dx;               // backward: [n, d] in x's dtype
  float* dtau;            // backward: [n] per-row d log tau
  float* workspace;       // backward, where de_in_smem(d) fails: d_emb tiles
};

template <typename T>
__device__ __forceinline__ void load_group(const T* base, long long rows,
                                           int d, long long r, int dim,
                                           T (&v)[8]) {
  if (r < rows && dim < d) {
    rc::load8(base + r * d + dim, v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = rc::round_to(0.f, T());
  }
}

// acc[i][j] for rows ty*4+i and columns (j < 4 ? 0 : 64) + tx*4 + (j & 3).
__device__ __forceinline__ void mma_chunk(const float (&a)[kChunk][kAPitch],
                                          const float (&b)[kChunk][kBPitch],
                                          int tx, int ty,
                                          float (&acc)[4][8]) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&a[k][ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[k][64 + tx * 4]);
    const float av[4] = {a0.x, a0.y, a0.z, a0.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The logits of classes [c0, c0 + 128) for the block's rows into sm.l
// (class-major), masked (sm.mask) and scaled by inv_temp.  sm.ids/sm.mask
// of the tile must be written before the call.
template <typename T>
__device__ void logits_tile(const T* x, long long n, long long row0, int d,
                            const T* table, int count, int c0,
                            float inv_temp, Smem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int st_row = tid >> 1, st_dim = (tid & 1) * 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  T pv[8], tv[8];
  const int chunks = (d + kChunk - 1) / kChunk;
  auto fetch = [&](int chunk) {
    const int dim = chunk * kChunk + st_dim;
    if (st_row < kRows) load_group(x + row0 * d, n - row0, d, st_row, dim, pv);
    load_group(table + (long long)c0 * d, (long long)(count - c0), d, st_row,
               dim, tv);
  };
  auto stage = [&](int buf) {
    if (st_row < kRows) {
      const float scale = sm.rs[st_row];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sm.a[buf][st_dim + i][st_row] =
            rc::to_float(rc::round_to(rc::to_float(pv[i]) * scale, T()));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm.b[buf][st_dim + i][st_row] = rc::to_float(tv[i]);
  };
  fetch(0);
  stage(0);
  __syncthreads();
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int buf = chunk & 1;
    if (chunk + 1 < chunks) fetch(chunk + 1);
    mma_chunk(sm.a[buf], sm.b[buf], tx, ty, acc);
    // the other buffer was last read before the previous barrier
    if (chunk + 1 < chunks) stage(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cl = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
    const bool live = sm.mask[cl] != 0;
    float4 v;
    v.x = live ? acc[0][j] * inv_temp : rc::kNegInf;
    v.y = live ? acc[1][j] * inv_temp : rc::kNegInf;
    v.z = live ? acc[2][j] * inv_temp : rc::kNegInf;
    v.w = live ? acc[3][j] * inv_temp : rc::kNegInf;
    *reinterpret_cast<float4*>(&sm.l[cl][ty * 4]) = v;
  }
  __syncthreads();
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The 64 pixel rows from row0 of the block: the CE (forward) or dx and
// dtau (backward).  de is the [64, d + 4] f32 d_emb tile (backward).
template <typename T, int S, bool kBackward>
__device__ __forceinline__ void ce_rows(const Params& p, Smem& sm, float* de,
                                        long long row0) {
  const int de_pitch = p.d + 4;

  const bool packed = p.use_packed != nullptr && *p.use_packed != 0;
  const T* table = static_cast<const T*>(packed ? p.ptable : p.table);
  const int* mask = packed ? p.pmask : p.mask;
  const int* ids = packed ? p.pids : nullptr;
  const int count = packed ? p.k : p.c;
  const float inv_temp = 1.0f / *p.temperature;
  const T* x = static_cast<const T*>(p.x);
  const int d = p.d;
  const long long n = p.n;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // 1. rs[r] = 1/sqrt(max(sum x^2, 1e-24)), the sum in f64
  constexpr int kRowsPerWarp = kRows / (kThreads / 32);
  for (int r = warp * kRowsPerWarp; r < (warp + 1) * kRowsPerWarp; ++r) {
    double sq = 0.0;
    if (row0 + r < n) {
      for (int g = lane * 8; g < d; g += 256) {
        T v[8];
        rc::load8(x + (row0 + r) * d + g, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const double xv = rc::to_float(v[i]);
          sq = fma(xv, xv, sq);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (lane == 0) sm.rs[r] = (float)(1.0 / sqrt(fmax(sq, 1e-24)));
  }
  __syncthreads();  // rs is read by other warps when staging

  // scan roles: four threads per row, classes q, q + 4, ... of a tile
  const int r = warp * 8 + (lane >> 2);
  const int q = lane & 3;
  const long long row = row0 + r;
  const bool live_row = row < n;
  const float coeff = kBackward ? *p.coeff : 1.f;
  int lab[S];
  float w[S];
  float wsum = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    lab[s] = live_row ? p.labels[s * n + row] : INT_MIN;
    const float v = live_row ? p.valid[s * n + row] : 0.f;
    w[s] = kBackward ? __fmul_rn(coeff, v) : v;
    wsum = __fadd_rn(wsum, w[s]);
  }

  auto load_tile_ids = [&](int c0, int cn) {
    if (tid < kCols) {
      sm.ids[tid] = tid < cn ? (ids != nullptr ? ids[c0 + tid] : c0 + tid)
                             : INT_MIN;
      sm.mask[tid] = tid < cn ? mask[c0 + tid] : 0;
    }
  };

  // 2-3. logits tile by tile, online row statistics and slot picks
  float m_run = -CUDART_INF_F, z = 0.f, t_el = 0.f;
  float pick[S];
#pragma unroll
  for (int s = 0; s < S; ++s) pick[s] = 0.f;
  const int tiles = (count + kCols - 1) / kCols;
  for (int c0 = 0; c0 < count; c0 += kCols) {
    const int cn = min(kCols, count - c0);
    load_tile_ids(c0, cn);
    logits_tile(x, n, row0, d, table, count, c0, inv_temp, sm);
    float mt = -CUDART_INF_F;
    for (int c = q; c < cn; c += 4) mt = fmaxf(mt, sm.l[c][r]);
    const float m_new = fmaxf(m_run, quad_max(mt));
    float ps = 0.f, pt = 0.f;
    for (int c = q; c < cn; c += 4) {
      const float l = sm.l[c][r];
      const float e = expf(l - m_new);
      ps += e;
      if (kBackward) pt = __fadd_rn(pt, __fmul_rn(e, l));
      const int id = sm.ids[c];
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (id == lab[s]) pick[s] += l;
    }
    const float scale = expf(m_run - m_new);  // 0 on the first tile
    z = __fadd_rn(__fmul_rn(z, scale), quad_sum(ps));
    if (kBackward) t_el = __fadd_rn(__fmul_rn(t_el, scale), quad_sum(pt));
    m_run = m_new;
    __syncthreads();  // the tile, ids and mask are consumed
  }
  float wpick = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s)
    wpick = __fadd_rn(wpick, __fmul_rn(w[s], quad_sum(pick[s])));

  if (!kBackward) {
    const float lse = m_run + logf(z);
    if (live_row && q == 0)
      p.ce[row] = __fsub_rn(__fmul_rn(wsum, lse), wpick);
    return;
  }

  const float inv_z = 1.0f / z;
  const float f = __fmul_rn(wsum, inv_z);
  if (live_row && q == 0)
    p.dtau[row] = __fsub_rn(wpick, __fmul_rn(wsum, __fmul_rn(t_el, inv_z)));

  // 4. per tile: delta, then d_emb += delta x table
  const int tx = tid & 15, ty = tid >> 4;
  for (int c0 = 0; c0 < count; c0 += kCols) {
    const int cn = min(kCols, count - c0);
    if (tiles > 1) {
      load_tile_ids(c0, cn);
      logits_tile(x, n, row0, d, table, count, c0, inv_temp, sm);
    }
    for (int c = q; c < kCols; c += 4) {
      float dl = 0.f;
      if (c < cn) {
        dl = __fmul_rn(expf(sm.l[c][r] - m_run), f);
        const int id = sm.ids[c];
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (id == lab[s]) dl = __fsub_rn(dl, w[s]);
      }
      sm.l[c][r] = rc::to_float(rc::round_to(dl, T()));
    }
    __syncthreads();
    for (int d0 = 0; d0 < d; d0 += kCols) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      const int st_k = tid >> 4, st_col = (tid & 15) * 8;
      for (int k0 = 0; k0 < kCols; k0 += kChunk) {
        T tv[8];
        load_group(table + (long long)(c0 + k0) * d, (long long)(count - c0 - k0),
                   d, st_k, d0 + st_col, tv);
#pragma unroll
        for (int i = 0; i < 8; ++i) sm.b[0][st_k][st_col + i] = rc::to_float(tv[i]);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(&sm.l[k0 + k][ty * 4]);
          const float4 b0 =
              *reinterpret_cast<const float4*>(&sm.b[0][k][tx * 4]);
          const float4 b1 =
              *reinterpret_cast<const float4*>(&sm.b[0][k][64 + tx * 4]);
          const float av[4] = {a0.x, a0.y, a0.z, a0.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = d0 + half * 64 + tx * 4;
          if (col >= d) continue;
          float4* dst = reinterpret_cast<float4*>(
              &de[(ty * 4 + i) * de_pitch + col]);
          float4 v = make_float4(acc[i][half * 4], acc[i][half * 4 + 1],
                                 acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
          if (c0 > 0) {
            const float4 o = *dst;
            v.x += o.x;
            v.y += o.y;
            v.z += o.z;
            v.w += o.w;
          }
          *dst = v;
        }
      }
    }
    __syncthreads();  // de is complete for this tile; sm.l is consumed
  }

  // 5. dx = rs * (d_emb - emb * (emb . d_emb)), one warp per row
  T* dx = static_cast<T*>(p.dx);
  for (int rr = warp * kRowsPerWarp; rr < (warp + 1) * kRowsPerWarp; ++rr) {
    const long long grow = row0 + rr;
    if (grow >= n) break;
    const float rsr = sm.rs[rr];
    float proj = 0.f;
    for (int g = lane * 8; g < d; g += 256) {
      T v[8];
      rc::load8(x + grow * d + g, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float emb = __fmul_rn(rc::to_float(v[i]), rsr);
        const float dd = __fmul_rn(de[rr * de_pitch + g + i], inv_temp);
        proj = __fadd_rn(proj, __fmul_rn(emb, dd));
      }
    }
    proj = rc::warp_sum(proj);
    for (int g = lane * 8; g < d; g += 256) {
      T v[8], o[8];
      rc::load8(x + grow * d + g, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float emb = __fmul_rn(rc::to_float(v[i]), rsr);
        const float dd = __fmul_rn(de[rr * de_pitch + g + i], inv_temp);
        o[i] = rc::round_to(
            __fmul_rn(rsr, __fsub_rn(dd, __fmul_rn(emb, proj))), T());
      }
      rc::store8(dx + grow * d + g, o);
    }
  }
}

// kWorkspace: the d_emb tiles live in p.workspace, one per block, and the
// grid (bounded by the SMs) strides over the row tiles.
template <typename T, int S, bool kBackward, bool kWorkspace>
__global__ void __launch_bounds__(kThreads, kBackward ? 1 : 2)
    ce_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (p.skip_packed && *p.use_packed != 0) return;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  float* de = kWorkspace ? p.workspace + (size_t)blockIdx.x * kRows * (p.d + 4)
                         : reinterpret_cast<float*>(smem_raw + sizeof(Smem));
  for (long long row0 = (long long)blockIdx.x * kRows; row0 < p.n;
       row0 += (long long)gridDim.x * kRows) {
    ce_rows<T, S, kBackward>(p, sm, de, row0);
    __syncthreads();  // sm and de are free for the next tile
  }
}

// The backward keeps its d_emb tile in shared memory while sizeof(Smem) +
// 64 (d + 4) floats fit in 227 KB (d <= 648); beyond, in a workspace of one
// tile per block, with one block per SM.
bool de_in_smem(int d) {
  return sizeof(Smem) + (size_t)kRows * (d + 4) * sizeof(float) <=
         (size_t)kMaxSmem;
}

long long row_tiles(long long n) { return (n + kRows - 1) / kRows; }

// Blocks of the backward's grid at width d: a block per row tile, or at
// most one per SM when the d_emb tiles live in the workspace.
long long bwd_blocks(int d, long long n) {
  if (de_in_smem(d)) return row_tiles(n);
  return std::min<long long>(row_tiles(n), rc::sm_count());
}

size_t workspace_bytes(int d, long long n) {
  return de_in_smem(d) ? 0
                       : (size_t)bwd_blocks(d, n) * kRows * (d + 4) *
                             sizeof(float);
}

template <typename T, int S, bool kBackward, bool kWorkspace>
cudaError_t launch_grid(const Params& p, long long blocks,
                        cudaStream_t stream) {
  const size_t smem =
      sizeof(Smem) + (kBackward && !kWorkspace
                          ? (size_t)kRows * (p.d + 4) * sizeof(float)
                          : 0);
  cudaError_t err = cudaFuncSetAttribute(
      ce_kernel<T, S, kBackward, kWorkspace>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ce_kernel<T, S, kBackward, kWorkspace>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int S, bool kBackward>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (!kBackward) return launch_grid<T, S, false, false>(p, row_tiles(p.n),
                                                         stream);
  if (de_in_smem(p.d))
    return launch_grid<T, S, true, false>(p, row_tiles(p.n), stream);
  if (p.workspace == nullptr) return cudaErrorInvalidValue;
  return launch_grid<T, S, true, true>(p, bwd_blocks(p.d, p.n), stream);
}

template <bool kBackward>
cudaError_t dispatch(const Params& p, int is_bf16, int slots,
                     cudaStream_t st) {
  if (p.d % 8 != 0 || p.d <= 0 || p.c <= 0 || p.n <= 0 ||
      (p.use_packed != nullptr && p.k <= 0) ||
      (p.skip_packed && p.use_packed == nullptr))
    return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (is_bf16) {
    switch (slots) {
      case 1: return launch<bf, 1, kBackward>(p, st);
      case 2: return launch<bf, 2, kBackward>(p, st);
      case 3: return launch<bf, 3, kBackward>(p, st);
      case 4: return launch<bf, 4, kBackward>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  // the forward runs here only beside the (bf16) tensor-core kernel
  if constexpr (kBackward) {
    switch (slots) {
      case 1: return launch<float, 1, true>(p, st);
      case 2: return launch<float, 2, true>(p, st);
      case 3: return launch<float, 3, true>(p, st);
      case 4: return launch<float, 4, true>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

// ---- bf16 packed table: tensor cores ---------------------------------------

constexpr int kMaxTcDims = 1280;  // A (64 rows) + the B ring within 227 KB
constexpr int kMaxTcBwdClasses = rc::tc::kTileN;  // delta: one class tile
// The backward's A tile spans at least 6 blocks: after the logits, a
// warpgroup's own rows of blocks 0-1 hold delta, 2-3 and 4-5 stage x and dx.
constexpr int kScratchBlocks = 6;

struct TcParams {
  const __nv_bfloat16* x;
  const float* temperature;
  const float* coeff;  // backward: the upstream gradient of the sum
  const int* labels;   // [S, n]
  const float* valid;  // [S, n]
  long long n;
  int d;
  const int* pmask;    // [k]
  const int* pids;     // [k] global ids
  int k;
  const int* use_packed;  // run only where it is non-zero (NULL: always)
  float* ce;              // forward: [n]
  __nv_bfloat16* dx;      // backward: [n, d]
  float* dtau;            // backward: [n]
};

// The label slots of the two rows a thread holds (rows past n: none).
template <int S>
struct RowSlots {
  int lab[2][S];
  float w[2][S];
  float wsum[2];

  __device__ __forceinline__ void load(const TcParams& p,
                                       const long long (&row)[2],
                                       float coeff, bool scaled) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = row[h] < p.n;
      wsum[h] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        lab[h][s] = live ? p.labels[s * p.n + row[h]] : INT_MIN;
        const float v = live ? p.valid[s * p.n + row[h]] : 0.f;
        w[h][s] = scaled ? __fmul_rn(coeff, v) : v;
        wsum[h] = __fadd_rn(wsum[h], w[h][s]);
      }
    }
  }
};

// This thread's 32 columns of the class tile from c0 as bit masks, bit b
// = mask_bit(i) for accumulator register i (as rc::tc::dead_mask):
// `exists` where the column is < k, `live` where it also is a member (mask
// != 0), match[h][s] where its packed id is the label of slot s of row h.
// Bit masks, not the 32 ids, keep the epilogue within its registers.
template <int S>
struct TileCols {
  unsigned exists, live;
  unsigned match[2][S];

  // kRound columns' ids and masks are loaded at a time.
  template <int kRound>
  __device__ __forceinline__ void load(const TcParams& p, int c0, int lane,
                                       const RowSlots<S>& sl) {
    exists = live = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < S; ++s) match[h][s] = 0;
#pragma unroll 1
    for (int b0 = 0; b0 < 32; b0 += kRound) {
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int b = b0 + q;
        const int col = c0 + (b >> 1) * 8 + ((lane & 3) << 1) + (b & 1);
        const int at = min(col, p.k - 1);
        const int id = __ldg(p.pids + at);
        const bool ok = col < p.k;
        exists |= (unsigned)ok << b;
        live |= (unsigned)(ok && __ldg(p.pmask + at) != 0) << b;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int s = 0; s < S; ++s)
            match[h][s] |= (unsigned)(ok && id == sl.lab[h][s]) << b;
      }
    }
  }

  __device__ __forceinline__ bool has(int i) const {
    return (exists >> rc::tc::mask_bit(i)) & 1u;
  }
  // The logit of accumulator register i: masked members score -1e30.
  __device__ __forceinline__ float logit(const float (&acc)[64], int i,
                                         float inv_temp) const {
    return (live >> rc::tc::mask_bit(i)) & 1u ? acc[i] * inv_temp
                                              : rc::kNegInf;
  }
  // Register i's column carries the label of slot s of its row.
  __device__ __forceinline__ bool picks(int i, int s) const {
    return (match[(i >> 1) & 1][s] >> rc::tc::mask_bit(i)) & 1u;
  }
};

// Registers a thread after the producer warpgroup gives its own up: 2 x
// 128 x 232 + 128 x 40 = 64,512 of the SM's 65,536 (the block's share at
// 384 threads and 168 registers, the compiler's cap).
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kTcThreads = rc::tc::kMaxWarpgroups * 128 + 128;

// Shared set-up of both kernels: the block's layout and its A tile.  The
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

// Forward: per class tile, the logits from the sums, an online max /
// sum-exp per row (quad shuffles) and the slot picks.
template <int S>
__global__ void __launch_bounds__(kTcThreads, 1)
    ce_tc_fwd_kernel(const __grid_constant__ CUtensorMap table_map,
                     const TcParams p) {
  using namespace rc::tc;
  if (p.use_packed != nullptr && *p.use_packed == 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcBlock blk;
  blk.init(smem_raw, p.d, 0);
  if (blk.producer()) {
    if ((int)threadIdx.x == blk.nthreads)
      blk.ring.produce(&table_map, p.k, blk.k16);
    return;
  }
  normalized_rows(blk.smem, blk.a, blk.a_block_bytes, blk.rows, p.x, p.n,
                  p.d, blk.row0, blk.nthreads, nullptr);

  RowSlots<S> sl;
  sl.load(p, blk.row, 1.f, false);
  const float inv_temp = 1.0f / *p.temperature;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, z[2] = {0.f, 0.f};
  float pick[2][S];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < S; ++s) pick[h][s] = 0.f;
  TileCols<S> cols;
  int chunk = 0;  // the ring's next chunk
  for (int c0 = 0; c0 < p.k; c0 += kTileN) {
    cols.template load<32>(p, c0, blk.lane, sl);
    float acc[64];
    tile_sims(blk.ring, blk.a_rows(), blk.a_block_bytes, blk.k16, blk.wg_tid,
              chunk, acc);
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (cols.has(i))
        mt[(i >> 1) & 1] =
            fmaxf(mt[(i >> 1) & 1], cols.logit(acc, i, inv_temp));
    float m_new[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m_run[h], quad_max(mt[h]));
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (!cols.has(i)) continue;
      const int h = (i >> 1) & 1;
      const float l = cols.logit(acc, i, inv_temp);
      ps[h] += expf(l - m_new[h]);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (cols.picks(i, s)) pick[h][s] += l;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float scale = expf(m_run[h] - m_new[h]);  // 0 on tile 0
      z[h] = __fadd_rn(__fmul_rn(z[h], scale), quad_sum(ps[h]));
      m_run[h] = m_new[h];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float wpick = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s)
      wpick = __fadd_rn(wpick, __fmul_rn(sl.w[h][s], quad_sum(pick[h][s])));
    const float lse = m_run[h] + logf(z[h]);
    if ((blk.lane & 3) == 0 && blk.row[h] < p.n)
      p.ce[blk.row[h]] = __fsub_rn(__fmul_rn(sl.wsum[h], lse), wpick);
  }
}

// Backward (k <= 128: one class tile).  The logits as in the forward, then
// the row statistics, dtau and delta in registers; delta, rounded to bf16,
// goes to the warpgroup's own rows of the A tile, which the logits no
// longer need ([64 rows, 128 classes] in the SW128 layout: dim blocks 0-1).
// Then d_emb = delta x table in 128-dim chunks, B the transposed table
// [d, k8] through the ring, twice: pass 0 sums proj = emb . d_emb, pass 1
// writes dx.
template <int S>
__global__ void __launch_bounds__(kTcThreads, 1)
    ce_tc_bwd_kernel(const __grid_constant__ CUtensorMap table_map,
                     const __grid_constant__ CUtensorMap table_t_map,
                     const TcParams p) {
  using namespace rc::tc;
  if (p.use_packed != nullptr && *p.use_packed == 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcBlock blk;
  blk.init(smem_raw, p.d, kScratchBlocks);
  const int d = p.d;
  const int dchunks = (d + kTileN - 1) / kTileN;  // 128-dim chunks of d_emb
  const int kc16 = (p.k + 15) / 16;               // 16-class steps
  const int cblocks = (kc16 + 3) / 4;             // 64-class blocks: 1 or 2
  if (blk.producer()) {
    if ((int)threadIdx.x != blk.nthreads) return;
    const Ring& ring = blk.ring;
    int i = 0;
    auto push = [&](const CUtensorMap* map, int k0, int r0) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(ring.empty(s), ((i / kStages) - 1) & 1);
      mbar_expect_tx(ring.full(s), kChunkBytes);
      tma_load(ring.stage(s), map, k0, r0, ring.full(s));
      ++i;
    };
    for (int kb = 0; kb < blk.blocks_k; ++kb)
      push(&table_map, kb * kBlockDims, 0);
    for (int pass = 0; pass < 2; ++pass)
      for (int dc = 0; dc < dchunks; ++dc)
        for (int cb = 0; cb < cblocks; ++cb)
          push(&table_t_map, cb * kBlockDims, dc * kTileN);
    return;
  }
  float* rs_tile = reinterpret_cast<float*>(blk.extra());
  normalized_rows(blk.smem, blk.a, blk.a_block_bytes, blk.rows, p.x, p.n, d,
                  blk.row0, blk.nthreads, rs_tile);

  int next = 0;  // the ring's next chunk
  float acc[64];
  tile_sims(blk.ring, blk.a_rows(), blk.a_block_bytes, blk.k16, blk.wg_tid,
            next, acc);
  // loaded after the sums, which hold 128 registers while they run
  float rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rs[h] = rs_tile[blk.wg * kWarpRows + frag_row(h, blk.wg_tid)];
  const float inv_temp = 1.0f / *p.temperature;
  {
    RowSlots<S> sl;
    sl.load(p, blk.row, *p.coeff, true);
    // in rounds of 8: all 32 columns' loads at once, beside the logits,
    // spilled registers
    TileCols<S> cols;
    cols.template load<8>(p, 0, blk.lane, sl);
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (cols.has(i))
        m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], cols.logit(acc, i, inv_temp));
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = quad_max(m[h]);
    float ps[2] = {0.f, 0.f}, pt[2] = {0.f, 0.f}, pick[2][S];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < S; ++s) pick[h][s] = 0.f;
    // acc[i] becomes e_i = exp(logit_i - m) (0 past k), which delta reads
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i >> 1) & 1;
      const float l = cols.logit(acc, i, inv_temp);
      const float e = cols.has(i) ? expf(l - m[h]) : 0.f;
      acc[i] = e;
      if (!cols.has(i)) continue;
      ps[h] += e;
      pt[h] = __fadd_rn(pt[h], __fmul_rn(e, l));
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (cols.picks(i, s)) pick[h][s] += l;
    }
    float f[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float wpick = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s)
        wpick = __fadd_rn(wpick, __fmul_rn(sl.w[h][s], quad_sum(pick[h][s])));
      const float inv_z = 1.0f / quad_sum(ps[h]);
      const float t_el = quad_sum(pt[h]);
      f[h] = __fmul_rn(sl.wsum[h], inv_z);
      if ((blk.lane & 3) == 0 && blk.row[h] < p.n)
        p.dtau[blk.row[h]] =
            __fsub_rn(wpick, __fmul_rn(sl.wsum[h], __fmul_rn(t_el, inv_z)));
    }
    // delta_c = e_c (W / Z) - sum_s [id_c == l_s] w_s, 0 past k, rounded
    // to bf16 in pairs of adjacent classes, into the A tile
    auto delta = [&](int i) {
      const int h = (i >> 1) & 1;
      if (!cols.has(i)) return 0.f;
      float dl = __fmul_rn(acc[i], f[h]);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (cols.picks(i, s)) dl = __fsub_rn(dl, sl.w[h][s]);
      return dl;
    };
    unsigned char* own = blk.smem + blk.wg * kWarpRows * kRowBytes;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int c = frag_col(i, blk.lane);
      *reinterpret_cast<uint32_t*>(
          own + (c >> 6) * blk.a_block_bytes +
          swizzle(frag_row((i >> 1) & 1, blk.wg_tid), (c & 63) >> 3) +
          (c & 7) * 2) = pack_bf16x2(delta(i), delta(i + 1));
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + blk.wg) : "memory");
  }

  // d_emb chunks: pass 0 sums proj = emb . d_emb, pass 1 writes dx.  The
  // warpgroup's own rows of A-tile blocks 2-3 stage the chunk's x (copied
  // in 16-byte pieces while the products run) and blocks 4-5 its dx (copied
  // out in 16-byte pieces), both in the swizzled layout, where the 8 rows
  // of a fragment's quad groups fall in distinct banks.
  const uint32_t own = blk.a_rows();
  unsigned char* own_ptr = blk.smem + blk.wg * kWarpRows * kRowBytes;
  const long long wg_row0 = blk.row0 + blk.wg * kWarpRows;
  // byte offset of dims (2 j', 2 j' + 1) = local dim c of row r in blocks
  // b0, b0 + 1 (64 dims each)
  auto staged = [&](int b0, int r, int c) {
    return (b0 + (c >> 6)) * blk.a_block_bytes + swizzle(r, (c & 63) >> 3) +
           (c & 7) * 2;
  };
  float proj[2] = {0.f, 0.f};
  for (int pass = 0; pass < 2; ++pass) {
    for (int dc = 0; dc < dchunks; ++dc) {
      // the previous chunk's staged x and dx are consumed
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + blk.wg) : "memory");
      for (int q = blk.wg_tid; q < kWarpRows * 16; q += 128) {
        const int r = q >> 4, c = (q & 15) * 8;
        const int dim = dc * kTileN + c;
        const bool ok = wg_row0 + r < p.n && dim < d;
        cp_async16(own + staged(2, r, c),
                   ok ? p.x + (wg_row0 + r) * d + dim : p.x, ok);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      float dacc[64];
      fence_regs(dacc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int cb = 0; cb < 2; ++cb) {
        if (cb < cblocks) {
          const int s = (next + cb) % kStages;
          mbar_wait(blk.ring.full(s), ((next + cb) / kStages) & 1);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (cb * 4 + k < kc16)
              wgmma_m64n128k16(
                  dacc, sw128_desc(own + cb * blk.a_block_bytes + k * 32),
                  sw128_desc(blk.ring.stage(s) + k * 32), cb > 0 || k > 0);
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + blk.wg) : "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(dacc);
      for (int cb = 0; cb < cblocks; ++cb)
        if (blk.wg_tid == 0)
          mbar_arrive(blk.ring.empty((next + cb) % kStages));
      next += cblocks;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = (i >> 1) & 1;
        const int r = frag_row(h, blk.wg_tid), c = frag_col(i, blk.lane);
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
            own_ptr + staged(2, r, c));
        const float e0 = __fmul_rn(__low2float(xv), rs[h]);
        const float e1 = __fmul_rn(__high2float(xv), rs[h]);
        const float d0 = __fmul_rn(dacc[i], inv_temp);
        const float d1 = __fmul_rn(dacc[i + 1], inv_temp);
        if (pass == 0) {
          proj[h] = __fadd_rn(proj[h], __fmul_rn(e0, d0));
          proj[h] = __fadd_rn(proj[h], __fmul_rn(e1, d1));
        } else {
          *reinterpret_cast<uint32_t*>(own_ptr + staged(4, r, c)) =
              pack_bf16x2(
                  __fmul_rn(rs[h], __fsub_rn(d0, __fmul_rn(e0, proj[h]))),
                  __fmul_rn(rs[h], __fsub_rn(d1, __fmul_rn(e1, proj[h]))));
        }
      }
      if (pass == 1) {
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + blk.wg) : "memory");
        for (int q = blk.wg_tid; q < kWarpRows * 16; q += 128) {
          const int r = q >> 4, c = (q & 15) * 8;
          const int dim = dc * kTileN + c;
          if (wg_row0 + r < p.n && dim < d)
            *reinterpret_cast<uint4*>(p.dx + (wg_row0 + r) * d + dim) =
                *reinterpret_cast<const uint4*>(own_ptr + staged(4, r, c));
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) proj[h] = quad_sum(proj[h]);
    }
  }
}

template <int S>
cudaError_t launch_tc_fwd(const TcParams& p, const void* ptable,
                          cudaStream_t stream) {
  const int k16 = (p.d + 15) / 16;
  const int wgs = rc::tc::warpgroups_for(k16);
  const int rows = wgs * rc::tc::kWarpRows;
  const size_t smem = rc::tc::smem_bytes(rows, k16);
  CUtensorMap map;
  cudaError_t err = rc::tc::make_tensor_map(&map, ptable, p.k, p.d);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_tc_fwd_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.n + rows - 1) / rows));
  ce_tc_fwd_kernel<S><<<grid, wgs * 128 + 128, smem, stream>>>(map, p);
  return cudaGetLastError();
}

constexpr int kRsBytes = sizeof(float);  // the backward's rs per row

template <int S>
cudaError_t launch_tc_bwd(const TcParams& p, const void* ptable,
                          const void* ptable_t, cudaStream_t stream) {
  // the A tile spans at least the blocks that delta, x and dx take
  const int k16 = std::max((p.d + 15) / 16, 4 * kScratchBlocks);
  const int wgs = rc::tc::warpgroups_for(k16, kRsBytes);
  const int rows = wgs * rc::tc::kWarpRows;
  const size_t smem = rc::tc::smem_bytes(rows, k16, kRsBytes);
  CUtensorMap map, map_t;
  cudaError_t err = rc::tc::make_tensor_map(&map, ptable, p.k, p.d);
  if (err != cudaSuccess) return err;
  err = rc::tc::make_tensor_map(&map_t, ptable_t, p.d, (p.k + 7) / 8 * 8);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_tc_bwd_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.n + rows - 1) / rows));
  ce_tc_bwd_kernel<S><<<grid, wgs * 128 + 128, smem, stream>>>(map, map_t,
                                                                p);
  return cudaGetLastError();
}

bool tc_shape_ok(const TcParams& p, int slots) {
  return p.d % 8 == 0 && p.d > 0 && p.d <= kMaxTcDims && p.k > 0 &&
         p.n > 0 && slots >= 1 && slots <= 4;
}

// ---- f32, and bf16 without a tensor-core packed table: the members only ---

namespace member {

// the loop: common.cuh (declarations, so that they hide the file's own
// constants of the same names)
using rc::simt::col_of;
using rc::simt::kCols;
using rc::simt::kRows;
using rc::simt::kThreads;
using rc::simt::Layout;
using rc::simt::Roles;
using rc::simt::roles_of;
using rc::simt::score_tiles;

constexpr int kMaxSlots = 4;

struct MemberParams {
  const void* x;
  const float* temperature;
  const int* labels;     // [S, n]
  const float* valid;    // [S, n]
  long long n;
  int d;
  const float* table_t;  // [d, ldt] f32: the selected table's members first
  int ldt;
  const int* ids;        // [>= count] their global ids
  const int* count;      // [1] members
  const int* mask;       // [c] the full table's membership
  int c;
  const int* pmask;      // [k] packed membership, or NULL
  const int* pids;       // [k] packed global ids
  int k;
  const int* use_packed;  // device flag (packed where non-zero), or NULL
  float* ce;              // [n] per-row CE
};

// Dynamic shared memory beyond the loop's (rc::simt::Layout): the block's
// labels [S][kRows], and each class half's per-row state, its online max,
// sum-exp and slot picks [2][2 + S][kRows], which only the row's owner
// lane writes (so the loop carries no per-row registers).  107,008 bytes
// for f32: two blocks per SM.
template <typename T>
struct Extra {
  static constexpr int kLabels = Layout<T>::kEnd;
  static constexpr int kState = kLabels + kMaxSlots * kRows * 4;
  static constexpr int kBytes = kState + 2 * (2 + kMaxSlots) * kRows * 4;
};

// Reductions over the 8 lanes of a quarter warp (the same 8 rows).
__device__ __forceinline__ float quarter_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float quarter_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads, 2)
    ce_members_kernel(const MemberParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* lab = reinterpret_cast<int*>(smem + Extra<T>::kLabels);
  const int tid = threadIdx.x;
  const Roles roles = roles_of(tid);
  const long long base = (long long)blockIdx.x * kRows;
  const long long n = p.n;
  const int count = __ldg(p.count);
  const bool packed = p.use_packed != nullptr && *p.use_packed != 0;
  const int total = packed ? p.k : p.c;  // rows of the selected table
  const float inv_temp = 1.0f / *p.temperature;
  const int* __restrict__ ids = p.ids;
  for (int i = tid; i < S * kRows; i += kThreads) {
    const long long row = base + i % kRows;
    lab[i] = row < n ? p.labels[(i / kRows) * n + row] : INT_MIN;
  }
  // this half's state: st[0][r] max, st[1][r] sum-exp, st[2 + s][r] picks.
  // Half 0 starts from the plain version's total - count non-member terms
  // exp(-1e30 - m) at m = -1e30: they vanish at the first member tile's
  // rescale, as in f32, and with no member the value is -1e30 +
  // log(total), as the plain version's.
  float(*st)[kRows] = reinterpret_cast<float(*)[kRows]>(
      smem + Extra<T>::kState + roles.wn * (2 + kMaxSlots) * kRows * 4);
  const int own = roles.row0 + 4 * roles.wx;  // the row this lane owns
  st[0][own] = rc::kNegInf;
  st[1][own] = roles.wn == 0 ? (float)(total - count) : 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) st[2 + s][own] = 0.f;
  __syncthreads();

  score_tiles<T>(
      smem, static_cast<const T*>(p.x), p.table_t, p.ldt, count, n, p.d,
      roles, [&](float (&acc)[8][8], const float* rs, int tile) {
        const int c0 = tile * kCols + roles.col0;
        int id[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + col_of(j, roles.wx);
          id[j] = col < count ? __ldg(ids + col) : 0;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // logits: f32 scales the sum (rs * sum(x * t)), bf16 summed the
          // products of bf16(x * rs); then 1/tau; past the count -inf
          const int r = roles.row0 + 4 * i;
          const float scale = Layout<T>::kRoundFirst ? 1.f : rs[r];
          const float m_old = st[0][r];  // read before the owner writes
          float tmax = -CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float sim = Layout<T>::kRoundFirst
                                  ? acc[i][j]
                                  : __fmul_rn(acc[i][j], scale);
            acc[i][j] = c0 + col_of(j, roles.wx) < count
                            ? __fmul_rn(sim, inv_temp)
                            : -CUDART_INF_F;
            tmax = fmaxf(tmax, acc[i][j]);
          }
          const float m_new = fmaxf(m_old, quarter_max(tmax));
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) ps += expf(acc[i][j] - m_new);
          ps = quarter_sum(ps);
          float pv[S];  // the logits at the slots' labels (0 if none)
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int l = lab[s * kRows + r];
            float v = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (c0 + col_of(j, roles.wx) < count && id[j] == l)
                v += acc[i][j];
            pv[s] = quarter_sum(v);
          }
          __syncwarp();  // every lane has read m_old
          if (roles.wx == i) {
            st[1][r] = __fadd_rn(__fmul_rn(st[1][r], expf(m_old - m_new)),
                                 ps);
            st[0][r] = m_new;
#pragma unroll
            for (int s = 0; s < S; ++s) st[2 + s][r] += pv[s];
          }
        }
      });

  // The two class halves of a row merge in the owner of the first.
  __syncthreads();
  const long long row = base + own;
  if (roles.wn != 0 || row >= n) return;
  const float(*other)[kRows] = st + (2 + kMaxSlots);
  const float m0 = st[0][own], m1 = other[0][own];
  const float m = fmaxf(m0, m1);
  const float z = __fadd_rn(__fmul_rn(st[1][own], expf(m0 - m)),
                            __fmul_rn(other[1][own], expf(m1 - m)));
  const float lse = m + logf(z);
  float wsum = 0.f, wpick = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int l = lab[s * kRows + own];
    float pk = st[2 + s][own] + other[2 + s][own];
    // each row of the selected table with the label's id that is not a
    // member adds its logit, -1e30 (labels outside [0, c) hit no row of
    // the full table)
    if (packed) {
      for (int q = 0; q < p.k; ++q)
        if (__ldg(p.pids + q) == l && __ldg(p.pmask + q) == 0)
          pk = __fadd_rn(pk, rc::kNegInf);
    } else if (l >= 0 && l < p.c && __ldg(p.mask + l) == 0) {
      pk = __fadd_rn(pk, rc::kNegInf);
    }
    const float w = p.valid[s * n + row];
    wsum = __fadd_rn(wsum, w);
    wpick = __fadd_rn(wpick, __fmul_rn(w, pk));
  }
  p.ce[row] = __fsub_rn(__fmul_rn(wsum, lse), wpick);
}

template <typename T, int S>
cudaError_t launch(const MemberParams& p, cudaStream_t stream) {
  constexpr int smem = Extra<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ce_members_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  // all of the SM's shared memory, so that two blocks are resident
  err = cudaFuncSetAttribute(ce_members_kernel<T, S>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.n + kRows - 1) / kRows));
  ce_members_kernel<T, S><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const MemberParams& p, int is_bf16, int slots,
                     cudaStream_t st) {
  using bf = __nv_bfloat16;
  switch (slots * 2 + (is_bf16 ? 1 : 0)) {
    case 2: return launch<float, 1>(p, st);
    case 3: return launch<bf, 1>(p, st);
    case 4: return launch<float, 2>(p, st);
    case 5: return launch<bf, 2>(p, st);
    case 6: return launch<float, 3>(p, st);
    case 7: return launch<bf, 3>(p, st);
    case 8: return launch<float, 4>(p, st);
    case 9: return launch<bf, 4>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace member

}  // namespace

// The full-table forward launched beside the tensor-core forward: it
// returns at once where *use_packed != 0 (the tensor-core kernel takes that
// branch) and scores the full table otherwise.  x: [n, d] bf16,
// un-normalised, 16-byte aligned; temperature: [1] f32; labels: [slots, n]
// int32; valid: [slots, n] f32; table: [c, d] bf16 normalised; mask: [c]
// int32; the packed members ptable [k, d], pmask [k], pids [k]; the device
// flag use_packed.  ce: [n] f32.  1 <= slots <= 4.
extern "C" int rc_pixel_text_ce_fwd(
    const void* x, const float* temperature, const int* labels,
    const float* valid, int slots, long long n, int d, const void* table,
    const int* mask, int c, const void* ptable, const int* pmask,
    const int* pids, int k, const int* use_packed, float* ce,
    void* stream) {
  Params p{x,     temperature, nullptr, labels,     valid,   n,
           d,     table,       mask,    c,          ptable,  pmask,
           pids,  k,           use_packed, 1,       ce,      nullptr,
           nullptr, nullptr};
  return dispatch<false>(p, 1, slots, static_cast<cudaStream_t>(stream));
}

// The member-only forward, for the routes where the CUDA-core forward runs
// alone (f32, and bf16 without a tensor-core packed table).  x: [n, d] f32
// (is_bf16 == 0) or bf16; labels, valid, temperature, ce as
// rc_pixel_text_ce_fwd; table_t: [d, ldt] f32,
// 16-byte aligned, ldt % 4 == 0: the members of the table the flag selects
// (the packed one where *use_packed != 0, else the full one), first and
// transposed, with their global ids and *count (device memory) of them;
// the columns past the count are not read.  mask [c]: the full table's
// membership; pmask, pids [k]: the packed table's (NULL with use_packed).
// A label's pick is its member's logit, plus -1e30 for each row of the
// selected table with its id that is not a member.
extern "C" int rc_pixel_text_ce_members_fwd(
    const void* x, int is_bf16, const float* temperature, const int* labels,
    const float* valid, int slots, long long n, int d, const float* table_t,
    int ldt, const int* ids, const int* count, const int* mask, int c,
    const int* pmask, const int* pids, int k, const int* use_packed,
    float* ce, void* stream) {
  if (d % 8 != 0 || d <= 0 || c <= 0 || n <= 0 || ldt <= 0 ||
      ldt % 4 != 0 ||
      (use_packed != nullptr && (pmask == nullptr || pids == nullptr ||
                                 k <= 0)))
    return cudaErrorInvalidValue;
  const member::MemberParams p{x,     temperature, labels, valid, n,
                               d,     table_t,     ldt,    ids,   count,
                               mask,  c,           pmask,  pids,  k,
                               use_packed, ce};
  return member::dispatch(p, is_bf16, slots,
                          static_cast<cudaStream_t>(stream));
}

// As the forward, plus coeff: [1] f32, the upstream gradient of the summed
// CE; dx: [n, d] in x's dtype; dtau: [n] f32 per-row d log tau; workspace:
// rc_pixel_text_ce_workspace(d, n) bytes, 16-byte aligned (NULL when that
// is 0).
extern "C" int rc_pixel_text_ce_bwd(
    const void* x, int is_bf16, const float* temperature, const float* coeff,
    const int* labels, const float* valid, int slots, long long n, int d,
    const void* table, const int* mask, int c, const void* ptable,
    const int* pmask, const int* pids, int k, const int* use_packed,
    int skip_packed, void* dx, float* dtau, void* workspace, void* stream) {
  Params p{x,     temperature, coeff, labels,     valid,       n,
           d,     table,       mask,  c,          ptable,      pmask,
           pids,  k,           use_packed, skip_packed, nullptr, dx,
           dtau,  static_cast<float*>(workspace)};
  return dispatch<true>(p, is_bf16, slots, static_cast<cudaStream_t>(stream));
}

// Bytes of the backward's workspace at (d, n): 0 while the d_emb tile fits
// in shared memory.
extern "C" long long rc_pixel_text_ce_workspace(int d, long long n) {
  return (long long)workspace_bytes(d, n);
}

// The tensor-core kernels of the bf16 packed branch.  x: [n, d] bf16,
// un-normalised, 16-byte aligned, d % 8 == 0, d <= 1280; ptable [k, d] bf16
// normalised, pmask [k] int32, pids [k] int32 global ids; labels, valid,
// temperature, coeff as above.  They run only where *use_packed != 0
// (always when it is NULL), so they pair with the CUDA-core kernels called
// with skip_packed = 1: one of the two writes.
extern "C" int rc_pixel_text_ce_tc_fwd(
    const void* x, const float* temperature, const int* labels,
    const float* valid, int slots, long long n, int d, const void* ptable,
    const int* pmask, const int* pids, int k, const int* use_packed,
    float* ce, void* stream) {
  const TcParams p{static_cast<const __nv_bfloat16*>(x), temperature,
                   nullptr, labels, valid, n, d, pmask, pids, k, use_packed,
                   ce, nullptr, nullptr};
  if (!tc_shape_ok(p, slots)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 1: return launch_tc_fwd<1>(p, ptable, st);
    case 2: return launch_tc_fwd<2>(p, ptable, st);
    case 3: return launch_tc_fwd<3>(p, ptable, st);
    default: return launch_tc_fwd<4>(p, ptable, st);
  }
}

// ptable_t: the packed table transposed, [d, k8] bf16 with k8 = k rounded
// up to a multiple of 8 (zero columns past k), 16-byte aligned; k <= 128.
// dx: [n, d] bf16; dtau: [n] f32.
extern "C" int rc_pixel_text_ce_tc_bwd(
    const void* x, const float* temperature, const float* coeff,
    const int* labels, const float* valid, int slots, long long n, int d,
    const void* ptable, const void* ptable_t, const int* pmask,
    const int* pids, int k, const int* use_packed, void* dx, float* dtau,
    void* stream) {
  const TcParams p{static_cast<const __nv_bfloat16*>(x), temperature, coeff,
                   labels, valid, n, d, pmask, pids, k, use_packed, nullptr,
                   static_cast<__nv_bfloat16*>(dx), dtau};
  if (!tc_shape_ok(p, slots) || k > kMaxTcBwdClasses)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 1: return launch_tc_bwd<1>(p, ptable, ptable_t, st);
    case 2: return launch_tc_bwd<2>(p, ptable, ptable_t, st);
    case 3: return launch_tc_bwd<3>(p, ptable, ptable_t, st);
    default: return launch_tc_bwd<4>(p, ptable, ptable_t, st);
  }
}
