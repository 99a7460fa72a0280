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
// Bound on the card: arithmetic on CUDA cores.  The forward does 2 N K D
// FLOP (68.7 GFLOP packed at N = 524,288, K = 128, D = 512) against
// N (D * sizeof(T) + 8 S + 4) bytes; the backward does the product twice
// (logits, then delta x table) for one class tile and three times for
// several (pass 1 for the row statistics, pass 2 recomputes each tile).
// The [N, C] logits never touch device memory.
//
// Design (CUDA-core FMA, no tensor cores yet): a block of 256 threads owns
// 64 pixel rows and walks the table in tiles of 128 classes.
//   1. Scale: each warp sums x^2 of 8 rows in f64.
//   2. Logits: a 64 x 128 register-tiled product over D in chunks of 16
//      dims, double-buffered in shared memory; staging rounds x * rs to T.
//      Each thread holds 4 x 8 sums.  The tile lands class-major in shared
//      memory with the mask and 1/tau applied.
//   3. Row statistics: four threads per row scan the tile (pitch 72 floats:
//      conflict-free), with an online max / sum-exp across tiles (one tile:
//      the plain formula exactly) and the slot picks.
//   4. Backward only: per tile, delta into the same shared tile, then
//      d_emb [64, D] += delta_tile [64, 128] x table_tile [128, D] in
//      shared memory; last, one warp per row applies the normalisation VJP.
// The TPU kernel's class-major [C, TILE_N] layout and row-tile search are
// TPU work; here rows are the block's axis.  Any N, C, K; D % 8 == 0 and
// D <= 640 (shared memory); S <= 4.

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
  float* ce;              // forward: [n] per-row CE
  void* dx;               // backward: [n, d] in x's dtype
  float* dtau;            // backward: [n] per-row d log tau
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

template <typename T, int S, bool kBackward>
__global__ void __launch_bounds__(kThreads, kBackward ? 1 : 2)
    ce_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  float* de = reinterpret_cast<float*>(smem_raw + sizeof(Smem));
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
  const long long row0 = (long long)blockIdx.x * kRows;

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

size_t smem_bytes(bool backward, int d) {
  return sizeof(Smem) +
         (backward ? (size_t)kRows * (d + 4) * sizeof(float) : 0);
}

template <typename T, int S, bool kBackward>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(kBackward, p.d);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ce_kernel<T, S, kBackward>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.n + kRows - 1) / kRows));
  ce_kernel<T, S, kBackward><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kBackward>
cudaError_t dispatch(const Params& p, int is_bf16, int slots,
                     cudaStream_t st) {
  if (p.d % 8 != 0 || p.d <= 0 || p.c <= 0 || p.n <= 0 ||
      (p.use_packed != nullptr && p.k <= 0))
    return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  switch (slots * 2 + (is_bf16 ? 1 : 0)) {
    case 2: return launch<float, 1, kBackward>(p, st);
    case 3: return launch<bf, 1, kBackward>(p, st);
    case 4: return launch<float, 2, kBackward>(p, st);
    case 5: return launch<bf, 2, kBackward>(p, st);
    case 6: return launch<float, 3, kBackward>(p, st);
    case 7: return launch<bf, 3, kBackward>(p, st);
    case 8: return launch<float, 4, kBackward>(p, st);
    case 9: return launch<bf, 4, kBackward>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: [n, d] f32 (is_bf16 == 0) or bf16, un-normalised, 16-byte aligned;
// temperature: [1] f32; labels: [slots, n] int32; valid: [slots, n] f32;
// table: [c, d] normalised, in x's dtype; mask: [c] int32.  The packed
// members (ptable [k, d], pmask [k], pids [k]) and the device flag
// use_packed may be NULL (full table only).  ce: [n] f32.  1 <= slots <= 4.
extern "C" int rc_pixel_text_ce_fwd(
    const void* x, int is_bf16, const float* temperature, const int* labels,
    const float* valid, int slots, long long n, int d, const void* table,
    const int* mask, int c, const void* ptable, const int* pmask,
    const int* pids, int k, const int* use_packed, float* ce, void* stream) {
  Params p{x, temperature, nullptr, labels, valid, n, d, table, mask, c,
           ptable, pmask, pids, k, use_packed, ce, nullptr, nullptr};
  return dispatch<false>(p, is_bf16, slots, static_cast<cudaStream_t>(stream));
}

// As the forward, plus coeff: [1] f32, the upstream gradient of the summed
// CE; dx: [n, d] in x's dtype; dtau: [n] f32 per-row d log tau.
extern "C" int rc_pixel_text_ce_bwd(
    const void* x, int is_bf16, const float* temperature, const float* coeff,
    const int* labels, const float* valid, int slots, long long n, int d,
    const void* table, const int* mask, int c, const void* ptable,
    const int* pmask, const int* pids, int k, const int* use_packed, void* dx,
    float* dtau, void* stream) {
  Params p{x, temperature, coeff, labels, valid, n, d, table, mask, c,
           ptable, pmask, pids, k, use_packed, nullptr, dx, dtau};
  return dispatch<true>(p, is_bf16, slots, static_cast<cudaStream_t>(stream));
}
