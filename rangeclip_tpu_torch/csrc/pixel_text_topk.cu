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
// Bound on the card: arithmetic.  Each pixel costs C * D multiply-adds
// (C=384, D=512: 196,608) against D * sizeof(T) bytes of field read (once
// for the scale, once per class tile) and k * 4 bytes written; the [N, C]
// score field never touches device memory.
//
// Design (CUDA-core FMA, no tensor cores yet): a block of 256 threads owns
// 128 pixel rows and walks the table in tiles of 128 classes.
//   1. Scale: each warp sums x^2 of 16 rows (f64, warp-reduced) into
//      rs[row], so the pixel tile never has to sit whole in shared memory.
//   2. Scores: a 128 x 128 register-tiled product over D in chunks of 16
//      dims, double-buffered in shared memory with the next chunk prefetched
//      into registers.  Staging rounds x * rs[row] to the field's dtype (the
//      TPU kernel's rounding point) and widens both operands to f32,
//      dim-major.  Each thread holds an 8 x 8 tile of sums (pixels ty*4+i
//      and 64+ty*4+i, classes tx*4+j and 64+tx*4+j): per dim, four 16-byte
//      shared loads feed 64 FMAs.
//   3. Selection: the tile's sums go to shared memory; two threads per pixel
//      (even and odd classes) insert them into register top-k lists in the
//      knockout order (common.cuh).  After the last tile the two lists merge
//      through a shuffle.
// The TPU kernel's [H, W, B, D] transpose, class-major score tile and
// row-tile search have no purpose here.  Any N, any C >= k, D % 8 == 0.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 128;         // pixel rows per block
constexpr int kClasses = 128;        // classes per tile
constexpr int kDimChunk = 16;        // dims staged per step: two groups of 8
constexpr int kPitch = kPixels + 4;  // 16-byte rows; kPixels == kClasses
constexpr int kScorePitch = kClasses + 2;  // conflict-free selection reads

struct Smem {
  float a[2][kDimChunk][kPitch];  // normalised pixels, dim-major
  float b[2][kDimChunk][kPitch];  // table rows, dim-major
  float s[kPixels][kScorePitch];  // one class tile's sums
  float rs[kPixels];              // per-row scale
  int ids[kClasses];              // output id per class of the tile
};

// Eight dims (group g of chunk d0) of row r, or zeros past the end.
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

template <int K, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    pixel_text_topk_kernel(const T* __restrict__ field,
                           const T* __restrict__ table,
                           const int* __restrict__ ids, long long n, int d,
                           int c, int* __restrict__ idx,
                           float* __restrict__ vals) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * kPixels;

  // 1. rs[r] = 1/sqrt(max(sum x^2, 1e-24)) (pixel_text_topk.py:85-87)
  constexpr int kRowsPerWarp = kPixels / (kThreads / 32);
  const int warp_row0 = (tid >> 5) * kRowsPerWarp;
  for (int r = warp_row0; r < warp_row0 + kRowsPerWarp; ++r) {
    double sq = 0.0;
    if (row0 + r < n) {
      for (int g = lane * 8; g < d; g += 256) {
        T v[8];
        rc::load8(field + (row0 + r) * d + g, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const double x = rc::to_float(v[i]);
          sq = fma(x, x, sq);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (lane == 0) sm.rs[r] = (float)(1.0 / sqrt(fmax(sq, 1e-24)));
  }

  // staging roles: row (pixel or class) tid / 2, dims group tid % 2
  const int st_row = tid >> 1;
  const int st_dim = (tid & 1) * 8;
  // product roles: 8 x 8 sums per thread
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // selection roles: pixel tid / 2, classes of parity tid % 2
  const int sel_row = tid >> 1;
  const int parity = tid & 1;

  float v[K];
  int id[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = -CUDART_INF_F;
    id[i] = INT_MAX;
  }
  const int chunks = (d + kDimChunk - 1) / kDimChunk;

  for (int c0 = 0; c0 < c; c0 += kClasses) {
    if (tid < kClasses) sm.ids[tid] = c0 + tid < c ? ids[c0 + tid] : -1;
    __syncthreads();  // rs is written (first tile)

    const float scale = sm.rs[st_row];
    T pv[8], tv[8];
    auto stage = [&](int buf) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const T x = rc::round_to(rc::to_float(pv[i]) * scale, T());
        sm.a[buf][st_dim + i][st_row] = rc::to_float(x);
        sm.b[buf][st_dim + i][st_row] = rc::to_float(tv[i]);
      }
    };
    auto fetch = [&](int chunk) {
      const int dim = chunk * kDimChunk + st_dim;
      load_group(field + row0 * d, n - row0, d, st_row, dim, pv);
      load_group(table + (long long)c0 * d, (long long)(c - c0), d, st_row,
                 dim, tv);
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    fetch(0);
    stage(0);
    __syncthreads();
    for (int chunk = 0; chunk < chunks; ++chunk) {
      const int buf = chunk & 1;
      if (chunk + 1 < chunks) fetch(chunk + 1);
#pragma unroll
      for (int k = 0; k < kDimChunk; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[buf][k][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sm.a[buf][k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[buf][k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&sm.b[buf][k][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      // the other buffer was last read before the previous barrier
      if (chunk + 1 < chunks) stage(buf ^ 1);
      __syncthreads();
    }

    // 3. the tile's sums to shared memory, then into the top-k lists
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int cl = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
        *reinterpret_cast<float2*>(&sm.s[p][cl]) =
            make_float2(acc[i][j], acc[i][j + 1]);
      }
    }
    __syncthreads();
    const int cn = min(kClasses, c - c0);
    for (int cl = parity; cl < cn; cl += 2) {
      const int cid = sm.ids[cl];
      const float sv = cid >= 0 ? sm.s[sel_row][cl] : rc::kNegInf;
      if (rc::better(sv, cid, v[K - 1], id[K - 1])) rc::insert_pair(v, id, sv, cid);
    }
    __syncthreads();  // s and ids are consumed
  }

  // merge the even- and odd-class lists of each pixel (adjacent lanes)
  float ov[K];
  int oid[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    ov[t] = __shfl_xor_sync(0xffffffffu, v[t], 1);
    oid[t] = __shfl_xor_sync(0xffffffffu, id[t], 1);
  }
#pragma unroll
  for (int t = 0; t < K; ++t) rc::insert_pair(v, id, ov[t], oid[t]);

  const long long row = row0 + sel_row;
  if (parity != 0 || row >= n) return;
  bool dead_won = false;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    dead_won = dead_won || id[t] == -1;
    idx[row * K + t] = (dead_won || v[t] <= -1e29f) ? -1 : id[t];
    if (vals != nullptr) vals[row * K + t] = dead_won ? rc::kNegInf : v[t];
  }
}

template <int K, typename T>
cudaError_t launch(const T* field, const T* table, const int* ids,
                   long long n, int d, int c, int* idx, float* vals,
                   cudaStream_t stream) {
  const size_t smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      pixel_text_topk_kernel<K, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + kPixels - 1) / kPixels));
  pixel_text_topk_kernel<K, T><<<grid, kThreads, smem, stream>>>(
      field, table, ids, n, d, c, idx, vals);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* field, const void* table, const int* ids,
                     long long n, int d, int c, int k, int* idx, float* vals,
                     cudaStream_t st) {
  const T* f = static_cast<const T*>(field);
  const T* t = static_cast<const T*>(table);
  switch (k) {
    case 1: return launch<1, T>(f, t, ids, n, d, c, idx, vals, st);
    case 2: return launch<2, T>(f, t, ids, n, d, c, idx, vals, st);
    case 3: return launch<3, T>(f, t, ids, n, d, c, idx, vals, st);
    case 4: return launch<4, T>(f, t, ids, n, d, c, idx, vals, st);
    case 5: return launch<5, T>(f, t, ids, n, d, c, idx, vals, st);
    case 6: return launch<6, T>(f, t, ids, n, d, c, idx, vals, st);
    case 7: return launch<7, T>(f, t, ids, n, d, c, idx, vals, st);
    case 8: return launch<8, T>(f, t, ids, n, d, c, idx, vals, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// field: [n, d] f32 (is_bf16 == 0) or bf16, un-normalised; table: [c, d] of
// the same dtype, L2-normalised; both 16-byte aligned, d % 8 == 0.  ids: [c]
// int32 output id per table row, -1 for rows that may not win.  idx: [n, k]
// int32; vals: [n, k] f32 or NULL.  1 <= k <= 8, k <= c, n >= 1.
extern "C" int rc_pixel_text_topk(const void* field, int is_bf16,
                                  const void* table, const int* ids,
                                  long long n, int d, int c, int k, int* idx,
                                  float* vals, void* stream) {
  if (d % 8 != 0 || d <= 0 || c < k) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(field, table, ids, n, d, c, k,
                                           idx, vals, st)
                 : dispatch<float>(field, table, ids, n, d, c, k, idx, vals,
                                   st);
}
