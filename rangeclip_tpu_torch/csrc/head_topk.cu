// The whole segmentation head in one kernel: 3x3 SAME conv of the pre-head
// features to the embedding field, per-pixel L2 normalisation, scoring
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
// (id 0, -1e30); this kernel never inserts a masked class and fills the
// picks left empty with exactly that.
//
// Bound on the card: operations.  A pixel costs 9 * C_in * D MACs of conv
// and D * C of scoring (C_in = 32, D = C = 512: 409,600), against 2 * C_in
// bytes of features read and k * 8 bytes written; the [B, h, w, D] field
// and the [N, C] scores never touch device memory.
//
// Design (CUDA-core f32 FMA, as csrc/pixel_text_topk.cu; tensor cores
// later): a block of 256 threads owns 64 consecutive pixels.
//   1. Conv, for each 128-dim chunk of D: a 64 x 128 register-tiled product
//      (4 pixels x 8 dims per thread) over the 9 * C_in taps in chunks of
//      16, both operands double-buffered in shared memory with the next
//      chunk prefetched into registers; the im2col operand is gathered from
//      the features (zeros outside the image) as it is staged.  The f32
//      results go to the embedding tile emb[D][64] in shared memory (139 KB
//      at D = 512).
//   2. Each warp sums f^2 of 8 pixels; the tile is scaled and rounded to
//      the features' dtype in place.
//   3. Scores, per tile of 128 classes: the same product with emb resident
//      and the table streamed in 16-dim chunks; the sums go to shared
//      memory and four threads per pixel insert the live classes into
//      register top-k lists, merged by shuffles after the last tile.
// One block per SM (186 KB of shared memory at D = 512).  Any number of
// pixels and classes; C_in % 8 == 0, D % 8 == 0, D <= 656, 1 <= k <= 8.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 64;               // pixels per block
constexpr int kCols = 128;             // dims (conv) or classes (scores) per tile
constexpr int kChunk = 16;             // reduction depth staged per step
constexpr int kEPitch = kPix + 4;      // emb rows [dim][pixel]
constexpr int kBPitch = kCols + 4;     // staged operand rows [k][col]
constexpr int kSPitch = kCols + 2;     // score rows [pixel][class]

struct ConvBufs {
  float a[2][kChunk][kEPitch];  // im2col taps x pixels
  float b[2][kChunk][kBPitch];  // taps x dims
};
struct ScoreBufs {
  float b[2][kChunk][kBPitch];  // dims x classes
  float s[kPix][kSPitch];       // one class tile's sums
};
union Work {
  ConvBufs conv;
  ScoreBufs score;
};
constexpr size_t kFixedSmem = sizeof(Work) + kPix * sizeof(float) +
                              kCols * sizeof(int);

size_t smem_bytes(int d) {
  const int dpad = (d + kChunk - 1) / kChunk * kChunk;
  return kFixedSmem + (size_t)dpad * kEPitch * sizeof(float);
}

// acc[i][j] += sum_k a[k][ty*4 + i] * b[k][col(j)] over one staged chunk,
// with col(j) = tx*4 + j for j < 4 and 64 + tx*4 + (j - 4) after.
__device__ __forceinline__ void chunk_product(const float* a, int a_pitch,
                                              const float (*b)[kBPitch],
                                              int ty, int tx,
                                              float (&acc)[4][8]) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * a_pitch + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(&b[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[k][64 + tx * 4]);
    const float x[4] = {av.x, av.y, av.z, av.w};
    const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

__device__ __forceinline__ int col_of(int j, int tx) {
  return (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
}

template <int K, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    head_topk_kernel(const T* __restrict__ feats, const T* __restrict__ wrows,
                     const T* __restrict__ table,
                     const int* __restrict__ mask, int batch, int h, int w,
                     int c_in, int d, int c, int* __restrict__ idx,
                     float* __restrict__ vals) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Work& wk = *reinterpret_cast<Work*>(smem_raw);
  float* rs = reinterpret_cast<float*>(smem_raw + sizeof(Work));
  int* live = reinterpret_cast<int*>(rs + kPix);
  float* emb = reinterpret_cast<float*>(live + kCols);  // [dpad][kEPitch]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long n_pix = (long long)batch * h * w;
  const long long p0 = (long long)blockIdx.x * kPix;
  const int taps = 9 * c_in;
  const int dpad = (d + kChunk - 1) / kChunk * kChunk;

  // the dims in [d, dpad) stay zero: the score product reads them
  for (int e = d * kEPitch + tid; e < dpad * kEPitch; e += kThreads)
    emb[e] = 0.f;

  // --- 1. conv ----------------------------------------------------------
  // staging roles: im2col pixel a_px, taps a_k..a_k+3 (one tap, 4
  // channels, since c_in % 4 == 0); weight row b_k, dims b_d..b_d+7
  const int a_px = tid & (kPix - 1);
  const int a_k = (tid >> 6) * 4;
  const long long ap = p0 + a_px;
  const bool a_in = ap < n_pix;
  int ax = 0, ay = 0, ab = 0;
  if (a_in) {
    ax = (int)(ap % w);
    const long long r = ap / w;
    ay = (int)(r % h);
    ab = (int)(r / h);
  }
  const int b_k = tid >> 4;
  const int b_d = (tid & 15) * 8;
  const int conv_chunks = (taps + kChunk - 1) / kChunk;

  for (int dc0 = 0; dc0 < d; dc0 += kCols) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float av[4];
    T bv[8];
    auto fetch = [&](int chunk) {
      const int k = chunk * kChunk + a_k;
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = 0.f;
      if (a_in && k < taps) {
        const int tap = k / c_in;
        const int ch = k - tap * c_in;
        const int yy = ay + tap / 3 - 1;
        const int xx = ax + tap % 3 - 1;
        if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
          const T* src =
              feats + (((long long)ab * h + yy) * w + xx) * c_in + ch;
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = rc::to_float(src[i]);
        }
      }
      const int kb = chunk * kChunk + b_k;
      const int dd = dc0 + b_d;
      if (kb < taps && dd < d) {
        rc::load8(wrows + (long long)kb * d + dd, bv);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) bv[i] = rc::round_to(0.f, T());
      }
    };
    auto stage = [&](int buf) {
#pragma unroll
      for (int i = 0; i < 4; ++i) wk.conv.a[buf][a_k + i][a_px] = av[i];
      float4* dst = reinterpret_cast<float4*>(&wk.conv.b[buf][b_k][b_d]);
      dst[0] = make_float4(rc::to_float(bv[0]), rc::to_float(bv[1]),
                           rc::to_float(bv[2]), rc::to_float(bv[3]));
      dst[1] = make_float4(rc::to_float(bv[4]), rc::to_float(bv[5]),
                           rc::to_float(bv[6]), rc::to_float(bv[7]));
    };
    fetch(0);
    stage(0);
    __syncthreads();
    for (int chunk = 0; chunk < conv_chunks; ++chunk) {
      const int buf = chunk & 1;
      if (chunk + 1 < conv_chunks) fetch(chunk + 1);
      chunk_product(&wk.conv.a[buf][0][0], kEPitch, wk.conv.b[buf], ty, tx,
                    acc);
      // the other buffer was last read before the previous barrier
      if (chunk + 1 < conv_chunks) stage(buf ^ 1);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int dim = dc0 + col_of(j, tx);
      if (dim < d) {
        *reinterpret_cast<float4*>(&emb[dim * kEPitch + ty * 4]) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      }
    }
  }
  __syncthreads();

  // --- 2. normalise: rs = 1 / sqrt(max(sum f^2, 1e-24)), round to T ------
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int px = warp * (kPix / 8); px < (warp + 1) * (kPix / 8); ++px) {
    float sq = 0.f;
    for (int dim = lane; dim < d; dim += 32) {
      const float f = emb[dim * kEPitch + px];
      sq = fmaf(f, f, sq);
    }
    sq = rc::warp_sum(sq);
    if (lane == 0) rs[px] = 1.f / sqrtf(fmaxf(sq, 1e-24f));
  }
  __syncthreads();
  for (int e = tid; e < d * kPix; e += kThreads) {
    const int dim = e / kPix;
    const int px = e % kPix;
    float* f = &emb[dim * kEPitch + px];
    *f = rc::to_float(rc::round_to(__fmul_rn(*f, rs[px]), T()));
  }

  // --- 3. scores and top-k ----------------------------------------------
  const int st_cls = tid >> 1;       // staging: class, dims st_dim..+7
  const int st_dim = (tid & 1) * 8;
  const int sel_px = tid >> 2;       // selection: pixel, classes = res mod 4
  const int res = tid & 3;
  const int score_chunks = dpad / kChunk;
  float v[K];
  int id[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = -CUDART_INF_F;
    id[i] = INT_MAX;
  }

  for (int c0 = 0; c0 < c; c0 += kCols) {
    if (tid < kCols) live[tid] = c0 + tid < c && mask[c0 + tid] != 0;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    T tv[8];
    auto fetch = [&](int chunk) {
      const int dim = chunk * kChunk + st_dim;
      if (c0 + st_cls < c && dim < d) {
        rc::load8(table + (long long)(c0 + st_cls) * d + dim, tv);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) tv[i] = rc::round_to(0.f, T());
      }
    };
    auto stage = [&](int buf) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        wk.score.b[buf][st_dim + i][st_cls] = rc::to_float(tv[i]);
    };
    fetch(0);
    stage(0);
    __syncthreads();  // emb normalised (first tile), live and b written
    for (int chunk = 0; chunk < score_chunks; ++chunk) {
      const int buf = chunk & 1;
      if (chunk + 1 < score_chunks) fetch(chunk + 1);
      chunk_product(emb + chunk * kChunk * kEPitch, kEPitch,
                    wk.score.b[buf], ty, tx, acc);
      if (chunk + 1 < score_chunks) stage(buf ^ 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        *reinterpret_cast<float2*>(&wk.score.s[ty * 4 + i][col_of(j, tx)]) =
            make_float2(acc[i][j], acc[i][j + 1]);
      }
    }
    __syncthreads();
    const int cn = min(kCols, c - c0);
    for (int cl = res; cl < cn; cl += 4) {
      if (live[cl]) {
        const float sv = wk.score.s[sel_px][cl];
        const int cid = c0 + cl;
        if (rc::better(sv, cid, v[K - 1], id[K - 1]))
          rc::insert_pair(v, id, sv, cid);
      }
    }
    __syncthreads();  // s and live are consumed
  }

  // merge the four class-residue lists of each pixel (adjacent lanes)
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    float ov[K];
    int oid[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      ov[t] = __shfl_xor_sync(0xffffffffu, v[t], off);
      oid[t] = __shfl_xor_sync(0xffffffffu, id[t], off);
    }
#pragma unroll
    for (int t = 0; t < K; ++t) rc::insert_pair(v, id, ov[t], oid[t]);
  }

  const long long p = p0 + sel_px;
  if (res != 0 || p >= n_pix) return;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const bool empty = id[t] == INT_MAX;  // the live classes ran out
    idx[p * K + t] = empty ? 0 : id[t];
    vals[p * K + t] = empty ? rc::kNegInf : v[t];
  }
}

template <int K, typename T>
cudaError_t launch(const void* feats, const void* wrows, const void* table,
                   const int* mask, int batch, int h, int w, int c_in, int d,
                   int c, int* idx, float* vals, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      head_topk_kernel<K, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_pix = (long long)batch * h * w;
  const dim3 grid((unsigned)((n_pix + kPix - 1) / kPix));
  head_topk_kernel<K, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(wrows),
      static_cast<const T*>(table), mask, batch, h, w, c_in, d, c, idx, vals);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* feats, const void* wrows, const void* table,
                     const int* mask, int batch, int h, int w, int c_in,
                     int d, int c, int k, int* idx, float* vals,
                     cudaStream_t st) {
  switch (k) {
#define RC_HEAD_CASE(KK)                                                    \
  case KK:                                                                  \
    return launch<KK, T>(feats, wrows, table, mask, batch, h, w, c_in, d, \
                         c, idx, vals, st);
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

}  // namespace

// feats: [batch, h, w, c_in] f32 (is_bf16 == 0) or bf16, c_in % 8 == 0;
// wrows: [9 * c_in, d] of the same dtype, rows ordered (dy, dx, c_in), 16-byte
// aligned, d % 8 == 0; table: [c, d] of the same dtype, L2-normalised,
// 16-byte aligned; mask: [c] int32 (non-zero = candidate).  idx: [batch*h*w,
// k] int32 and vals: [batch*h*w, k] f32, pixels in (b, y, x) order.
// 1 <= k <= 8, c >= 1, batch * h * w >= 1.
extern "C" int rc_head_topk(const void* feats, int is_bf16, const void* wrows,
                            const void* table, const int* mask, int batch,
                            int h, int w, int c_in, int d, int c, int k,
                            int* idx, float* vals, void* stream) {
  if (c_in % 8 != 0 || c_in < 8 || d % 8 != 0 || d < 8 || c < 1 ||
      (long long)batch * h * w < 1 || smem_bytes(d) > 232448)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(feats, wrows, table, mask, batch, h,
                                           w, c_in, d, c, k, idx, vals, st)
                 : dispatch<float>(feats, wrows, table, mask, batch, h, w,
                                   c_in, d, c, k, idx, vals, st);
}
