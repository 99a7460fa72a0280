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
// (id 0, -1e30); these kernels never insert a masked class and fill the
// picks left empty with exactly that.
//
// Bound on the card: operations.  A pixel costs 9 * C_in * D MACs of conv
// and D for each class that can win (C_in = 32, D = 512, 340 live of C =
// 512: 147,456 + 174,080), against 2 * C_in bytes of features read and k *
// 8 bytes written; the [B, h, w, D] field and the [N, C] scores never touch
// device memory.
//
// Two kernels, chosen by the features' dtype and widths (the wrapper names
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

// f32, and bf16 beyond those widths: CUDA-core f32 FMA, head_topk_kernel.
// The tensor cores take f32 only as TF32, which would break the fp32
// contract; bf16 wider than the tensor-core kernel's registers and shared
// memory hold.  A block of 256 threads owns 64 consecutive pixels.
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
// One block per SM (186 KB of shared memory at D = 512).  Beyond D = 656
// the embedding tile does not fit in shared memory: it lives in a device
// workspace, one slice per block, with the same indexing, and a grid of at
// most one block per SM strides over the pixel tiles (28 MB at D = 768).
// Any number of pixels and classes; C_in % 8 == 0, D % 8 == 0 (the wrapper
// zero-pads other widths), 1 <= k <= 8.

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

// Floats of one embedding tile [dpad][kEPitch].
__host__ __device__ size_t emb_floats(int d) {
  return (size_t)((d + kChunk - 1) / kChunk * kChunk) * kEPitch;
}

size_t smem_bytes(int d) { return kFixedSmem + emb_floats(d) * sizeof(float); }

constexpr size_t kMaxSmem = 232448;

// The tile sits in shared memory while it fits there (d <= 656); beyond,
// in the workspace, with at most one block per SM.
bool emb_in_smem(int d) { return smem_bytes(d) <= kMaxSmem; }

long long tiles_of(long long n_pix) { return (n_pix + kPix - 1) / kPix; }

long long grid_blocks(int d, long long n_pix) {
  return emb_in_smem(d) ? tiles_of(n_pix)
                        : std::min<long long>(tiles_of(n_pix),
                                              rc::sm_count());
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

// kWorkspace: the embedding tile lives in `workspace`, one slice of
// emb_floats(d) per block, and the grid (bounded by the SMs) strides over
// the pixel tiles; otherwise it is in shared memory, a block per tile.
template <int K, typename T, bool kWorkspace>
__global__ void __launch_bounds__(kThreads, 1)
    head_topk_kernel(const T* __restrict__ feats, const T* __restrict__ wrows,
                     const T* __restrict__ table,
                     const int* __restrict__ mask, int batch, int h, int w,
                     int c_in, int d, int c, int* __restrict__ idx,
                     float* __restrict__ vals, float* __restrict__ workspace) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Work& wk = *reinterpret_cast<Work*>(smem_raw);
  float* rs = reinterpret_cast<float*>(smem_raw + sizeof(Work));
  int* live = reinterpret_cast<int*>(rs + kPix);
  float* emb = kWorkspace  // [dpad][kEPitch]
                   ? workspace + (size_t)blockIdx.x * emb_floats(d)
                   : reinterpret_cast<float*>(live + kCols);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long n_pix = (long long)batch * h * w;
  const int taps = 9 * c_in;
  const int dpad = (d + kChunk - 1) / kChunk * kChunk;

  // the dims in [d, dpad) stay zero: the score product reads them
  for (int e = d * kEPitch + tid; e < dpad * kEPitch; e += kThreads)
    emb[e] = 0.f;

  for (long long p0 = (long long)blockIdx.x * kPix; p0 < n_pix;
       p0 += (long long)gridDim.x * kPix) {

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
    if (res == 0 && p < n_pix) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const bool empty = id[t] == INT_MAX;  // the live classes ran out
        idx[p * K + t] = empty ? 0 : id[t];
        vals[p * K + t] = empty ? rc::kNegInf : v[t];
      }
    }
    __syncthreads();  // emb, rs and live are free for the next tile
  }
}

template <int K, typename T, bool kWorkspace>
cudaError_t launch_as(const void* feats, const void* wrows, const void* table,
                      const int* mask, int batch, int h, int w, int c_in,
                      int d, int c, int* idx, float* vals, float* workspace,
                      cudaStream_t stream) {
  const size_t smem = kWorkspace ? kFixedSmem : smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      head_topk_kernel<K, T, kWorkspace>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)grid_blocks(d, (long long)batch * h * w));
  head_topk_kernel<K, T, kWorkspace><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(wrows),
      static_cast<const T*>(table), mask, batch, h, w, c_in, d, c, idx, vals,
      workspace);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t launch(const void* feats, const void* wrows, const void* table,
                   const int* mask, int batch, int h, int w, int c_in, int d,
                   int c, int* idx, float* vals, float* workspace,
                   cudaStream_t stream) {
  if (emb_in_smem(d))
    return launch_as<K, T, false>(feats, wrows, table, mask, batch, h, w,
                                  c_in, d, c, idx, vals, nullptr, stream);
  if (workspace == nullptr) return cudaErrorInvalidValue;
  return launch_as<K, T, true>(feats, wrows, table, mask, batch, h, w, c_in,
                               d, c, idx, vals, workspace, stream);
}

template <typename T>
cudaError_t dispatch(const void* feats, const void* wrows, const void* table,
                     const int* mask, int batch, int h, int w, int c_in,
                     int d, int c, int k, int* idx, float* vals,
                     float* workspace, cudaStream_t st) {
  switch (k) {
#define RC_HEAD_CASE(KK)                                                    \
  case KK:                                                                  \
    return launch<KK, T>(feats, wrows, table, mask, batch, h, w, c_in, d, \
                         c, idx, vals, workspace, st);
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

// The CUDA-core kernel.  feats: [batch, h, w, c_in] f32 (is_bf16 == 0) or
// bf16, c_in % 8 == 0; wrows: [9 * c_in, d] of the same dtype, rows ordered
// (dy, dx, c_in), 16-byte aligned, d % 8 == 0; table: [c, d] of the same
// dtype, L2-normalised, 16-byte aligned; mask: [c] int32 (non-zero = candidate).  idx: [batch*h*w,
// k] int32 and vals: [batch*h*w, k] f32, pixels in (b, y, x) order.
// 1 <= k <= 8, c >= 1, batch * h * w >= 1.  workspace:
// rc_head_topk_workspace(d, batch * h * w) bytes, 16-byte aligned (NULL
// when that is 0).
extern "C" int rc_head_topk(const void* feats, int is_bf16, const void* wrows,
                            const void* table, const int* mask, int batch,
                            int h, int w, int c_in, int d, int c, int k,
                            int* idx, float* vals, void* workspace,
                            void* stream) {
  if (c_in % 8 != 0 || c_in < 8 || d % 8 != 0 || d < 8 || c < 1 ||
      (long long)batch * h * w < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  return is_bf16 ? dispatch<__nv_bfloat16>(feats, wrows, table, mask, batch, h,
                                           w, c_in, d, c, k, idx, vals, ws, st)
                 : dispatch<float>(feats, wrows, table, mask, batch, h, w,
                                   c_in, d, c, k, idx, vals, ws, st);
}

// Bytes of the workspace at width d over n_pix pixels: 0 while the
// embedding tile fits in shared memory.
extern "C" long long rc_head_topk_workspace(int d, long long n_pix) {
  return emb_in_smem(d) ? 0
                        : (long long)(grid_blocks(d, n_pix) * emb_floats(d) *
                                      sizeof(float));
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
