// The band of a [B, H, W, D] field and its shared-memory ring of row slabs:
// the layout of the neighbour-difference stencils of tv_rowtile.cu and
// tv_loss.cu, and the one-block kernel that turns their per-block partial
// sums into the TV value.
//
// A block owns a band of 32 image rows x 32 pixel columns x 8 16-byte
// pieces a pixel (64 bf16 or 32 f32 channels) and streams its rows down the
// image through a ring of six row slabs (cp.async, 16-byte pieces), so every
// byte of the field crosses device memory once, plus its halo.  One thread
// owns one column x one piece.  The grid is one-dimensional (W-tiles
// fastest, then channel chunks, bands and images), so any B * H runs.  A
// ring is about 26 KB in either type: four blocks an SM.  Requires D % 8 ==
// 0 and 16-byte aligned rows.

#pragma once

#include "common.cuh"

namespace rc {
namespace band {

constexpr int kThreads = 256;
constexpr int kPixels = 32;  // pixel columns per block (W-tile)
constexpr int kGroups = 8;   // 16-byte pieces per pixel and block
constexpr int kBand = 32;    // image rows per block
constexpr int kSlabs = 6;    // ring slots
constexpr int kBlocks = 4;   // resident blocks per SM (64 registers)
constexpr int kSumThreads = 1024;

// Channels in a 16-byte piece: 8 bf16 or 4 f32.
template <typename T>
constexpr int kPer = 16 / sizeof(T);

struct Band {
  int b, h0, h1, w0, g0;  // image, rows [h0, h1), first column and piece
};

// One 32-bit division chain per block: W-tiles fastest, then channel
// chunks, bands and images.
template <typename T>
__device__ __forceinline__ Band band_of(int H, int W, int D) {
  const unsigned wtiles = (W + kPixels - 1) / kPixels;
  const unsigned chunks = (D / kPer<T> + kGroups - 1) / kGroups;
  const unsigned bands = (H + kBand - 1) / kBand;
  unsigned i = blockIdx.x;
  Band t;
  t.w0 = (int)(i % wtiles) * kPixels;
  i /= wtiles;
  t.g0 = (int)(i % chunks) * kGroups;
  i /= chunks;
  t.h0 = (int)(i % bands) * kBand;
  t.b = (int)(i / bands);
  t.h1 = min(t.h0 + kBand, H);
  return t;
}

template <typename T>
inline long long band_blocks(int B, int H, int W, int D) {
  return (long long)B * ((H + kBand - 1) / kBand) *
         ((D / kPer<T> + kGroups - 1) / kGroups) *
         ((W + kPixels - 1) / kPixels);
}

template <typename T>
inline bool valid_shape(int B, int H, int W, int D) {
  return B >= 1 && H >= 1 && W >= 1 && D >= 8 && D % 8 == 0 &&
         band_blocks<T>(B, H, W, D) < (1ll << 31);
}

// One 16-byte piece (p 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load_piece(const T* p, T (&v)[kPer<T>]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < kPer<T>; ++i) v[i] = e[i];
}

template <typename T>
__device__ __forceinline__ void store_piece(T* p, const T (&v)[kPer<T>]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < kPer<T>; ++i) e[i] = v[i];
  *reinterpret_cast<uint4*>(p) = u;
}

// A band's ring of row slabs.  Row r's slab holds the band's 32 columns,
// kLeft halo columns on the left and one on the right, 8 pieces each
// (zero-filled past the image), in slot (r - h0 + kUp) % kSlabs: a stencil
// with left and upper neighbours (kLeft = kUp = 1) takes rows h0-1 .. h1,
// one with right and lower neighbours only (kLeft = kUp = 0) rows h0 .. h1.
// Each thread copies the same one or two pieces of every row; one commit
// group per call, empty where there is no row.
template <typename T, int kLeft, int kUp>
struct SlabRing {
  static constexpr int kPieces = (kPixels + kLeft + 1) * kGroups;
  static constexpr int kSlabBytes = kPieces * 16;
  static constexpr int kBytes = kSlabs * kSlabBytes;

  unsigned char* ring;
  const T* x;
  long long row;  // elements per image row
  int h0, h1, H;
  long long src[2];
  bool ok[2];

  __device__ __forceinline__ SlabRing(unsigned char* ring_, const T* x_,
                                      const Band& t, int H_, int W, int D)
      : ring(ring_), x(x_), row((long long)W * D), h0(t.h0), h1(t.h1),
        H(H_) {
    const long long image = (long long)t.b * H * row;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int p = threadIdx.x + q * kThreads;
      const int w = t.w0 - kLeft + p / kGroups;
      const int piece = t.g0 + p % kGroups;
      ok[q] = p < kPieces && w >= 0 && w < W && piece * kPer<T> < D;
      src[q] = image + (long long)w * D + piece * kPer<T>;
    }
  }

  __device__ __forceinline__ void copy_row(int r) {
    if (r >= 0 && r < H && r <= h1) {
      const uint32_t slot = rc::tc::smem_addr(ring) +
                            ((r - h0 + kUp) % kSlabs) * kSlabBytes;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = threadIdx.x + q * kThreads;
        if (p < kPieces)
          rc::tc::cp_async16(slot + p * 16, ok[q] ? x + src[q] + r * row : x,
                             ok[q]);
      }
    }
    rc::tc::cp_async_commit();
  }

  // The channels of piece `piece` (column * kGroups + group) of row r.
  __device__ __forceinline__ const T* at(int r, int piece) const {
    return reinterpret_cast<const T*>(
               ring + ((r - h0 + kUp) % kSlabs) * kSlabBytes) +
           piece * kPer<T>;
  }
};

namespace {

// The forwards' value: the partials (sum |dh|, sum |dv|) of `blocks` blocks
// summed in block order (each thread a strided run, then a fixed tree: two
// calls are bit-equal), then true division by each direction's pair count,
// the factors (1 where there are none) and the add, each rounded once in
// f32.
__global__ void __launch_bounds__(kSumThreads)
    tv_fwd_value_kernel(const float* __restrict__ partials, int blocks,
                        float pairs_h, float pairs_v, float rescale_h,
                        float rescale_v, float* __restrict__ out) {
  __shared__ float red[2][kSumThreads / 32];
  const int tid = threadIdx.x;
  float sh = 0.f, sv = 0.f;
  for (int i = tid; i < blocks; i += kSumThreads) {
    sh += partials[2ll * i];
    sv += partials[2ll * i + 1];
  }
  sh = rc::warp_sum(sh);
  sv = rc::warp_sum(sv);
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = sh;
    red[1][tid >> 5] = sv;
  }
  __syncthreads();
  if (tid == 0) {
    float th = 0.f, tv = 0.f;
#pragma unroll
    for (int i = 0; i < kSumThreads / 32; ++i) {
      th += red[0][i];
      tv += red[1][i];
    }
    const float tv_h = __fmul_rn(__fdiv_rn(th, pairs_h), rescale_h);
    const float tv_v = __fmul_rn(__fdiv_rn(tv, pairs_v), rescale_v);
    *out = __fadd_rn(tv_h, tv_v);
  }
}

// A block's (sum |dh|, sum |dv|) of its threads' f32 sums, in a fixed
// order, written by thread 0 as the block's partials (times `scale`).
__device__ __forceinline__ void write_partials(float sh, float sv,
                                               float scale,
                                               float* __restrict__ partials) {
  __shared__ float red[2][kThreads / 32];
  const int tid = threadIdx.x;
  sh = rc::warp_sum(sh);
  sv = rc::warp_sum(sv);
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = sh;
    red[1][tid >> 5] = sv;
  }
  __syncthreads();
  if (tid == 0) {
    float th = 0.f, tv = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      th += red[0][i];
      tv += red[1][i];
    }
    partials[2ll * blockIdx.x] = th * scale;
    partials[2ll * blockIdx.x + 1] = tv * scale;
  }
}

}  // namespace

}  // namespace band
}  // namespace rc
