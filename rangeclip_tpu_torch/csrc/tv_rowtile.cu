// Total variation of a bf16 [B, H, W, D] field: weighted sums of |dh| and
// |dv| (forward) and the gradient of the scaled sums (backward).
//
// Replaces rangeclip_tpu/ops/pallas/tv_rowtile.py: _fwd_kernel and
// _bwd_kernel, entry point tv_rowtile.  Same semantics: differences in the
// input dtype (a bf16 x[q] - x[q+1] is rounded to bf16 before |.| and before
// its sign), |.| summed in f32, a per-image 0/1 weight, and the slope
// u >= 0 ? +1 : -1 (+1 at ties) in the backward, whose combine
// gh * (sh_r - sh_l) + gv * (sv_d - sv_u) has its brackets in bf16 (exact:
// values in -2..2) and the f32 scalars outside, rounded once (RNE) to bf16.
// Both products are exact, so the backward is bit-equal to the plain
// version; the forward differs from it by the f32 summation order only.
//
// Bound on the card: bytes.  The forward reads the field once (0.54 GB at
// 32 x 128 x 128 x 512) and the backward reads it once and writes the
// gradient once (1.07 GB).
//
// Forward: each thread owns 8 channels (one 16-byte load) of one pixel
// column and walks down a tile of 8 image rows, keeping the rows above, at
// and below in registers; the horizontal neighbours are the next thread
// group's own loads (L1/L2 hits), so device memory sees about one read of
// the field.  The per-block partial sums are written out and summed by the
// caller in a fixed order (deterministic), as the TPU kernel's per-tile
// partials are.
//
// Backward: a block owns a band of 32 image rows x 32 pixel columns x 64
// channels and streams it down the image through a shared-memory ring of
// six row slabs (cp.async, 16-byte pieces, the column on each side
// included), rows h+2 .. h+4 in flight while row h is computed.  Every
// neighbour comes from shared memory, so x crosses device memory once plus
// the halo (2 of 32 columns, and a row above and below each band), and dx
// leaves in 16-byte stores, 128 contiguous bytes per pixel.  The row at h
// and its slope to the row above are carried in registers from the step
// before, and slopes are taken as signs of f32 differences (equal to the
// signs of the bf16-rounded ones), so a row costs about 20 instructions a
// channel: the kernel's bytes, not its arithmetic, set its pace.  Border
// slopes are masked (never zero-padded: slope(x, 0) is not 0); ragged
// bands, W-tiles and channel chunks (D % 64 != 0) leave threads idle.  The
// grid is one-dimensional, so the backward takes any B * H.
//
// The TPU kernel's VMEM tile search has no purpose here.  Requires D % 8 ==
// 0 and 16-byte aligned rows.

#include "common.cuh"

namespace {

// ---- forward ----------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRows = 8;  // image rows per block
using bf16 = __nv_bfloat16;

// The difference a - b rounded to bf16, widened back to f32.
__device__ __forceinline__ float diff_bf16(bf16 a, bf16 b) {
  return __bfloat162float(
      __float2bfloat16_rn(__bfloat162float(a) - __bfloat162float(b)));
}

// The backward's slope of two widened bf16 values: +1 where the bf16
// difference a - b is >= 0, else -1, taken without the bf16 rounding: a
// nonzero difference of two bf16 values is a multiple of 2^-133, the
// smallest bf16 subnormal, so neither its f32 nor its bf16 rounding reaches
// zero or changes its sign (a - a is +0 in both; inf - inf NaN in both).
__device__ __forceinline__ float sign_of_diff(float a, float b) {
  return a - b >= 0.f ? 1.f : -1.f;
}

struct Tile {
  long long p;  // (pixel column, channel group) pair of this thread
  int w, g;
  int b, h0, h1;
};

__device__ __forceinline__ Tile tile_of(int H, int W, int D) {
  Tile t;
  const int groups = D / 8;
  t.p = (long long)blockIdx.x * kThreads + threadIdx.x;
  t.w = (int)(t.p / groups);
  t.g = (int)(t.p % groups);
  const int tiles = (H + kRows - 1) / kRows;
  t.b = blockIdx.y / tiles;
  t.h0 = (blockIdx.y % tiles) * kRows;
  t.h1 = min(t.h0 + kRows, H);
  return t;
}

__global__ void __launch_bounds__(kThreads)
    tv_fwd_kernel(const bf16* __restrict__ x, int H, int W, int D,
                  const float* __restrict__ weight,
                  float* __restrict__ partials) {
  const Tile t = tile_of(H, W, D);
  float sh = 0.f, sv = 0.f;
  if (t.p < (long long)W * (D / 8)) {
    const long long row = (long long)W * D;
    const bf16* col = x + (long long)t.b * H * row + (long long)t.w * D +
                      t.g * 8;
    bf16 cur[8], nxt[8], right[8];
    rc::load8(col + t.h0 * row, cur);
    for (int h = t.h0; h < t.h1; ++h) {
      if (t.w < W - 1) {
        rc::load8(col + h * row + D, right);
#pragma unroll
        for (int i = 0; i < 8; ++i) sh += fabsf(diff_bf16(cur[i], right[i]));
      }
      if (h < H - 1) {
        rc::load8(col + (h + 1) * row, nxt);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          sv += fabsf(diff_bf16(cur[i], nxt[i]));
          cur[i] = nxt[i];
        }
      }
    }
  }
  __shared__ float red[2][kThreads / 32];
  sh = rc::warp_sum(sh);
  sv = rc::warp_sum(sv);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = sh;
    red[1][threadIdx.x >> 5] = sv;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float th = 0.f, tv = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      th += red[0][i];
      tv += red[1][i];
    }
    const float wt = weight != nullptr ? weight[t.b] : 1.f;
    const long long block =
        (long long)blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * block] = th * wt;
    partials[2 * block + 1] = tv * wt;
  }
}

dim3 grid_of(int B, int H, int W, int D) {
  const long long pairs = (long long)W * (D / 8);
  return dim3((unsigned)((pairs + kThreads - 1) / kThreads),
              (unsigned)(B * ((H + kRows - 1) / kRows)));
}

// The forward grid's y extent is at most 65535: B * ceil(H / 8) blocks.
bool valid_shape(int B, int H, int W, int D) {
  return B >= 1 && H >= 1 && W >= 1 && D >= 8 && D % 8 == 0 &&
         (long long)B * ((H + kRows - 1) / kRows) <= 65535;
}

// ---- backward: a shared-memory halo stencil --------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdPixels = 32;  // pixel columns per block (W-tile)
constexpr int kBwdGroups = 8;   // 8-channel groups per block: 64 channels
constexpr int kBand = 32;       // image rows per block
constexpr int kSlabs = 6;       // ring slots: rows h-1 .. h+4
constexpr int kBwdBlocks = 4;   // resident blocks per SM (64 registers)
constexpr int kSlabPieces = (kBwdPixels + 2) * kBwdGroups;  // with the halo
constexpr int kSlabBytes = kSlabPieces * 16;

struct Band {
  int b, h0, h1, w0, g0;  // image, rows [h0, h1), first column and group
};

// One 32-bit division chain per block: W-tiles fastest, then channel
// chunks, bands and images.
__device__ __forceinline__ Band band_of(int H, int W, int D) {
  const unsigned wtiles = (W + kBwdPixels - 1) / kBwdPixels;
  const unsigned chunks = (D / 8 + kBwdGroups - 1) / kBwdGroups;
  const unsigned bands = (H + kBand - 1) / kBand;
  unsigned i = blockIdx.x;
  Band t;
  t.w0 = (int)(i % wtiles) * kBwdPixels;
  i /= wtiles;
  t.g0 = (int)(i % chunks) * kBwdGroups;
  i /= chunks;
  t.h0 = (int)(i % bands) * kBand;
  t.b = (int)(i / bands);
  t.h1 = min(t.h0 + kBand, H);
  return t;
}

__global__ void __launch_bounds__(kBwdThreads, kBwdBlocks)
    tv_bwd_kernel(const bf16* __restrict__ x, int H, int W, int D,
                  const float* __restrict__ weight,
                  const float* __restrict__ grad, float pairs_h,
                  float pairs_v, float rescale_h, float rescale_v,
                  bf16* __restrict__ dx) {
  __shared__ __align__(16) unsigned char ring[kSlabs * kSlabBytes];
  const Band t = band_of(H, W, D);
  const int tid = threadIdx.x;
  const long long row = (long long)W * D;  // elements per image row
  const long long image = (long long)t.b * H * row;
  const uint32_t base = rc::tc::smem_addr(ring);
  // Row r's slab (columns w0-1 .. w0+32, 64 channels; zero-filled past the
  // image) into slot (r - h0 + 1) % kSlabs; rows h0-1 .. h1 are needed.
  // Each thread copies the same one or two pieces of every row.  One
  // commit group per call, empty where there is no row.
  long long src[2];
  bool ok[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = tid + q * kBwdThreads;
    const int w = t.w0 - 1 + p / kBwdGroups;
    const int grp = t.g0 + p % kBwdGroups;
    ok[q] = p < kSlabPieces && w >= 0 && w < W && grp * 8 < D;
    src[q] = image + (long long)w * D + grp * 8;
  }
  auto copy_row = [&](int r) {
    if (r >= 0 && r < H && r <= t.h1) {
      const uint32_t slot = base + ((r - t.h0 + 1) % kSlabs) * kSlabBytes;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (tid + q * kBwdThreads < kSlabPieces)
          rc::tc::cp_async16(slot + (tid + q * kBwdThreads) * 16,
                             ok[q] ? x + src[q] + r * row : x, ok[q]);
    }
    rc::tc::cp_async_commit();
  };
  for (int i = 0; i < kSlabs - 1; ++i) copy_row(t.h0 - 1 + i);

  // this thread: column j of the tile, channel group gi of the chunk
  const int j = tid / kBwdGroups;
  const int w = t.w0 + j;
  const bool active = w < W && (t.g0 + tid % kBwdGroups) * 8 < D;
  const bool has_l = w > 0;
  const bool has_r = w < W - 1;
  const int at = (j + 1) * kBwdGroups + tid % kBwdGroups;  // piece in a slab
  // (gh, gv) as the wrapper's pair_grads forms them (f32 true division,
  // then the rescale), times the image's weight
  const float wt = weight != nullptr ? weight[t.b] : 1.f;
  const float gh =
      __fmul_rn(__fmul_rn(__fdiv_rn(*grad, pairs_h), rescale_h), wt);
  const float gv =
      __fmul_rn(__fmul_rn(__fdiv_rn(*grad, pairs_v), rescale_v), wt);
  auto slab = [&](int r) {
    return reinterpret_cast<const bf16*>(ring + ((r - t.h0 + 1) % kSlabs) *
                                                    kSlabBytes) +
           at * 8;
  };
  float cur[8];  // row h, widened
  float sv_u[8];  // slope(row h-1, row h): the previous row's sv_d
  bf16 v[8], out[8];
  for (int h = t.h0; h < t.h1; ++h) {
    // rows <= h+1 landed; later ones in flight
    rc::tc::cp_async_wait<kSlabs - 4>();
    __syncthreads();              // ... for every thread; row h-2 is free
    copy_row(h + kSlabs - 2);     // row h+kSlabs-2 into row h-2's slot
    if (!active) continue;
    if (h == t.h0) {
      rc::load8(slab(h), v);
#pragma unroll
      for (int i = 0; i < 8; ++i) cur[i] = __bfloat162float(v[i]);
      if (h > 0) rc::load8(slab(h - 1), v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sv_u[i] = h > 0 ? sign_of_diff(__bfloat162float(v[i]), cur[i]) : 0.f;
    }
    float sh[8];  // sh_r - sh_l
    if (has_r) rc::load8(slab(h) + 8 * kBwdGroups, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      sh[i] = has_r ? sign_of_diff(cur[i], __bfloat162float(v[i])) : 0.f;
    if (has_l) rc::load8(slab(h) - 8 * kBwdGroups, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      sh[i] -= has_l ? sign_of_diff(__bfloat162float(v[i]), cur[i]) : 0.f;
    const bool has_d = h < H - 1;
    if (has_d) rc::load8(slab(h + 1), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float below = __bfloat162float(v[i]);
      const float sv_d = has_d ? sign_of_diff(cur[i], below) : 0.f;
      out[i] = __float2bfloat16_rn(
          __fadd_rn(__fmul_rn(gh, sh[i]), __fmul_rn(gv, sv_d - sv_u[i])));
      sv_u[i] = sv_d;
      cur[i] = below;
    }
    rc::store8(dx + image + h * row + (long long)w * D +
                   (t.g0 + tid % kBwdGroups) * 8,
               out);
  }
}

long long bwd_blocks(int B, int H, int W, int D) {
  return (long long)B * ((H + kBand - 1) / kBand) *
         ((D / 8 + kBwdGroups - 1) / kBwdGroups) *
         ((W + kBwdPixels - 1) / kBwdPixels);
}

}  // namespace

// x: [B, H, W, D] bf16, 16-byte aligned; weight: [B] f32 or NULL (all 1);
// partials: [grid.y * grid.x, 2] f32 with grid.x = ceil(W * D / 8 / 256)
// and grid.y = B * ceil(H / 8): per block (sum |dh|, sum |dv|) * weight.
extern "C" int rc_tv_rowtile_fwd(const void* x, int B, int H, int W, int D,
                                 const float* weight, float* partials,
                                 void* stream) {
  if (!valid_shape(B, H, W, D)) return cudaErrorInvalidValue;
  tv_fwd_kernel<<<grid_of(B, H, W, D), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), H, W, D, weight, partials);
  return cudaGetLastError();
}

// grad: the upstream gradient, an f32 scalar on the device; pairs_h,
// pairs_v: each direction's pair count; rescale_h, rescale_v: the upsample
// rescales (1 at upsample 1); (gh, gv) = grad / pairs * rescale in f32, as
// tv_rowtile.py's pair_grads.  dx: [B, H, W, D] bf16.  Any B, H, W >= 1 and
// D % 8 == 0 with fewer than 2^31 blocks (no limit of the forward's grid).
extern "C" int rc_tv_rowtile_bwd(const void* x, int B, int H, int W, int D,
                                 const float* weight, const float* grad,
                                 float pairs_h, float pairs_v,
                                 float rescale_h, float rescale_v, void* dx,
                                 void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 8 || D % 8 != 0 ||
      bwd_blocks(B, H, W, D) >= (1ll << 31))
    return cudaErrorInvalidValue;
  tv_bwd_kernel<<<(unsigned)bwd_blocks(B, H, W, D), kBwdThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), H, W, D, weight, grad, pairs_h, pairs_v,
      rescale_h, rescale_v, static_cast<bf16*>(dx));
  return cudaGetLastError();
}
