// Fused folded-head 3x3 conv + packed-key top-k.
//
// Replaces rangeclip_tpu/ops/pallas/conv_score_topk.py: _kernel, entry point
// fused_conv_score_topk.  Same contract: a SAME 3x3 conv of the bf16 pre-head
// features with the folded weights, accumulated in f32 and rounded to bf16,
// then the packed-key top-k of score_topk with global ids (ties to the
// smallest id, -1 slots never win, borders are zero).  Outputs are in
// (B, h, w) pixel order, not the TPU kernel's (h, w, B).
//
// Bound on the card: arithmetic.  Each pixel costs S * 9 * C_in MACs (S=384,
// C_in=32: 110,592 per pixel) against 2*C_in bytes of features read and
// k*4 (or 8) bytes written, so the [N, S] score field that the two-program
// path writes and reads back never touches device memory.
//
// Design: an implicit GEMM on the tensor cores, [pixels, 9*C_in] x
// [9*C_in, S], with the selection in registers (common.cuh: tc::score_tiles
// and KeyTopK, shared with pixel_text_topk.cu's bf16 kernel).  A block of
// two consumer warpgroups (one beyond C_in 64, where 128 im2col rows no
// longer fit in shared memory beside the ring) owns 64 consecutive pixels
// each of the flattened (B, h, w) order, so ragged rows and images need no
// special case.
//   1. im2col (common.cuh: tc::im2col, shared with head_topk.cu's
//      tensor-core kernel): the block copies each pixel's 9 taps x C_in
//      channels straight from device memory (cp.async through L1, which
//      serves the taps that neighbouring pixels share) into shared memory
//      in wgmma's 128-byte-swizzled A layout, K ordered (dy, dx, c) as the
//      weight rows are and zero-filled up to a multiple of 16.  Taps
//      outside the image are zero-filled by the copy itself (the SAME
//      border).  80 KB at C_in=32 (K = 288 in five 64-dim blocks).
//   2. A producer warp streams the folded rows as [128 slots, 64 dims]
//      chunks through a four-stage ring with TMA (216 KB in all at S=384,
//      resident in L2); each chunk is up to four wgmma m64n128k16 into f32
//      registers, left in flight while the next chunk is waited for.
//   3. After a slot tile's last chunk each thread rounds its 64
//      accumulators (two pixels, 32 slots) to bf16, packs each live slot's
//      key and feeds it to the pixel's register list with a branchless
//      insertion (common.cuh: KeyTopK); dead slots (a bit mask per tile,
//      loaded as the tile starts) never enter.  The key carries the slot,
//      which ranks as its id (live ids ascend with the slot, the wrapper's
//      contract), mapped to the id at the end.  The 4 threads of a quad
//      merge their lists by shuffles.
// Nothing of the TPU version's [h, C_in, w*B] relayout or B % 128 lane trick
// is needed.

#include "common.cuh"

#include <stdint.h>

namespace {

// Threads: 128 per consumer warpgroup, then the producer warp.
template <int K>
__global__ void __launch_bounds__(rc::tc::kMaxWarpgroups * 128 + 32, 1)
    conv_score_topk_kernel(const __grid_constant__ CUtensorMap wt_map,
                           const __nv_bfloat16* __restrict__ feats,
                           const int* __restrict__ ids, int npix, int h,
                           int w, int c_in, int s, int* __restrict__ idx,
                           float* __restrict__ vals) {
  using namespace rc::tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nthreads = blockDim.x - 32;  // consumer threads
  const int pixels = nthreads / 128 * kWarpRows;  // of the block
  const int taps = 9 * c_in;  // weight row length, ordered (dy, dx, c)
  const int k16 = (taps + 15) / 16;
  const int blocks_k = (k16 + 3) / 4;
  const int a_block_bytes = pixels * kRowBytes;
  const uint32_t a = smem_addr(smem);
  const Ring ring{a + blocks_k * a_block_bytes,
                  a + blocks_k * a_block_bytes + kStages * kChunkBytes};
  const int p0 = blockIdx.x * pixels;
  if (tid == 0) ring.init(nthreads / 128);
  __syncthreads();
  if (tid >= nthreads) {  // the producer warp: the weight rows' chunks
    if (tid == nthreads) ring.produce(&wt_map, s, k16);
    return;
  }
  // (x, y) of each pixel of the block
  int2* coords = reinterpret_cast<int2*>(
      smem + blocks_k * a_block_bytes + kStages * kChunkBytes + kBarrierBytes);
  pixel_coords(coords, p0, pixels, npix, h, w, nthreads, tid);
  consumer_sync(nthreads);

  // 1. im2col into the swizzled A tile, a warp per pixel (common.cuh)
  im2col(a, a_block_bytes, feats, p0, pixels, coords, h, w, c_in, k16,
         nthreads, tid);
  cp_async_wait_all();
  fence_proxy_async();
  consumer_sync(nthreads);

  // 2-3. scores on the tensor cores, bf16-rounded packed keys into the
  // lists.  The keys carry the slot, which ranks as its id does (live ids
  // ascend with the slot); dead slots never enter.
  const int wg = tid >> 7;
  rc::KeyTopK<K> top;
  top.init();
  unsigned dead = 0;  // the tile's dead mask, loaded as the tile starts
  score_tiles(
      ring, a + wg * kWarpRows * kRowBytes, a_block_bytes, s, k16, tid & 127,
      [&](int t) { dead = dead_mask(ids, t * kTileN, s, lane); },
      [&](const float(&acc)[64], int t) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float rounded = __bfloat162float(__float2bfloat16_rn(acc[i]));
          const int slot = t * kTileN + frag_col(i, lane);
          top.push((i >> 1) & 1, (dead >> mask_bit(i)) & 1u
                                     ? INT_MIN
                                     : rc::packed_key(rounded, slot));
        }
      });
  top.merge_quad();

  // thread 0 of a quad writes the first pixel, thread 1 the second
  const int half = lane & 3;
  if (half > 1) return;
  const long long p = p0 + wg * kWarpRows + frag_row(half, tid & 127);
  if (p >= npix) return;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    int slot;
    float value;
    rc::decode_packed(half ? top.key[1][t] : top.key[0][t], &slot, &value);
    idx[p * K + t] = slot >= 0 ? __ldg(ids + slot) : -1;
    if (vals != nullptr) vals[p * K + t] = value;
  }
}

int k16_of(int c_in) { return (9 * c_in + 15) / 16; }

constexpr int kRowExtra = sizeof(int2);  // a pixel's (x, y) after the ring

template <int K>
cudaError_t launch(const __nv_bfloat16* feats, const __nv_bfloat16* wt,
                   const int* ids, int batch, int h, int w, int c_in, int s,
                   int* idx, float* vals, cudaStream_t stream) {
  const int k16 = k16_of(c_in);
  const int wgs = rc::tc::warpgroups_for(k16, kRowExtra);
  const int pixels = wgs * rc::tc::kWarpRows;
  const size_t smem = rc::tc::smem_bytes(pixels, k16, kRowExtra);
  CUtensorMap map;
  cudaError_t err = rc::tc::make_tensor_map(&map, wt, s, 9 * c_in);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_score_topk_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int npix = batch * h * w;
  const dim3 grid((unsigned)((npix + pixels - 1) / pixels));
  conv_score_topk_kernel<K><<<grid, wgs * 128 + 32, smem, stream>>>(
      map, feats, ids, npix, h, w, c_in, s, idx, vals);
  return cudaGetLastError();
}

}  // namespace

// feats: [batch, h, w, c_in] bf16 (c_in % 8 == 0, 16-byte aligned);
// wt: [s, 9 * c_in] bf16, rows ordered (dy, dx, c), 16-byte aligned;
// ids: [s] int32 in [-1, 2^16), ascending over the live slots; s <= 2^16;
// idx: [batch*h*w, k] int32; vals: same f32 or NULL.  1 <= k <= 8;
// c_in <= 136 (64 im2col rows within 227 KB); batch * h * w < 2^31.
extern "C" int rc_conv_score_topk(const void* feats, const void* wt,
                                  const int* ids, int batch, int h, int w,
                                  int c_in, int s, int k, int* idx,
                                  float* vals, void* stream) {
  if (c_in % 8 != 0 || c_in <= 0 || s <= 0 || s > 65536 ||
      rc::tc::warpgroups_for(k16_of(c_in), kRowExtra) == 0 ||
      (long long)batch * h * w >= INT_MAX)
    return cudaErrorInvalidValue;
  const auto* f = static_cast<const __nv_bfloat16*>(feats);
  const auto* wb = static_cast<const __nv_bfloat16*>(wt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(f, wb, ids, batch, h, w, c_in, s, idx, vals, st);
    case 2: return launch<2>(f, wb, ids, batch, h, w, c_in, s, idx, vals, st);
    case 3: return launch<3>(f, wb, ids, batch, h, w, c_in, s, idx, vals, st);
    case 4: return launch<4>(f, wb, ids, batch, h, w, c_in, s, idx, vals, st);
    case 5: return launch<5>(f, wb, ids, batch, h, w, c_in, s, idx, vals, st);
    case 6: return launch<6>(f, wb, ids, batch, h, w, c_in, s, idx, vals, st);
    case 7: return launch<7>(f, wb, ids, batch, h, w, c_in, s, idx, vals, st);
    case 8: return launch<8>(f, wb, ids, batch, h, w, c_in, s, idx, vals, st);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the kernel's block at c_in, for reports.
extern "C" long long rc_conv_score_topk_smem(int c_in) {
  const int k16 = k16_of(c_in);
  const int wgs = rc::tc::warpgroups_for(k16, kRowExtra);
  return wgs ? (long long)rc::tc::smem_bytes(wgs * rc::tc::kWarpRows, k16,
                                             kRowExtra)
             : 0;
}
