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
// Design (simple first; no tensor cores yet): a block owns a strip of
// kTileW pixels of one image row, one pixel per thread.  It stages the
// 3-row halo of features in shared memory once, with out-of-image taps as
// zeros, laid out channel-major so that neighbouring threads read
// neighbouring pixels.  It then streams the folded weights through shared
// memory in chunks of kSlotChunk slots (widened to f32, slot-minor so a
// thread reads four slots' weights with one broadcast 16-byte load).  Each
// thread accumulates kSlotChunk scores in f32 registers, rounds each to
// bf16 and inserts its packed key into a sorted register top-k.  Nothing
// of the TPU version's [h, C_in, w*B] relayout or B % 128 lane trick is
// needed.

#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kTileW = 128;     // pixels (threads) per block
constexpr int kSlotChunk = 32;  // slots per weight chunk in shared memory
constexpr int kCols = kTileW + 2;

size_t smem_bytes(int c_in) {
  return (size_t)9 * c_in * kSlotChunk * sizeof(float) +
         kSlotChunk * sizeof(int) +
         (size_t)3 * c_in * kCols * sizeof(__nv_bfloat16);
}

template <int K>
__global__ void __launch_bounds__(kTileW)
    conv_score_topk_kernel(const __nv_bfloat16* __restrict__ feats,
                           const __nv_bfloat16* __restrict__ wt,
                           const int* __restrict__ ids, int h, int w, int c_in,
                           int s, int* __restrict__ idx,
                           float* __restrict__ vals) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int taps = 9 * c_in;  // weight row length, ordered (dy, dx, c)
  float* s_w = reinterpret_cast<float*>(smem);  // [taps][kSlotChunk]
  int* s_ids = reinterpret_cast<int*>(s_w + taps * kSlotChunk);
  // [3][c_in][kCols]: row dy, channel c, column (x0 - 1 + col)
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(s_ids + kSlotChunk);

  const int tx = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;
  const int y = blockIdx.y;
  const int b = blockIdx.z;

  // Stage the halo: each thread copies 8 channels (16 bytes) of one pixel.
  const int groups = c_in / 8;
  for (int e = tx; e < 3 * kCols * groups; e += kTileW) {
    const int g = e % groups;
    const int col = (e / groups) % kCols;
    const int dy = e / (groups * kCols);
    const int yy = y + dy - 1;
    const int xx = x0 + col - 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
      v = *reinterpret_cast<const uint4*>(
          feats + (((long long)b * h + yy) * w + xx) * c_in + g * 8);
    }
    const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s_x[(dy * c_in + g * 8 + i) * kCols + col] = pv[i];
  }

  const int x = x0 + tx;
  const bool active = x < w;
  int keys[K];
#pragma unroll
  for (int i = 0; i < K; ++i) keys[i] = INT_MIN;

  for (int s0 = 0; s0 < s; s0 += kSlotChunk) {
    __syncthreads();  // halo staged / previous chunk fully consumed
    // Stage weights: lane = slot, so the transposing smem stores are
    // conflict-free; each thread reads 8 consecutive taps of one slot row.
    for (int e = tx; e < kSlotChunk * (taps / 8); e += kTileW) {
      const int sl = e % kSlotChunk;
      const int j = (e / kSlotChunk) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(
          wt + (long long)(s0 + sl) * taps + j);
      const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        s_w[(j + i) * kSlotChunk + sl] = __bfloat162float(pv[i]);
    }
    if (tx < kSlotChunk) s_ids[tx] = ids[s0 + tx];
    __syncthreads();
    if (!active) continue;

    float acc[kSlotChunk];
#pragma unroll
    for (int j = 0; j < kSlotChunk; ++j) acc[j] = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const __nv_bfloat16* xr = s_x + dy * c_in * kCols + tx + dx;
        const float* wr = s_w + (dy * 3 + dx) * c_in * kSlotChunk;
        for (int c = 0; c < c_in; ++c) {
          const float xv = __bfloat162float(xr[c * kCols]);
          const float4* w4 =
              reinterpret_cast<const float4*>(wr + c * kSlotChunk);
#pragma unroll
          for (int q = 0; q < kSlotChunk / 4; ++q) {
            const float4 wv = w4[q];
            acc[4 * q + 0] = fmaf(xv, wv.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv, wv.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv, wv.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv, wv.w, acc[4 * q + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kSlotChunk; ++j) {
      const int id = s_ids[j];
      if (id >= 0) {
        const float rounded = __bfloat162float(__float2bfloat16_rn(acc[j]));
        rc::insert_key(keys, rc::packed_key(rounded, id));
      }
    }
  }
  if (!active) return;
  const long long p = ((long long)b * h + y) * w + x;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    int id;
    float value;
    rc::decode_packed(keys[t], &id, &value);
    idx[p * K + t] = id;
    if (vals != nullptr) vals[p * K + t] = value;
  }
}

template <int K>
cudaError_t launch(const __nv_bfloat16* feats, const __nv_bfloat16* wt,
                   const int* ids, int batch, int h, int w, int c_in, int s,
                   int* idx, float* vals, cudaStream_t stream) {
  const size_t smem = smem_bytes(c_in);
  cudaError_t err = cudaFuncSetAttribute(
      conv_score_topk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((w + kTileW - 1) / kTileW), (unsigned)h,
                  (unsigned)batch);
  conv_score_topk_kernel<K><<<grid, kTileW, smem, stream>>>(
      feats, wt, ids, h, w, c_in, s, idx, vals);
  return cudaGetLastError();
}

}  // namespace

// feats: [batch, h, w, c_in] bf16 (c_in % 8 == 0, 16-byte aligned);
// wt: [s, 9 * c_in] bf16, rows ordered (dy, dx, c) (s % 32 == 0);
// ids: [s] int32 in [-1, 2^16); idx: [batch*h*w, k] int32; vals: same f32
// or NULL.  1 <= k <= 8.
extern "C" int rc_conv_score_topk(const void* feats, const void* wt,
                                  const int* ids, int batch, int h, int w,
                                  int c_in, int s, int k, int* idx,
                                  float* vals, void* stream) {
  if (c_in % 8 != 0 || s % kSlotChunk != 0) return cudaErrorInvalidValue;
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
