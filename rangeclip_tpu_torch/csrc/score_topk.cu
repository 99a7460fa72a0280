// Masked top-k over a precomputed [N, S] pixel x candidate score field,
// emitting global class ids.
//
// Replaces rangeclip_tpu/ops/pallas/score_topk.py: _select_kernel (f32
// knockout selector) and _select_kernel_packed (bf16 packed-key selector),
// entry point fused_score_topk.
//
// Bound on the card: bytes.  Each score is read once and used for a few
// integer or float compares, so the kernel can at best stream the field at
// device-memory bandwidth (N*S*2 bytes in bf16, N*S*4 in f32).
//
// Design: one warp per pixel row.  The S scores of a row are contiguous (the
// scoring conv runs channels_last), so lane j reads slots j, j+32, ... and
// every warp load is one coalesced segment.  Each lane keeps its own sorted
// top-k in registers; k warp-shuffle rounds then merge the 32 lists.  The
// TPU kernel's in-register transpose to class-major tiles has no purpose
// here and is not carried over.
//
// Knockout semantics (score_topk.py:91-120): dead slots score -1e30 with id
// -1; the winner is the max, ties to the smallest id.  Since the dead slots
// share id -1 and knocking them out leaves them at -1e30, once a dead slot
// wins every later pick is (-1, -1e30) as well.  NaN scores are not
// supported by this kernel (the TPU kernel's NaN behaviour is not kept).

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    score_topk_packed_kernel(const __nv_bfloat16* __restrict__ scores,
                             const int* __restrict__ ids, long long n, int s,
                             int* __restrict__ idx, float* __restrict__ vals) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const __nv_bfloat16* r = scores + row * s;

  int keys[K];
#pragma unroll
  for (int i = 0; i < K; ++i) keys[i] = INT_MIN;
  for (int j = lane; j < s; j += 32) {
    const int id = __ldg(ids + j);
    rc::insert_key(keys,
                   id >= 0 ? rc::packed_key(rc::to_float(r[j]), id) : INT_MIN);
  }
  // Valid keys are unique (distinct ids), so exactly one lane owns the max.
#pragma unroll
  for (int t = 0; t < K; ++t) {
    int m = keys[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (m != INT_MIN && keys[0] == m) {
#pragma unroll
      for (int i = 0; i + 1 < K; ++i) keys[i] = keys[i + 1];
      keys[K - 1] = INT_MIN;
    }
    if (lane == 0) {
      int id;
      float value;
      rc::decode_packed(m, &id, &value);
      idx[row * K + t] = id;
      if (vals != nullptr) vals[row * K + t] = value;
    }
  }
}

using rc::better;

template <int K, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    score_topk_knockout_kernel(const T* __restrict__ scores,
                               const int* __restrict__ ids, long long n, int s,
                               int* __restrict__ idx,
                               float* __restrict__ vals) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const T* r = scores + row * s;

  // Empty entries rank below every candidate, -inf scores included.
  float v[K];
  int id[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = -CUDART_INF_F;
    id[i] = INT_MAX;
  }
  for (int j = lane; j < s; j += 32) {
    const int cid = __ldg(ids + j);
    rc::insert_pair(v, id, cid >= 0 ? rc::to_float(r[j]) : rc::kNegInf, cid);
  }
  bool dead_won = false;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    float bv = v[0];
    int bid = id[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oid = __shfl_xor_sync(0xffffffffu, bid, off);
      if (better(ov, oid, bv, bid)) {
        bv = ov;
        bid = oid;
      }
    }
    dead_won = dead_won || bid == -1;
    int out_id = -1;
    float out_v = rc::kNegInf;
    if (!dead_won && bid != INT_MAX) {
      out_id = bid;
      out_v = bv;
      if (id[0] == bid) {  // ids of valid slots are unique: one owner
#pragma unroll
        for (int i = 0; i + 1 < K; ++i) {
          v[i] = v[i + 1];
          id[i] = id[i + 1];
        }
        v[K - 1] = -CUDART_INF_F;
        id[K - 1] = INT_MAX;
      }
    }
    if (lane == 0) {
      idx[row * K + t] = out_id;
      if (vals != nullptr) vals[row * K + t] = out_v;
    }
  }
}

template <int K>
cudaError_t launch(const void* scores, int is_bf16, int packed, const int* ids,
                   long long n, int s, int* idx, float* vals,
                   cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock));
  if (packed) {
    if (!is_bf16) return cudaErrorInvalidValue;
    score_topk_packed_kernel<K><<<grid, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(scores), ids, n, s, idx, vals);
  } else if (is_bf16) {
    score_topk_knockout_kernel<K, __nv_bfloat16><<<grid, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(scores), ids, n, s, idx, vals);
  } else {
    score_topk_knockout_kernel<K, float><<<grid, block, 0, stream>>>(
        static_cast<const float*>(scores), ids, n, s, idx, vals);
  }
  return cudaGetLastError();
}

}  // namespace

// scores: [n, s] row-major, f32 (is_bf16 == 0) or bf16; ids: [s] int32;
// idx: [n, k] int32; vals: [n, k] f32 or NULL.  1 <= k <= 8, n >= 1.
extern "C" int rc_score_topk(const void* scores, int is_bf16, int packed,
                             const int* ids, long long n, int s, int k,
                             int* idx, float* vals, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(scores, is_bf16, packed, ids, n, s, idx, vals, st);
    case 2: return launch<2>(scores, is_bf16, packed, ids, n, s, idx, vals, st);
    case 3: return launch<3>(scores, is_bf16, packed, ids, n, s, idx, vals, st);
    case 4: return launch<4>(scores, is_bf16, packed, ids, n, s, idx, vals, st);
    case 5: return launch<5>(scores, is_bf16, packed, ids, n, s, idx, vals, st);
    case 6: return launch<6>(scores, is_bf16, packed, ids, n, s, idx, vals, st);
    case 7: return launch<7>(scores, is_bf16, packed, ids, n, s, idx, vals, st);
    case 8: return launch<8>(scores, is_bf16, packed, ids, n, s, idx, vals, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* rc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
