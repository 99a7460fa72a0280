// Shared device helpers for the port's Hopper kernels.
//
// The packed selection key is the one of rangeclip_tpu/ops/pallas/score_topk.py
// (_select_kernel_packed): a bf16 score widened to f32 has its low 16 mantissa
// bits zero, so the sign-magnitude -> two's-complement map of its bits is a
// monotone int32 key with 16 free low bits.  Those bits carry 0xFFFF - id, so
// equal scores break ties to the smallest id.  Dead slots (id -1) get INT_MIN.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace rc {

constexpr float kNegInf = -1e30f;  // the mask value of the JAX kernels

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Key of a bf16 value (already widened to f32) at global class id `id`
// (0 <= id < 2^16); score_topk.py:159-164.
__device__ __forceinline__ int packed_key(float widened_bf16, int id) {
  const int b = __float_as_int(widened_bf16);
  return (b ^ ((b >> 31) & 0x7FFF0000)) + (0xFFFF - id);
}

// Inverse of packed_key: the id and the exact f32 bits of the stored bf16
// score; INT_MIN (no valid slot left) decodes to -1 and kNegInf
// (score_topk.py:176-187).
__device__ __forceinline__ void decode_packed(int m, int* id, float* value) {
  if (m == INT_MIN) {
    *id = -1;
    *value = kNegInf;
    return;
  }
  const int g = 0xFFFF - (m & 0xFFFF);
  const int bu = (m + g) & -65536;
  const int vb = (bu ^ ((bu >> 31) & 0x7FFFFFFF)) & -65536;
  *id = g;
  *value = __int_as_float(vb);
}

// Insert `key` into the descending register list keys[0..K).
template <int K>
__device__ __forceinline__ void insert_key(int (&keys)[K], int key) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int hi = max(keys[i], key);
    key = min(keys[i], key);
    keys[i] = hi;
  }
}

// (a_v, a_id) ranks above (b_v, b_id): larger value, ties to the smaller id
// (the knockout selectors' order, score_topk.py:91-120).
__device__ __forceinline__ bool better(float a_v, int a_id, float b_v,
                                       int b_id) {
  return a_v > b_v || (a_v == b_v && a_id < b_id);
}

// Insert (cv, cid) into the register list (v, id)[0..K), kept in `better`
// order.  Empty entries are (-inf, INT_MAX).
template <int K>
__device__ __forceinline__ void insert_pair(float (&v)[K], int (&id)[K],
                                            float cv, int cid) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (better(cv, cid, v[i], id[i])) {
      const float tv = v[i];
      const int ti = id[i];
      v[i] = cv;
      id[i] = cid;
      cv = tv;
      cid = ti;
    }
  }
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 round_to(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}

// Eight consecutive values through 16-byte accesses (p 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load8(const T* p, T (&v)[8]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < 8 / kPer; ++q) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[q];
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[q * kPer + i] = t[i];
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const T (&v)[8]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < 8 / kPer; ++q) {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < kPer; ++i) t[i] = v[q * kPer + i];
    reinterpret_cast<uint4*>(p)[q] = u;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace rc
