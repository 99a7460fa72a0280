// The live rows of a score table, gathered and transposed on the device in
// one launch for the CUDA-core scoring kernels (pixel_text_topk.cu's fp32
// kernel, pixel_text_ce.cu's member-only forward and backward), or in bf16
// for the tensor-core CE past 4 label slots (pixel_text_ce_slots.cu), which
// takes them both row-major (the logits' B operand) and transposed (the
// backward's second product), each through TMA.
//
// No TPU kernel of its own: the JAX package scores whole tables and
// gathers the contrast members in XLA (rangeclip_tpu/losses/infonce.py:311,
// pack_contrast_set).  The plain version is live_rows.live_table over the
// rows' concatenation, which this kernel matches bit for bit.
//
// Rows: segment A ([ca, d], ids a_ids or 0..ca-1, live where a_mask != 0,
// or where the id >= 0 when a_mask is NULL) and, optionally, segment B
// ([cb, d], ids b_ids, live where b_mask != 0).  With the device flag
// use_packed, only the segment it selects (B where it is non-zero, else A)
// has live rows, and that segment comes first.  Out: the live rows in that
// order, then the others in that order, as the columns of a [d, ldt] f32
// matrix (columns past ca + cb zero), their ids, and the live count.  The
// bf16 form (rc_live_rows_bf16) writes that matrix in bf16 and the rows in
// the same order to a [ca + cb, d] matrix too, in the same launch.
//
// Bound on the card: bytes, each row read once and each column written
// once (1.3 MB at 640 rows of 512 dims: 0.4 us); the launch and one scan
// of the flags are what it costs.  A block of 256 threads owns 32 output
// columns by 32 dims.  Every block scans all the rows' live flags (C up to
// a few thousand: a few 256-row chunks), ranks them with warp ballots, and
// keeps the source row of each of its 32 columns in shared memory; then
// each warp writes 32 consecutive columns of a dim (128 bytes) per store.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // output columns and dims per block

struct Segment {
  const void* rows;  // [count, d]
  const int* ids;    // [count], or NULL: 0..count-1
  const int* mask;   // [count] live where != 0, or NULL: live where id >= 0
  int count;
};

__device__ __forceinline__ int seg_id(const Segment& s, int i) {
  return s.ids != nullptr ? __ldg(s.ids + i) : i;
}

__device__ __forceinline__ bool seg_live(const Segment& s, int i) {
  return s.mask != nullptr ? __ldg(s.mask + i) != 0 : __ldg(s.ids + i) >= 0;
}

// An output element from a row's element: f32 widens exactly, bf16 copies.
__device__ __forceinline__ float out_of(float v, float*) { return v; }
__device__ __forceinline__ float out_of(__nv_bfloat16 v, float*) {
  return __bfloat162float(v);
}
__device__ __forceinline__ __nv_bfloat16 out_of(__nv_bfloat16 v,
                                                __nv_bfloat16*) {
  return v;
}

// O: the transposed output's type (f32, or bf16 for bf16 rows); rows_out,
// when not NULL, gets the rows too ([a.count + b.count, d], bf16).
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
    live_rows_kernel(Segment a, Segment b, const int* use_packed, int d,
                     O* __restrict__ table_t, int ldt,
                     O* __restrict__ rows_out, int* __restrict__ ids,
                     int* __restrict__ count) {
  __shared__ int src[kTile];  // the concatenated row of each column, or -1
  __shared__ int warp_live[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool b_first = b.count > 0 && use_packed != nullptr && *use_packed;
  const Segment first = b_first ? b : a;
  const Segment second = b_first ? a : b;
  const int rows = a.count + b.count;
  const int p0 = blockIdx.x * kTile;
  if (tid < kTile) src[tid] = -1;

  // the live rows: the selected (first) segment's, where its flag says so
  auto live = [&](int r) { return r < first.count && seg_live(first, r); };
  int total = 0;
  for (int r0 = 0; r0 < first.count; r0 += kThreads)
    total += __syncthreads_count(live(r0 + tid));

  // rank each row: live rows by their order among the live, the others
  // after them by theirs; keep the rows whose place is this block's
  int before = 0;  // live rows before this chunk
  for (int r0 = 0; r0 < rows; r0 += kThreads) {
    const int r = r0 + tid;
    const bool l = r < rows && live(r);
    const unsigned ballot = __ballot_sync(0xffffffffu, l);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int rank = before + __popc(ballot & ((1u << lane) - 1u));
    int chunk = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) rank += warp_live[w];
      chunk += warp_live[w];
    }
    const int place = l ? rank : total + (r - rank);
    if (r < rows && place >= p0 && place < p0 + kTile) src[place - p0] = r;
    before += chunk;
    __syncthreads();  // warp_live is read before it is rewritten
  }
  __syncthreads();

  const int col = p0 + lane;
  const int r = src[lane];
  const bool in_first = r >= 0 && r < first.count;
  const Segment& s = in_first ? first : second;
  const int i = in_first ? r : r - first.count;
  const T* row = r >= 0 ? static_cast<const T*>(s.rows) + (long long)i * d
                        : nullptr;
  for (int k = warp; k < kTile; k += kThreads / 32) {
    const int dim = blockIdx.y * kTile + k;
    if (dim >= d || col >= ldt) continue;
    const O v = row != nullptr ? out_of(row[dim], table_t) : O(0.f);
    table_t[(long long)dim * ldt + col] = v;
    if (rows_out != nullptr && row != nullptr)
      rows_out[(long long)col * d + dim] = v;
  }
  if (blockIdx.y == 0 && warp == 0 && r >= 0) ids[col] = seg_id(s, i);
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) *count = total;
}

}  // namespace

// a, b: the segments' rows ([ca, d], [cb, d]; f32 when is_bf16 == 0, else
// bf16); a_ids NULL for 0..ca-1; a_mask NULL for live where a_ids >= 0; b
// NULL (cb = 0) for one segment, else b_ids and b_mask given; use_packed:
// the device flag choosing B (non-zero) or A, or NULL (A).  table_t: [d,
// ldt] f32, ldt >= ca + cb; ids: [ca + cb]; count: [1].  Every output
// element is written.
extern "C" int rc_live_rows(const void* a, const int* a_ids,
                            const int* a_mask, int ca, const void* b,
                            const int* b_ids, const int* b_mask, int cb,
                            const int* use_packed, int d, int is_bf16,
                            float* table_t, int ldt, int* ids, int* count,
                            void* stream) {
  if (ca <= 0 || d <= 0 || ldt < ca + cb || cb < 0 ||
      (a_ids == nullptr && a_mask == nullptr) ||
      (cb > 0 && (b == nullptr || b_ids == nullptr || b_mask == nullptr)))
    return cudaErrorInvalidValue;
  const Segment sa{a, a_ids, a_mask, ca};
  const Segment sb{b, b_ids, b_mask, cb};
  const dim3 grid((unsigned)((ldt + kTile - 1) / kTile),
                  (unsigned)((d + kTile - 1) / kTile));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    live_rows_kernel<__nv_bfloat16, float><<<grid, kThreads, 0, st>>>(
        sa, sb, use_packed, d, table_t, ldt, nullptr, ids, count);
  else
    live_rows_kernel<float, float><<<grid, kThreads, 0, st>>>(
        sa, sb, use_packed, d, table_t, ldt, nullptr, ids, count);
  return cudaGetLastError();
}

// The bf16 form: bf16 segments, the live rows first as above into rows
// [ca + cb, d] and, transposed, into rows_t [d, ldt] (ldt >= ca + cb,
// columns past ca + cb zero), both bf16 and bit-equal to the rows; ids and
// count as rc_live_rows writes them.
extern "C" int rc_live_rows_bf16(const void* a, const int* a_ids,
                                 const int* a_mask, int ca, const void* b,
                                 const int* b_ids, const int* b_mask, int cb,
                                 const int* use_packed, int d, void* rows,
                                 void* rows_t, int ldt, int* ids, int* count,
                                 void* stream) {
  if (ca <= 0 || d <= 0 || ldt < ca + cb || cb < 0 || rows == nullptr ||
      (a_ids == nullptr && a_mask == nullptr) ||
      (cb > 0 && (b == nullptr || b_ids == nullptr || b_mask == nullptr)))
    return cudaErrorInvalidValue;
  const Segment sa{a, a_ids, a_mask, ca};
  const Segment sb{b, b_ids, b_mask, cb};
  const dim3 grid((unsigned)((ldt + kTile - 1) / kTile),
                  (unsigned)((d + kTile - 1) / kTile));
  live_rows_kernel<__nv_bfloat16, __nv_bfloat16>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          sa, sb, use_packed, d, static_cast<__nv_bfloat16*>(rows_t), ldt,
          static_cast<__nv_bfloat16*>(rows), ids, count);
  return cudaGetLastError();
}
