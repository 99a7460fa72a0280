// Fused pixel-text InfoNCE cross-entropy past 4 label slots, bf16, on the
// tensor cores: one pass over all 16 slots and every contrast member.
//
// Replaces rangeclip_tpu/ops/pallas/pixel_text_ce.py: _fwd_kernel (:96) and
// _bwd_kernel (:124) with [S, N] label slots (_as_slots, :274) at S = 16:
// the MiT step's field at H/4, upsampled x4, gives each pixel row 16 slots
// (the wrapper pads 5-15 with weightless slots).  The formulas are
// pixel_text_ce.cu's (its lines 4-16): per row, with w_s scaled by the
// upstream gradient in the backward and W = sum_s w_s,
//   ce    = W * lse - sum_s w_s * logit[l_s]
//   delta = e_c * W / Z - sum_s [id_c == l_s] w_s    (rounded to bf16 once)
//   d_emb = (delta . table) / tau,  dx = rs * (d_emb - emb * (emb . d_emb))
//   dtau  = sum_s w_s logit[l_s] - W * (sum_c e_c logit_c) / Z.
//
// Operands: the members of the table the device flag selects (the packed
// one where *use_packed != 0, else the full one), gathered on the device
// first and in table order as bf16 rows [rows, d] and their transpose [d,
// ldt] (live_rows.cu, rc_live_rows_bf16: no host sync), with their global
// ids and a device count.  The kernels read *count and run ceil(count /
// 128) class tiles; with no member the backward scores every row of the
// selected table at -1e30, as the plain version does.
//
// Bound on the card: bytes (the field read once, d samples written once,
// the labels and weights and the members read once; 0.0652 ms at the MiT
// step's N = 65,536, D = 512, 138 members); the products, 2 N D count
// FLOP forward and twice that backward, take 0.01 ms at the tensor cores'
// bf16 rate.  What the design does:
//
// Forward (ce_slots_fwd_kernel): pixel_text_ce.cu's tensor-core block
// (ce_tc.cuh: two consumer warpgroups of 64 rows, the A tile of bf16(x *
// rs) with the f64 row scale rounded once, wgmma m64n128k16 logits summed
// step by step in f32, a producer warpgroup streaming the gathered members
// through the four-stage TMA ring).  Per row an online max and sum-exp
// across the member tiles, seeded as the member-only kernels seed it (m =
// -1e30, z = C - count: the non-members' exp terms, which vanish at the
// first tile's rescale), and the 16 slots' picks: the column whose
// gathered id equals the slot's label.  A label of a non-member row of the
// selected table picks -1e30 for each such row; a label outside picks 0.
// Writes each row's CE and its max and sum-exp ([2, n] stats).
//
// Backward, two launches of one entry point.  The delta pass
// (ce_slots_delta_kernel) is the forward's block again: the logits, then
// e = exp(logit - m) from the forward's statistics, delta over all 16
// slots rounded to bf16 once (where the plain version rounds it) into a
// device workspace [n, ldd] (the members span up to C / 128 tiles, more
// than registers or shared memory beside the A tile hold), dtau, the row
// scales and each slot's coefficient of a non-member label's row (its
// delta: minus the weights of the slots with that label, rounded to bf16,
// kept at the label's first slot).  The product pass
// (ce_slots_demb_kernel) computes d_emb = delta [128 rows, count] x
// members [count, d] on the tensor cores, delta and the transposed members
// both streamed through the ring by TMA (128 rows x 64 classes a chunk),
// per 128-dim chunk of d_emb; adds the non-member rows' terms; and runs the
// normalisation VJP, whose proj = emb . d_emb spans all of d, so the
// chunks run twice (pass 0 sums proj, pass 1 writes dx), as
// pixel_text_ce.cu's tensor-core backward does.  Two products, not three.
// Any n; d % 8 == 0 and d <= 1280 (the A tile beside the ring); count 0 to
// C.  Against the plain version the logits differ in summation order only
// (pixel_text_ce.cu's lines 62-67 say what that costs delta's rounding).

#include "ce_tc.cuh"

namespace {

using rc::kNegInf;
using rc::tc::kTcThreads;
using rc::tc::quad_max;
using rc::tc::quad_sum;
using rc::tc::TcBlock;
using rc::tc::tile_sims;

constexpr int kSlots = 16;
constexpr int kMaxDims = 1280;  // the A tile (64 rows) beside the ring
constexpr int kDeltaPitch = rc::tc::kTileN;  // ldd: whole class tiles

struct SlotParams {
  const __nv_bfloat16* x;  // [n, d] un-normalised
  const float* temperature;
  const float* coeff;      // backward: the upstream gradient of the sum
  const int* labels;       // [16, n]
  const float* valid;      // [16, n]
  long long n;
  int d;
  const int* ids;          // [rows] the gathered rows' global ids
  const int* count;        // [1] members (the selected table's, first)
  const int* mask;         // [c] the full table's membership
  int c;
  const int* pmask;        // [k] packed membership, or NULL
  const int* pids;         // [k] packed global ids
  int k;
  const int* use_packed;   // device flag (packed where non-zero), or NULL
  const __nv_bfloat16* table;   // [c, d] backward: non-member label rows
  const __nv_bfloat16* ptable;  // [k, d] or NULL
  float* ce;               // forward: [n]
  float* stats;            // [2, n]: written forward, read backward
  __nv_bfloat16* delta;    // backward workspace [n, ldd]
  int ldd;
  float* rs;               // backward workspace [n]: row scales
  float* coef;             // backward workspace [16, n]
  __nv_bfloat16* dx;       // backward: [n, d]
  float* dtau;             // backward: [n]
};

__device__ __forceinline__ bool selects_packed(const SlotParams& p) {
  return p.use_packed != nullptr && *p.use_packed != 0;
}

// Rows of the selected table with global id l that are not members.
__device__ __forceinline__ int nonmember_rows(const SlotParams& p,
                                              bool packed, int l) {
  if (!packed) return l >= 0 && l < p.c && __ldg(p.mask + l) == 0;
  int hits = 0;
  for (int q = 0; q < p.k; ++q)
    hits += __ldg(p.pids + q) == l && __ldg(p.pmask + q) == 0;
  return hits;
}

// The gathered ids of this thread's 32 columns of the class tile from c0:
// bit b of `has` (and id[b]) stands for column c0 + 8 (b / 2) + 2 (lane %
// 4) + b % 2, the columns of accumulator registers i with mask_bit(i) ==
// b; a column exists where it is < ncol.
__device__ __forceinline__ unsigned tile_ids(const int* __restrict__ ids,
                                             int c0, int ncol, int lane,
                                             int (&id)[32]) {
  unsigned has = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int col = c0 + (b >> 1) * 8 + ((lane & 3) << 1) + (b & 1);
    const bool ok = col < ncol;
    id[b] = __ldg(ids + (ok ? col : 0));
    has |= (unsigned)ok << b;
  }
  return has;
}

// Register i of row half h: column pair bit b (i = 4 (b / 2) + 2 h + b % 2).
__device__ __forceinline__ constexpr int reg_of(int b, int h) {
  return (b >> 1) * 4 + 2 * h + (b & 1);
}

// The label and weight of slot s of a row (rows past n: none).
__device__ __forceinline__ int slot_label(const SlotParams& p, int s,
                                          long long row) {
  return row < p.n ? __ldg(p.labels + s * p.n + row) : INT_MIN;
}
__device__ __forceinline__ float slot_weight(const SlotParams& p, int s,
                                             long long row) {
  return row < p.n ? __ldg(p.valid + s * p.n + row) : 0.f;
}

// Forward: per member tile the logits, the online max / sum-exp and the
// picks of the 16 slots (each weighted as it is found); then the picks of
// non-member labels, shared by the quad's lanes, and the CE.
__global__ void __launch_bounds__(kTcThreads, 1)
    ce_slots_fwd_kernel(const __grid_constant__ CUtensorMap members,
                        const SlotParams p) {
  using namespace rc::tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcBlock blk;
  blk.init(smem_raw, p.d, 0);
  const int count = __ldg(p.count);
  if (blk.producer()) {
    if ((int)threadIdx.x == blk.nthreads)
      blk.ring.produce(&members, count, blk.k16);
    return;
  }
  normalized_rows(blk.smem, blk.a, blk.a_block_bytes, blk.rows, p.x, p.n,
                  p.d, blk.row0, blk.nthreads, nullptr);
  const bool packed = selects_packed(p);
  const int total = packed ? p.k : p.c;
  const float inv_temp = 1.0f / *p.temperature;
  float m_run[2] = {kNegInf, kNegInf};
  float z[2] = {(float)(total - count), (float)(total - count)};
  float wpick[2] = {0.f, 0.f};  // this lane's columns' weighted picks
  int chunk = 0;
  for (int c0 = 0; c0 < count; c0 += kTileN) {
    int id[32];
    const unsigned has = tile_ids(p.ids, c0, count, blk.lane, id);
    float acc[64];
    tile_sims(blk.ring, blk.a_rows(), blk.a_block_bytes, blk.k16, blk.wg_tid,
              chunk, acc);
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = (has >> mask_bit(i)) & 1u ? acc[i] * inv_temp : -CUDART_INF_F;
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], acc[i]);
    }
    float m_new[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m_run[h], quad_max(mt[h]));
#pragma unroll
    for (int i = 0; i < 64; ++i)
      ps[(i >> 1) & 1] += expf(acc[i] - m_new[(i >> 1) & 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float scale = expf(m_run[h] - m_new[h]);  // 0 on the first tile
      z[h] = __fadd_rn(__fmul_rn(z[h], scale), quad_sum(ps[h]));
      m_run[h] = m_new[h];
    }
#pragma unroll 1
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = slot_label(p, s, blk.row[h]);
        const float w = slot_weight(p, s, blk.row[h]);
#pragma unroll
        for (int b = 0; b < 32; ++b)
          if (((has >> b) & 1u) && id[b] == l)
            wpick[h] = __fadd_rn(wpick[h], __fmul_rn(w, acc[reg_of(b, h)]));
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = blk.row[h];
    // a label's non-member rows pick -1e30 each: slots s = lane % 4 + 4 j
    for (int s = blk.lane & 3; s < kSlots; s += 4) {
      const int hits = nonmember_rows(p, packed, slot_label(p, s, row));
      float pk = 0.f;
      for (int j = 0; j < hits; ++j) pk = __fadd_rn(pk, kNegInf);
      wpick[h] = __fadd_rn(wpick[h], __fmul_rn(slot_weight(p, s, row), pk));
    }
    const float wp = quad_sum(wpick[h]);
    float wsum = 0.f;
    for (int s = 0; s < kSlots; ++s)
      wsum = __fadd_rn(wsum, slot_weight(p, s, row));
    const float lse = m_run[h] + logf(z[h]);
    if ((blk.lane & 3) == 0 && row < p.n) {
      p.ce[row] = __fsub_rn(__fmul_rn(wsum, lse), wp);
      p.stats[row] = m_run[h];
      p.stats[p.n + row] = z[h];
    }
  }
}

// Backward, the delta pass: the logits again, tile by tile over the scored
// columns (the members; with none, every row of the selected table at
// -1e30); delta into the workspace; then per row the non-member labels'
// coefficients and picks, dtau and the row scale.
__global__ void __launch_bounds__(kTcThreads, 1)
    ce_slots_delta_kernel(const __grid_constant__ CUtensorMap members,
                          const SlotParams p) {
  using namespace rc::tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcBlock blk;
  blk.init(smem_raw, p.d, 0);
  const int count = __ldg(p.count);
  const bool packed = selects_packed(p);
  const int total = packed ? p.k : p.c;
  const int ncol = count > 0 ? count : total;
  if (blk.producer()) {
    if ((int)threadIdx.x == blk.nthreads)
      blk.ring.produce(&members, ncol, blk.k16);
    return;
  }
  float* rs_tile = reinterpret_cast<float*>(blk.extra());
  normalized_rows(blk.smem, blk.a, blk.a_block_bytes, blk.rows, p.x, p.n,
                  p.d, blk.row0, blk.nthreads, rs_tile);
  for (int r = threadIdx.x; r < blk.rows; r += blk.nthreads)
    if (blk.row0 + r < p.n) p.rs[blk.row0 + r] = rs_tile[r];

  const float inv_temp = 1.0f / *p.temperature;
  const float coeff = *p.coeff;
  float m[2], inv_z[2], wsum[2], f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = blk.row[h];
    m[h] = row < p.n ? p.stats[row] : 0.f;
    inv_z[h] = row < p.n ? 1.0f / p.stats[p.n + row] : 0.f;
    wsum[h] = 0.f;
    for (int s = 0; s < kSlots; ++s)
      wsum[h] = __fadd_rn(wsum[h],
                          __fmul_rn(coeff, slot_weight(p, s, row)));
    f[h] = __fmul_rn(wsum[h], inv_z[h]);
  }
  float t_el[2] = {0.f, 0.f}, wpick[2] = {0.f, 0.f};
  int chunk = 0;
  for (int c0 = 0; c0 < ncol; c0 += kTileN) {
    int id[32];
    const unsigned has = tile_ids(p.ids, c0, ncol, blk.lane, id);
    float acc[64];
    tile_sims(blk.ring, blk.a_rows(), blk.a_block_bytes, blk.k16, blk.wg_tid,
              chunk, acc);
    // acc becomes the logits: the members' products over tau, -1e30 past
    // the count (no member: the selected table's rows), 0 past ncol
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = c0 + frag_col(i, blk.lane);
      acc[i] = !((has >> mask_bit(i)) & 1u) ? 0.f
               : col < count                ? acc[i] * inv_temp
                                            : kNegInf;
    }
    // the slots' picks, weighted
#pragma unroll 1
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = slot_label(p, s, blk.row[h]);
        const float w = __fmul_rn(coeff, slot_weight(p, s, blk.row[h]));
#pragma unroll
        for (int b = 0; b < 32; ++b)
          if (((has >> b) & 1u) && id[b] == l)
            wpick[h] = __fadd_rn(wpick[h], __fmul_rn(w, acc[reg_of(b, h)]));
      }
    }
    // acc becomes e * W / Z, and the row sums of e * logit
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i >> 1) & 1;
      if (!((has >> mask_bit(i)) & 1u)) continue;
      const float e = expf(acc[i] - m[h]);
      t_el[h] = __fadd_rn(t_el[h], __fmul_rn(e, acc[i]));
      acc[i] = __fmul_rn(e, f[h]);
    }
    // minus the weights of the slots whose label is the column's, in slot
    // order, as the plain version subtracts them
#pragma unroll 1
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = slot_label(p, s, blk.row[h]);
        const float w = __fmul_rn(coeff, slot_weight(p, s, blk.row[h]));
#pragma unroll
        for (int b = 0; b < 32; ++b)
          if (((has >> b) & 1u) && id[b] == l)
            acc[reg_of(b, h)] = __fsub_rn(acc[reg_of(b, h)], w);
      }
    }
    // delta rounded to bf16 once, in pairs of adjacent classes
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const long long row = blk.row[(i >> 1) & 1];
      const int col = c0 + frag_col(i, blk.lane);
      if (row < p.n && col < p.ldd)
        *reinterpret_cast<uint32_t*>(p.delta + row * p.ldd + col) =
            pack_bf16x2(acc[i], acc[i + 1]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = blk.row[h];
    // each valid label's non-member rows (with members only: with none,
    // they were scored) pick -1e30 and get delta = minus the weights of
    // the slots with that label, kept at its first slot: slots s = lane %
    // 4 + 4 j of the quad's row
    for (int s = blk.lane & 3; s < kSlots; s += 4) {
      const int l = slot_label(p, s, row);
      const int hits = count > 0 ? nonmember_rows(p, packed, l) : 0;
      float pk = 0.f, cf = 0.f;
      bool first = true;
      for (int s2 = 0; s2 < kSlots; ++s2) {
        if (slot_label(p, s2, row) != l) continue;
        if (s2 < s) first = false;
        if (s2 >= s)
          cf = __fsub_rn(cf, __fmul_rn(coeff, slot_weight(p, s2, row)));
      }
      for (int j = 0; j < hits; ++j) pk = __fadd_rn(pk, kNegInf);
      wpick[h] = __fadd_rn(
          wpick[h], __fmul_rn(__fmul_rn(coeff, slot_weight(p, s, row)), pk));
      if (row < p.n)
        p.coef[s * p.n + row] =
            hits > 0 && first ? __bfloat162float(__float2bfloat16_rn(cf))
                              : 0.f;
    }
    const float wp = quad_sum(wpick[h]);
    const float tel = quad_sum(t_el[h]);
    if ((blk.lane & 3) == 0 && row < p.n)
      p.dtau[row] =
          __fsub_rn(wp, __fmul_rn(wsum[h], __fmul_rn(tel, inv_z[h])));
  }
}

// Backward, the product pass: a block of 128 rows (two consumer warpgroups
// of 64) and a producer warpgroup; no A tile: delta's chunk [128 rows, 64
// classes] and the transposed members' [128 dims, 64 classes] come through
// the ring in turn, per (pass, 128-dim chunk, 64-class block).
__global__ void __launch_bounds__(kTcThreads, 1)
    ce_slots_demb_kernel(const __grid_constant__ CUtensorMap delta_map,
                         const __grid_constant__ CUtensorMap members_t,
                         const SlotParams p) {
  using namespace rc::tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcBlock blk;
  blk.init(smem_raw, 0, 0);  // the ring alone
  const int d = p.d;
  const int count = __ldg(p.count);
  const bool packed = selects_packed(p);
  const int ncol = count > 0 ? count : (packed ? p.k : p.c);
  const int cblocks = (ncol + kBlockDims - 1) / kBlockDims;
  const int dchunks = (d + kTileN - 1) / kTileN;
  if (blk.producer()) {
    if ((int)threadIdx.x != blk.nthreads) return;
    const Ring& ring = blk.ring;
    int i = 0;
    auto push = [&](const CUtensorMap* map, int k0, long long r0) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(ring.empty(s), ((i / kStages) - 1) & 1);
      mbar_expect_tx(ring.full(s), kChunkBytes);
      tma_load(ring.stage(s), map, k0, (int)r0, ring.full(s));
      ++i;
    };
    for (int pass = 0; pass < 2; ++pass)
      for (int dc = 0; dc < dchunks; ++dc)
        for (int cb = 0; cb < cblocks; ++cb) {
          push(&delta_map, cb * kBlockDims, blk.row0);
          push(&members_t, cb * kBlockDims, dc * kTileN);
        }
    return;
  }
  const float inv_temp = 1.0f / *p.temperature;
  float rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rs[h] = blk.row[h] < p.n ? p.rs[blk.row[h]] : 0.f;
  // the rows with a non-member label's coefficient (rare), found once:
  // the epilogues then skip the others without a load
  bool nonmember[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    nonmember[h] = false;
    if (blk.row[h] < p.n)
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        nonmember[h] |= __ldg(p.coef + s * p.n + blk.row[h]) != 0.f;
  }
  const uint32_t a_off = blk.wg * kWarpRows * kRowBytes;  // this half's rows
  float proj[2] = {0.f, 0.f};
  int i = 0, released = 0;  // the ring's next chunk; chunks given back
  for (int pass = 0; pass < 2; ++pass) {
    for (int dc = 0; dc < dchunks; ++dc) {
      float dacc[64];
      for (int cb = 0; cb < cblocks; ++cb) {
        const int sa = i % kStages, sb = (i + 1) % kStages;
        mbar_wait(blk.ring.full(sa), (i / kStages) & 1);
        mbar_wait(blk.ring.full(sb), ((i + 1) / kStages) & 1);
        fence_regs(dacc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_m64n128k16(dacc,
                           sw128_desc(blk.ring.stage(sa) + a_off + k * 32),
                           sw128_desc(blk.ring.stage(sb) + k * 32),
                           cb > 0 || k > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        for (; released < i; ++released)
          if (blk.wg_tid == 0) mbar_arrive(blk.ring.empty(released % kStages));
        i += 2;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      for (; released < i; ++released)
        if (blk.wg_tid == 0) mbar_arrive(blk.ring.empty(released % kStages));
      fence_regs(dacc);
      // a non-member label's rows of the selected table, times its
      // coefficient (rare: a valid label outside the contrast set)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = blk.row[h];
        if (!nonmember[h]) continue;
#pragma unroll 1
        for (int s = 0; s < kSlots; ++s) {
          const float cf = __ldg(p.coef + s * p.n + row);
          if (cf == 0.f) continue;
          const int l = slot_label(p, s, row);
          // the selected table's rows with id l that are not members
          for (int q = 0; q < (packed ? p.k : 1); ++q) {
            const __nv_bfloat16* t_row = nullptr;
            if (packed) {
              if (__ldg(p.pids + q) == l && __ldg(p.pmask + q) == 0)
                t_row = p.ptable + (long long)q * d;
            } else if (l >= 0 && l < p.c && __ldg(p.mask + l) == 0) {
              t_row = p.table + (long long)l * d;
            }
            if (t_row == nullptr) continue;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int i0 = 4 * j + 2 * h;
              const int dim = dc * kTileN + frag_col(i0, blk.lane);
              if (dim >= d) continue;
              const __nv_bfloat162 t =
                  *reinterpret_cast<const __nv_bfloat162*>(t_row + dim);
              dacc[i0] = __fadd_rn(dacc[i0], __fmul_rn(cf, __low2float(t)));
              dacc[i0 + 1] =
                  __fadd_rn(dacc[i0 + 1], __fmul_rn(cf, __high2float(t)));
            }
          }
        }
      }
      // pass 0 sums proj = emb . d_emb, pass 1 writes dx
#pragma unroll
      for (int q = 0; q < 64; q += 2) {
        const int h = (q >> 1) & 1;
        const long long row = blk.row[h];
        const int dim = dc * kTileN + frag_col(q, blk.lane);
        if (row >= p.n || dim >= d) continue;
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(p.x + row * d + dim);
        const float e0 = __fmul_rn(__low2float(xv), rs[h]);
        const float e1 = __fmul_rn(__high2float(xv), rs[h]);
        const float d0 = __fmul_rn(dacc[q], inv_temp);
        const float d1 = __fmul_rn(dacc[q + 1], inv_temp);
        if (pass == 0) {
          proj[h] = __fadd_rn(proj[h], __fmul_rn(e0, d0));
          proj[h] = __fadd_rn(proj[h], __fmul_rn(e1, d1));
        } else {
          *reinterpret_cast<uint32_t*>(p.dx + row * d + dim) = pack_bf16x2(
              __fmul_rn(rs[h], __fsub_rn(d0, __fmul_rn(e0, proj[h]))),
              __fmul_rn(rs[h], __fsub_rn(d1, __fmul_rn(e1, proj[h]))));
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) proj[h] = quad_sum(proj[h]);
    }
  }
}

constexpr int kRsBytes = sizeof(float);  // the delta pass's rs per row

// The forward's or the delta pass's block over the gathered members.
template <typename Kernel>
cudaError_t launch_scoring(Kernel kernel, const SlotParams& p,
                           const void* members, int rows, int row_extra,
                           cudaStream_t stream) {
  const int k16 = (p.d + 15) / 16;
  const int wgs = rc::tc::warpgroups_for(k16, row_extra);
  if (wgs == 0) return cudaErrorInvalidValue;
  const int block_rows = wgs * rc::tc::kWarpRows;
  const size_t smem = rc::tc::smem_bytes(block_rows, k16, row_extra);
  CUtensorMap map;
  cudaError_t err = rc::tc::make_tensor_map(&map, members, rows, p.d);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.n + block_rows - 1) / block_rows));
  kernel<<<grid, wgs * 128 + 128, smem, stream>>>(map, p);
  return cudaGetLastError();
}

bool shape_ok(const SlotParams& p, int rows) {
  return p.d % 8 == 0 && p.d > 0 && p.d <= kMaxDims && p.n > 0 &&
         rows > 0 && p.c > 0 &&
         (p.use_packed == nullptr || (p.pmask != nullptr &&
                                      p.pids != nullptr && p.k > 0));
}

}  // namespace

// The forward.  x: [n, d] bf16, un-normalised, 16-byte aligned, d % 8 ==
// 0, d <= 1280; temperature [1] f32; labels [16, n] int32, valid [16, n]
// f32; members [rows, d] bf16 and ids [rows]: the gathered rows, the
// selected table's members first (rc_live_rows_bf16), *count of them
// (device memory); mask [c]: the full table's membership; pmask, pids [k]:
// the packed table's (NULL without use_packed, the device flag choosing
// the packed table where it is non-zero).  ce: [n] f32; stats: [2, n] f32,
// each row's max logit and sum-exp.
extern "C" int rc_pixel_text_ce_slots_fwd(
    const void* x, const float* temperature, const int* labels,
    const float* valid, long long n, int d, const void* members,
    const int* ids, const int* count, int rows, const int* mask, int c,
    const int* pmask, const int* pids, int k, const int* use_packed,
    float* ce, float* stats, void* stream) {
  SlotParams p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.temperature = temperature;
  p.labels = labels;
  p.valid = valid;
  p.n = n;
  p.d = d;
  p.ids = ids;
  p.count = count;
  p.mask = mask;
  p.c = c;
  p.pmask = pmask;
  p.pids = pids;
  p.k = k;
  p.use_packed = use_packed;
  p.ce = ce;
  p.stats = stats;
  if (!shape_ok(p, rows) || stats == nullptr) return cudaErrorInvalidValue;
  return launch_scoring(ce_slots_fwd_kernel, p, members, rows, 0,
                        static_cast<cudaStream_t>(stream));
}

// The backward: the forward's operands, plus coeff [1] f32 (the upstream
// gradient of the summed CE); members_t [d, ldt] bf16 (the gathered rows
// transposed, ldt % 8 == 0, zero past the rows); table [c, d] and ptable
// [k, d] (or NULL) bf16, 16-byte aligned, whose non-member rows a label may
// name; stats: the forward's.  Workspaces: delta [n, ldd] bf16 with ldd %
// 128 == 0 and ldd >= rows, rs [n] f32, coef [16, n] f32.  dx: [n, d]
// bf16; dtau: [n] f32 per-row d log tau.  Two launches.
extern "C" int rc_pixel_text_ce_slots_bwd(
    const void* x, const float* temperature, const float* coeff,
    const int* labels, const float* valid, long long n, int d,
    const void* members, const void* members_t, int ldt, const int* ids,
    const int* count, int rows, const void* table, const int* mask, int c,
    const void* ptable, const int* pmask, const int* pids, int k,
    const int* use_packed, const float* stats, void* delta, int ldd,
    float* rs, float* coef, void* dx, float* dtau, void* stream) {
  SlotParams p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.temperature = temperature;
  p.coeff = coeff;
  p.labels = labels;
  p.valid = valid;
  p.n = n;
  p.d = d;
  p.ids = ids;
  p.count = count;
  p.mask = mask;
  p.c = c;
  p.pmask = pmask;
  p.pids = pids;
  p.k = k;
  p.use_packed = use_packed;
  p.table = static_cast<const __nv_bfloat16*>(table);
  p.ptable = static_cast<const __nv_bfloat16*>(ptable);
  p.stats = const_cast<float*>(stats);
  p.delta = static_cast<__nv_bfloat16*>(delta);
  p.ldd = ldd;
  p.rs = rs;
  p.coef = coef;
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.dtau = dtau;
  if (!shape_ok(p, rows) || stats == nullptr || table == nullptr ||
      (use_packed != nullptr && ptable == nullptr) || ldt < rows ||
      ldt % 8 != 0 || ldd < rows || ldd % kDeltaPitch != 0 ||
      delta == nullptr || rs == nullptr || coef == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      launch_scoring(ce_slots_delta_kernel, p, members, rows, kRsBytes, st);
  if (err != cudaSuccess) return err;
  CUtensorMap delta_map, t_map;
  err = rc::tc::make_tensor_map(&delta_map, delta, (int)n, ldd);
  if (err != cudaSuccess) return err;
  err = rc::tc::make_tensor_map(&t_map, members_t, d, ldt);
  if (err != cudaSuccess) return err;
  const size_t smem = rc::tc::smem_bytes(0, 0);
  err = cudaFuncSetAttribute(ce_slots_demb_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int kRows = rc::tc::kMaxWarpgroups * rc::tc::kWarpRows;
  ce_slots_demb_kernel<<<(unsigned)((n + kRows - 1) / kRows), kTcThreads,
                         smem, st>>>(delta_map, t_map, p);
  return cudaGetLastError();
}
