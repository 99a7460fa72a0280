// Fused pixel-text InfoNCE cross-entropy, forward and backward.
//
// Replaces rangeclip_tpu/ops/pallas/pixel_text_ce.py: _fwd_kernel and
// _bwd_kernel, entry point fused_pixel_text_ce.  Per pixel row i with label
// slots (l_s, w_s), s < S:
//   emb   = x * rs, rs = 1/sqrt(max(sum x^2, 1e-24))   (f32)
//   logit = mask_c ? (round_T(emb) . table_c) * (1/tau) : -1e30
//   ce_i  = W * lse - sum_s w_s * logit[l_s]         W = sum_s w_s
// where logit[l] is the row's logit at the class whose id is l (0 when no
// class has it), ids being the global class ids of the table rows (packed
// form) or 0..C-1.  The backward recomputes the logits and writes
//   delta_c = e_c * (W / Z) - sum_s [id_c == l_s] w_s   (rounded to T)
//   d_emb   = (delta . table) * (1/tau)
//   dx      = rs * (d_emb - emb * (emb . d_emb))        (rounded to x's T)
//   dtau_i  = sum_s w_s logit[l_s] - W * (sum_c e_c logit_c) / Z
// with w_s scaled by the upstream gradient; the caller sums dtau / tau.
// The sum of squares is taken in f64 and 1/sqrt rounded once to f32, as in
// pixel_text_topk.cu, so kernel and plain version round every pixel alike.
//
// Packed or full table, chosen on the device: when ``use_packed`` points to
// a non-zero int the kernel scores the gathered [K, D] member table (ids =
// the members' global ids); otherwise the full [C, D] table.  The caller
// computes the flag (n_contrast <= K) on the device, so no host sync.
//
// Bound on the card: the forward does 2 N K D FLOP (68.7 GFLOP packed at
// N = 524,288, K = 128, D = 512) against N (D * sizeof(T) + 8 S + 4) bytes
// (0.54 GB): bytes at the tensor cores' bf16 rate (0.07 ms of products
// against 0.16 ms of reads), operations on the CUDA cores, counted over
// the members (2 N D count FLOP: 0.18 ms at N = 131,072, D = 512 and 90
// members in f32).  The backward does twice the products and writes dx
// too.  The [N, C] logits never touch device memory.
//
// Two designs, chosen by shape on the host and by the device flag:
//
// bf16 with a packed table, d <= 1280 and k <= 128 (the forward kernel
// takes any k): tensor cores (ce_tc_fwd_kernel, ce_tc_bwd_kernel).  A
// block of one or two consumer warpgroups owns 64 pixel rows each, and a
// producer warpgroup streams the table through a four-stage TMA ring
// (common.cuh: tc::); it hands its registers to the consumers (setmaxnreg:
// 232 each), and nothing spills.
//   1. The rows are copied once into shared memory in wgmma's swizzled A
//      layout, their f64 scale taken from that copy and the tile rewritten
//      as bf16(x * rs) in place (common.cuh: tc::normalized_rows).
//   2. Logits: wgmma m64n128k16 over the packed [k, d] table into 64 f32
//      registers per thread (two rows x 32 classes), summed step by step
//      (tile_sims); the epilogue runs on the fragment: masked members at
//      -1e30, an online max / sum-exp across class tiles reduced over the
//      quad by shuffles, and the slot picks (the column whose packed id
//      equals the label).
//   3. Backward: the row statistics, dtau and delta in registers; delta,
//      rounded to bf16, goes to the warpgroup's own rows of the A tile,
//      which the logits are done with, as the A operand of the second
//      product, d_emb = delta [64, k] x table [k, d], against the
//      transposed table [d, k8] (a copy the wrapper makes per call) in
//      128-dim chunks through the same ring.  The normalisation VJP needs
//      proj = emb . d_emb over all of d, so the chunks run twice: pass 0
//      sums proj, pass 1 writes dx.  emb = x * rs in f32 re-reads x (L2),
//      staged with dx through other free rows of the A tile.
// The kernels return at once unless *use_packed != 0; the member-only
// kernels, launched beside them with skip_packed, return at once otherwise.
//
// Against the plain version, whose logits are an f32 FMA chain over d in
// order, no other summation order agrees on every bf16 rounding of delta:
// even exactly rounded logits flip a label's delta in a few rows of a
// flagship-sized draw, and such a flip moves the row's dx by about the
// checks' bound (utils/ce_rounding.py measures it).  The CUDA-core kernels
// sum in the plain version's order.
//
// Everything else, f32 and bf16 without a tensor-core branch, and the
// tensor-core route's full-table branch (a contrast set over the
// capacity): the members only (member::).  A non-member's logit is -1e30
// and its exp term is exactly 0 in f32, so only the members' logits are
// needed: the wrapper gathers the members of the table the device flag
// selects on the device (live_rows.cu, no host sync), first and transposed
// to [D, Cp] f32 with their global ids and a device count, and the kernels
// run ceil(count / 128) class tiles of pixel_text_topk.cu's fp32 loop
// (common.cuh: rc::simt::score_tiles: 128 rows x 128 classes a block, a
// three-stage cp.async ring of 32-dim chunks, two blocks per SM; the f32
// scale moves past the sum, bf16 rounds bf16(x * rs) on the landed chunk,
// so each bf16 logit is one f32 FMA chain over d in order).  Epilogues run
// on the accumulators, per row and class half reduced over a quarter warp
// by shuffles, with the row's state in shared memory.  What the full table
// gave and a member-only product must keep: the C - count non-member terms
// of the sum-exp seed the forward's online state (m = -1e30, z = C -
// count), so they vanish at the first member tile's rescale as in f32 and
// no member gives -1e30 + log C; a label of a non-member in [0, C) picks
// its -1e30 (mask[label] read per slot), a label outside picks 0.
//
// The member-only backward (ce_members_bwd_kernel) is bound by its two
// products over the members, 4 N D count FLOP on the CUDA cores (0.36 ms
// at N = 131,072, D = 512 and 90 members).  The forward's row max and
// sum-exp are its second output (stats), so the backward runs the logits
// once, however many class tiles the members span, where recomputing the
// statistics would cost one more product over the members.  Per block of
// 128 pixel rows:
//   1. The logits again, tile by tile, delta rounded to T into a
//      class-major [count, 128] f32 slice of a device workspace, and per
//      row sum_c e_c logit_c and the picks.
//   2. Per row, a valid label of a non-member in [0, C) (its table row is
//      not gathered): delta = -w at that class, so that row of the
//      selected table is added to d_emb times -w in step 3, and -1e30 w to
//      dtau, as the plain version does.  Then dtau.
//   3. d_emb = delta x table / tau in 128-dim tiles on the same loop with
//      the roles swapped: the gathered [D, Cp] table is the loop's "field"
//      (dims as rows, members along k) and the delta slice its "table" (k
//      = members, columns = the block's pixel rows), so no second gather
//      is needed.  Each tile's sums go through shared memory (the ring is
//      free after the tile's last step) to rows of d_emb in the workspace
//      ([128, D] f32 a block), 128 dims at a time with x read alongside for
//      proj = emb . d_emb, summed over dims as the plain version sums it.
//      (Taken in class space, sum_c delta_c sim_c / tau, proj would need
//      no d_emb tile, but in bf16 its sims come from bf16(emb): 0.88 of the
//      bf16 check's bound at D = 64, against 1e-4 from f32 sims.)
//   4. dx = rs * (d_emb - emb * proj), the block's d_emb rows read back.
// The workspace slices ((ldt + D) x 128 f32 each) bound the grid: at most
// two blocks per SM, each walking its row tiles.  The d_emb rows cross L2
// twice, device memory at worst (0.16 ms at N = 131,072, D = 512).  With
// no member at all (count == 0) every row of the selected table is a
// column at -1e30, as in the plain version.  The tensor-core forward's
// statistics come from its own logits, not the FMA chain that delta's bf16
// rounding follows, so the tensor-core route is taken by both directions
// or by neither (bf16, a packed table of at most 128, D <= 1280).  The TPU
// kernel's class-major [C, TILE_N] layout and row-tile search are TPU
// work; here rows are the block's axis.  Any N; D % 8 == 0; S of 1-4 on
// the tensor cores, 1-4 or 16 on the member-only kernels (f32 past 4
// slots; bf16 past 4 slots takes pixel_text_ce_slots.cu in both
// directions).  The tensor-core block and its main loop are in ce_tc.cuh,
// shared with pixel_text_ce_slots.cu.

#include "ce_tc.cuh"

namespace {

using rc::tc::kTcThreads;
using rc::tc::quad_max;
using rc::tc::quad_sum;
using rc::tc::TcBlock;
using rc::tc::tile_sims;

// ---- bf16 packed table: tensor cores ---------------------------------------

constexpr int kMaxTcDims = 1280;  // A (64 rows) + the B ring within 227 KB
constexpr int kMaxTcBwdClasses = rc::tc::kTileN;  // delta: one class tile
// The backward's A tile spans at least 6 blocks: after the logits, a
// warpgroup's own rows of blocks 0-1 hold delta, 2-3 and 4-5 stage x and dx.
constexpr int kScratchBlocks = 6;

struct TcParams {
  const __nv_bfloat16* x;
  const float* temperature;
  const float* coeff;  // backward: the upstream gradient of the sum
  const int* labels;   // [S, n]
  const float* valid;  // [S, n]
  long long n;
  int d;
  const int* pmask;    // [k]
  const int* pids;     // [k] global ids
  int k;
  const int* use_packed;  // run only where it is non-zero (NULL: always)
  float* ce;              // forward: [n]
  __nv_bfloat16* dx;      // backward: [n, d]
  float* dtau;            // backward: [n]
  float* stats;           // forward: [2, n] row max and sum-exp, or NULL
};

// The label slots of the two rows a thread holds (rows past n: none).
template <int S>
struct RowSlots {
  int lab[2][S];
  float w[2][S];
  float wsum[2];

  __device__ __forceinline__ void load(const TcParams& p,
                                       const long long (&row)[2],
                                       float coeff, bool scaled) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = row[h] < p.n;
      wsum[h] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        lab[h][s] = live ? p.labels[s * p.n + row[h]] : INT_MIN;
        const float v = live ? p.valid[s * p.n + row[h]] : 0.f;
        w[h][s] = scaled ? __fmul_rn(coeff, v) : v;
        wsum[h] = __fadd_rn(wsum[h], w[h][s]);
      }
    }
  }
};

// This thread's 32 columns of the class tile from c0 as bit masks, bit b
// = mask_bit(i) for accumulator register i (as rc::tc::dead_mask):
// `exists` where the column is < k, `live` where it also is a member (mask
// != 0), match[h][s] where its packed id is the label of slot s of row h.
// Bit masks, not the 32 ids, keep the epilogue within its registers.
template <int S>
struct TileCols {
  unsigned exists, live;
  unsigned match[2][S];

  // kRound columns' ids and masks are loaded at a time.
  template <int kRound>
  __device__ __forceinline__ void load(const TcParams& p, int c0, int lane,
                                       const RowSlots<S>& sl) {
    exists = live = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < S; ++s) match[h][s] = 0;
#pragma unroll 1
    for (int b0 = 0; b0 < 32; b0 += kRound) {
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int b = b0 + q;
        const int col = c0 + (b >> 1) * 8 + ((lane & 3) << 1) + (b & 1);
        const int at = min(col, p.k - 1);
        const int id = __ldg(p.pids + at);
        const bool ok = col < p.k;
        exists |= (unsigned)ok << b;
        live |= (unsigned)(ok && __ldg(p.pmask + at) != 0) << b;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int s = 0; s < S; ++s)
            match[h][s] |= (unsigned)(ok && id == sl.lab[h][s]) << b;
      }
    }
  }

  __device__ __forceinline__ bool has(int i) const {
    return (exists >> rc::tc::mask_bit(i)) & 1u;
  }
  // The logit of accumulator register i: masked members score -1e30.
  __device__ __forceinline__ float logit(const float (&acc)[64], int i,
                                         float inv_temp) const {
    return (live >> rc::tc::mask_bit(i)) & 1u ? acc[i] * inv_temp
                                              : rc::kNegInf;
  }
  // Register i's column carries the label of slot s of its row.
  __device__ __forceinline__ bool picks(int i, int s) const {
    return (match[(i >> 1) & 1][s] >> rc::tc::mask_bit(i)) & 1u;
  }
};


// Forward: per class tile, the logits from the sums, an online max /
// sum-exp per row (quad shuffles) and the slot picks.
template <int S>
__global__ void __launch_bounds__(kTcThreads, 1)
    ce_tc_fwd_kernel(const __grid_constant__ CUtensorMap table_map,
                     const TcParams p) {
  using namespace rc::tc;
  if (p.use_packed != nullptr && *p.use_packed == 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcBlock blk;
  blk.init(smem_raw, p.d, 0);
  if (blk.producer()) {
    if ((int)threadIdx.x == blk.nthreads)
      blk.ring.produce(&table_map, p.k, blk.k16);
    return;
  }
  normalized_rows(blk.smem, blk.a, blk.a_block_bytes, blk.rows, p.x, p.n,
                  p.d, blk.row0, blk.nthreads, nullptr);

  RowSlots<S> sl;
  sl.load(p, blk.row, 1.f, false);
  const float inv_temp = 1.0f / *p.temperature;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, z[2] = {0.f, 0.f};
  float pick[2][S];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < S; ++s) pick[h][s] = 0.f;
  TileCols<S> cols;
  int chunk = 0;  // the ring's next chunk
  for (int c0 = 0; c0 < p.k; c0 += kTileN) {
    cols.template load<32>(p, c0, blk.lane, sl);
    float acc[64];
    tile_sims(blk.ring, blk.a_rows(), blk.a_block_bytes, blk.k16, blk.wg_tid,
              chunk, acc);
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (cols.has(i))
        mt[(i >> 1) & 1] =
            fmaxf(mt[(i >> 1) & 1], cols.logit(acc, i, inv_temp));
    float m_new[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m_run[h], quad_max(mt[h]));
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (!cols.has(i)) continue;
      const int h = (i >> 1) & 1;
      const float l = cols.logit(acc, i, inv_temp);
      ps[h] += expf(l - m_new[h]);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (cols.picks(i, s)) pick[h][s] += l;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float scale = expf(m_run[h] - m_new[h]);  // 0 on tile 0
      z[h] = __fadd_rn(__fmul_rn(z[h], scale), quad_sum(ps[h]));
      m_run[h] = m_new[h];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float wpick = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s)
      wpick = __fadd_rn(wpick, __fmul_rn(sl.w[h][s], quad_sum(pick[h][s])));
    const float lse = m_run[h] + logf(z[h]);
    if ((blk.lane & 3) == 0 && blk.row[h] < p.n) {
      p.ce[blk.row[h]] = __fsub_rn(__fmul_rn(sl.wsum[h], lse), wpick);
      if (p.stats != nullptr) {
        p.stats[blk.row[h]] = m_run[h];
        p.stats[p.n + blk.row[h]] = z[h];
      }
    }
  }
}

// Backward (k <= 128: one class tile).  The logits as in the forward, then
// the row statistics, dtau and delta in registers; delta, rounded to bf16,
// goes to the warpgroup's own rows of the A tile, which the logits no
// longer need ([64 rows, 128 classes] in the SW128 layout: dim blocks 0-1).
// Then d_emb = delta x table in 128-dim chunks, B the transposed table
// [d, k8] through the ring, twice: pass 0 sums proj = emb . d_emb, pass 1
// writes dx.
template <int S>
__global__ void __launch_bounds__(kTcThreads, 1)
    ce_tc_bwd_kernel(const __grid_constant__ CUtensorMap table_map,
                     const __grid_constant__ CUtensorMap table_t_map,
                     const TcParams p) {
  using namespace rc::tc;
  if (p.use_packed != nullptr && *p.use_packed == 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcBlock blk;
  blk.init(smem_raw, p.d, kScratchBlocks);
  const int d = p.d;
  const int dchunks = (d + kTileN - 1) / kTileN;  // 128-dim chunks of d_emb
  const int kc16 = (p.k + 15) / 16;               // 16-class steps
  const int cblocks = (kc16 + 3) / 4;             // 64-class blocks: 1 or 2
  if (blk.producer()) {
    if ((int)threadIdx.x != blk.nthreads) return;
    const Ring& ring = blk.ring;
    int i = 0;
    auto push = [&](const CUtensorMap* map, int k0, int r0) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(ring.empty(s), ((i / kStages) - 1) & 1);
      mbar_expect_tx(ring.full(s), kChunkBytes);
      tma_load(ring.stage(s), map, k0, r0, ring.full(s));
      ++i;
    };
    for (int kb = 0; kb < blk.blocks_k; ++kb)
      push(&table_map, kb * kBlockDims, 0);
    for (int pass = 0; pass < 2; ++pass)
      for (int dc = 0; dc < dchunks; ++dc)
        for (int cb = 0; cb < cblocks; ++cb)
          push(&table_t_map, cb * kBlockDims, dc * kTileN);
    return;
  }
  float* rs_tile = reinterpret_cast<float*>(blk.extra());
  normalized_rows(blk.smem, blk.a, blk.a_block_bytes, blk.rows, p.x, p.n, d,
                  blk.row0, blk.nthreads, rs_tile);

  int next = 0;  // the ring's next chunk
  float acc[64];
  tile_sims(blk.ring, blk.a_rows(), blk.a_block_bytes, blk.k16, blk.wg_tid,
            next, acc);
  // loaded after the sums, which hold 128 registers while they run
  float rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rs[h] = rs_tile[blk.wg * kWarpRows + frag_row(h, blk.wg_tid)];
  const float inv_temp = 1.0f / *p.temperature;
  {
    RowSlots<S> sl;
    sl.load(p, blk.row, *p.coeff, true);
    // in rounds of 8: all 32 columns' loads at once, beside the logits,
    // spilled registers
    TileCols<S> cols;
    cols.template load<8>(p, 0, blk.lane, sl);
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (cols.has(i))
        m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], cols.logit(acc, i, inv_temp));
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = quad_max(m[h]);
    float ps[2] = {0.f, 0.f}, pt[2] = {0.f, 0.f}, pick[2][S];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < S; ++s) pick[h][s] = 0.f;
    // acc[i] becomes e_i = exp(logit_i - m) (0 past k), which delta reads
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i >> 1) & 1;
      const float l = cols.logit(acc, i, inv_temp);
      const float e = cols.has(i) ? expf(l - m[h]) : 0.f;
      acc[i] = e;
      if (!cols.has(i)) continue;
      ps[h] += e;
      pt[h] = __fadd_rn(pt[h], __fmul_rn(e, l));
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (cols.picks(i, s)) pick[h][s] += l;
    }
    float f[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float wpick = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s)
        wpick = __fadd_rn(wpick, __fmul_rn(sl.w[h][s], quad_sum(pick[h][s])));
      const float inv_z = 1.0f / quad_sum(ps[h]);
      const float t_el = quad_sum(pt[h]);
      f[h] = __fmul_rn(sl.wsum[h], inv_z);
      if ((blk.lane & 3) == 0 && blk.row[h] < p.n)
        p.dtau[blk.row[h]] =
            __fsub_rn(wpick, __fmul_rn(sl.wsum[h], __fmul_rn(t_el, inv_z)));
    }
    // delta_c = e_c (W / Z) - sum_s [id_c == l_s] w_s, 0 past k, rounded
    // to bf16 in pairs of adjacent classes, into the A tile
    auto delta = [&](int i) {
      const int h = (i >> 1) & 1;
      if (!cols.has(i)) return 0.f;
      float dl = __fmul_rn(acc[i], f[h]);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (cols.picks(i, s)) dl = __fsub_rn(dl, sl.w[h][s]);
      return dl;
    };
    unsigned char* own = blk.smem + blk.wg * kWarpRows * kRowBytes;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int c = frag_col(i, blk.lane);
      *reinterpret_cast<uint32_t*>(
          own + (c >> 6) * blk.a_block_bytes +
          swizzle(frag_row((i >> 1) & 1, blk.wg_tid), (c & 63) >> 3) +
          (c & 7) * 2) = pack_bf16x2(delta(i), delta(i + 1));
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + blk.wg) : "memory");
  }

  // d_emb chunks: pass 0 sums proj = emb . d_emb, pass 1 writes dx.  The
  // warpgroup's own rows of A-tile blocks 2-3 stage the chunk's x (copied
  // in 16-byte pieces while the products run) and blocks 4-5 its dx (copied
  // out in 16-byte pieces), both in the swizzled layout, where the 8 rows
  // of a fragment's quad groups fall in distinct banks.
  const uint32_t own = blk.a_rows();
  unsigned char* own_ptr = blk.smem + blk.wg * kWarpRows * kRowBytes;
  const long long wg_row0 = blk.row0 + blk.wg * kWarpRows;
  // byte offset of dims (2 j', 2 j' + 1) = local dim c of row r in blocks
  // b0, b0 + 1 (64 dims each)
  auto staged = [&](int b0, int r, int c) {
    return (b0 + (c >> 6)) * blk.a_block_bytes + swizzle(r, (c & 63) >> 3) +
           (c & 7) * 2;
  };
  float proj[2] = {0.f, 0.f};
  for (int pass = 0; pass < 2; ++pass) {
    for (int dc = 0; dc < dchunks; ++dc) {
      // the previous chunk's staged x and dx are consumed
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + blk.wg) : "memory");
      for (int q = blk.wg_tid; q < kWarpRows * 16; q += 128) {
        const int r = q >> 4, c = (q & 15) * 8;
        const int dim = dc * kTileN + c;
        const bool ok = wg_row0 + r < p.n && dim < d;
        cp_async16(own + staged(2, r, c),
                   ok ? p.x + (wg_row0 + r) * d + dim : p.x, ok);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      float dacc[64];
      fence_regs(dacc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int cb = 0; cb < 2; ++cb) {
        if (cb < cblocks) {
          const int s = (next + cb) % kStages;
          mbar_wait(blk.ring.full(s), ((next + cb) / kStages) & 1);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (cb * 4 + k < kc16)
              wgmma_m64n128k16(
                  dacc, sw128_desc(own + cb * blk.a_block_bytes + k * 32),
                  sw128_desc(blk.ring.stage(s) + k * 32), cb > 0 || k > 0);
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + blk.wg) : "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(dacc);
      for (int cb = 0; cb < cblocks; ++cb)
        if (blk.wg_tid == 0)
          mbar_arrive(blk.ring.empty((next + cb) % kStages));
      next += cblocks;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = (i >> 1) & 1;
        const int r = frag_row(h, blk.wg_tid), c = frag_col(i, blk.lane);
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
            own_ptr + staged(2, r, c));
        const float e0 = __fmul_rn(__low2float(xv), rs[h]);
        const float e1 = __fmul_rn(__high2float(xv), rs[h]);
        const float d0 = __fmul_rn(dacc[i], inv_temp);
        const float d1 = __fmul_rn(dacc[i + 1], inv_temp);
        if (pass == 0) {
          proj[h] = __fadd_rn(proj[h], __fmul_rn(e0, d0));
          proj[h] = __fadd_rn(proj[h], __fmul_rn(e1, d1));
        } else {
          *reinterpret_cast<uint32_t*>(own_ptr + staged(4, r, c)) =
              pack_bf16x2(
                  __fmul_rn(rs[h], __fsub_rn(d0, __fmul_rn(e0, proj[h]))),
                  __fmul_rn(rs[h], __fsub_rn(d1, __fmul_rn(e1, proj[h]))));
        }
      }
      if (pass == 1) {
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + blk.wg) : "memory");
        for (int q = blk.wg_tid; q < kWarpRows * 16; q += 128) {
          const int r = q >> 4, c = (q & 15) * 8;
          const int dim = dc * kTileN + c;
          if (wg_row0 + r < p.n && dim < d)
            *reinterpret_cast<uint4*>(p.dx + (wg_row0 + r) * d + dim) =
                *reinterpret_cast<const uint4*>(own_ptr + staged(4, r, c));
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) proj[h] = quad_sum(proj[h]);
    }
  }
}

template <int S>
cudaError_t launch_tc_fwd(const TcParams& p, const void* ptable,
                          cudaStream_t stream) {
  const int k16 = (p.d + 15) / 16;
  const int wgs = rc::tc::warpgroups_for(k16);
  const int rows = wgs * rc::tc::kWarpRows;
  const size_t smem = rc::tc::smem_bytes(rows, k16);
  CUtensorMap map;
  cudaError_t err = rc::tc::make_tensor_map(&map, ptable, p.k, p.d);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_tc_fwd_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.n + rows - 1) / rows));
  ce_tc_fwd_kernel<S><<<grid, wgs * 128 + 128, smem, stream>>>(map, p);
  return cudaGetLastError();
}

constexpr int kRsBytes = sizeof(float);  // the backward's rs per row

template <int S>
cudaError_t launch_tc_bwd(const TcParams& p, const void* ptable,
                          const void* ptable_t, cudaStream_t stream) {
  // the A tile spans at least the blocks that delta, x and dx take
  const int k16 = std::max((p.d + 15) / 16, 4 * kScratchBlocks);
  const int wgs = rc::tc::warpgroups_for(k16, kRsBytes);
  const int rows = wgs * rc::tc::kWarpRows;
  const size_t smem = rc::tc::smem_bytes(rows, k16, kRsBytes);
  CUtensorMap map, map_t;
  cudaError_t err = rc::tc::make_tensor_map(&map, ptable, p.k, p.d);
  if (err != cudaSuccess) return err;
  err = rc::tc::make_tensor_map(&map_t, ptable_t, p.d, (p.k + 7) / 8 * 8);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_tc_bwd_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.n + rows - 1) / rows));
  ce_tc_bwd_kernel<S><<<grid, wgs * 128 + 128, smem, stream>>>(map, map_t,
                                                                p);
  return cudaGetLastError();
}

bool tc_shape_ok(const TcParams& p, int slots) {
  return p.d % 8 == 0 && p.d > 0 && p.d <= kMaxTcDims && p.k > 0 &&
         p.n > 0 && slots >= 1 && slots <= 4;
}

// ---- the members only: f32, bf16 without a tensor-core branch, overflow ---

namespace member {

// the loop: common.cuh (declarations, so that they hide the file's own
// constants of the same names)
using rc::simt::col_of;
using rc::simt::kCols;
using rc::simt::kRows;
using rc::simt::kThreads;
using rc::simt::Layout;
using rc::simt::Roles;
using rc::simt::roles_of;
using rc::simt::score_tiles;

// The instances take 1-4 slots or 16 (a field at H/4 upsampled x4); the
// wrapper pads 5-15 to 16 with weightless slots.  The per-slot state lives
// in shared memory, with room for 4 slots in the instances of 1-4 (two
// blocks per SM) and for S in the others (one block per SM: 125,440 bytes
// for the f32 forward, 135,168 for the backward).
constexpr int kMaxSlots = 16;
constexpr int slot_room(int S) { return S <= 4 ? 4 : S; }
constexpr int blocks_per_sm(int S) { return S <= 4 ? 2 : 1; }

struct MemberParams {
  const void* x;
  const float* temperature;
  const int* labels;     // [S, n]
  const float* valid;    // [S, n]
  long long n;
  int d;
  const float* table_t;  // [d, ldt] f32: the selected table's members first
  int ldt;
  const int* ids;        // [>= count] their global ids
  const int* count;      // [1] members
  const int* mask;       // [c] the full table's membership
  int c;
  const int* pmask;      // [k] packed membership, or NULL
  const int* pids;       // [k] packed global ids
  int k;
  const int* use_packed;  // device flag (packed where non-zero), or NULL
  int skip_packed;        // return at once where the flag selects packed
  float* ce;              // [n] per-row CE
  float* stats;           // [2, n]: each row's max logit and sum-exp, or NULL
};

// Dynamic shared memory beyond the loop's (rc::simt::Layout): the block's
// labels [room][kRows], and each class half's per-row state, its online
// max, sum-exp and slot picks [2][2 + room][kRows], which only the row's
// owner lane writes (so the loop carries no per-row registers).  107,008
// bytes for f32 with room for 4 slots: two blocks per SM.
template <typename T, int S>
struct Extra {
  static constexpr int kRoom = slot_room(S);
  static constexpr int kLabels = Layout<T>::kEnd;
  static constexpr int kState = kLabels + kRoom * kRows * 4;
  static constexpr int kBytes = kState + 2 * (2 + kRoom) * kRows * 4;
};

// Reductions over the 8 lanes of a quarter warp (the same 8 rows).
__device__ __forceinline__ float quarter_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float quarter_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(S))
    ce_members_kernel(const MemberParams p) {
  using E = Extra<T, S>;
  if (p.skip_packed && *p.use_packed != 0) return;
  extern __shared__ __align__(16) unsigned char smem[];
  int* lab = reinterpret_cast<int*>(smem + E::kLabels);
  const int tid = threadIdx.x;
  const Roles roles = roles_of(tid);
  const long long base = (long long)blockIdx.x * kRows;
  const long long n = p.n;
  const int count = __ldg(p.count);
  const bool packed = p.use_packed != nullptr && *p.use_packed != 0;
  const int total = packed ? p.k : p.c;  // rows of the selected table
  const float inv_temp = 1.0f / *p.temperature;
  const int* __restrict__ ids = p.ids;
  for (int i = tid; i < S * kRows; i += kThreads) {
    const long long row = base + i % kRows;
    lab[i] = row < n ? p.labels[(i / kRows) * n + row] : INT_MIN;
  }
  // this half's state: st[0][r] max, st[1][r] sum-exp, st[2 + s][r] picks.
  // Half 0 starts from the plain version's total - count non-member terms
  // exp(-1e30 - m) at m = -1e30: they vanish at the first member tile's
  // rescale, as in f32, and with no member the value is -1e30 +
  // log(total), as the plain version's.
  float(*st)[kRows] = reinterpret_cast<float(*)[kRows]>(
      smem + E::kState + roles.wn * (2 + E::kRoom) * kRows * 4);
  const int own = roles.row0 + 4 * roles.wx;  // the row this lane owns
  st[0][own] = rc::kNegInf;
  st[1][own] = roles.wn == 0 ? (float)(total - count) : 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) st[2 + s][own] = 0.f;
  __syncthreads();

  score_tiles<T>(
      smem, static_cast<const T*>(p.x), p.d, base, p.table_t, p.ldt, count,
      n, p.d, roles, [&](float (&acc)[8][8], const float* rs, int tile) {
        const int c0 = tile * kCols + roles.col0;
        int id[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + col_of(j, roles.wx);
          id[j] = col < count ? __ldg(ids + col) : 0;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // logits: f32 scales the sum (rs * sum(x * t)), bf16 summed the
          // products of bf16(x * rs); then 1/tau; past the count -inf
          const int r = roles.row0 + 4 * i;
          const float scale = Layout<T>::kRoundFirst ? 1.f : rs[r];
          const float m_old = st[0][r];  // read before the owner writes
          float tmax = -CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float sim = Layout<T>::kRoundFirst
                                  ? acc[i][j]
                                  : __fmul_rn(acc[i][j], scale);
            acc[i][j] = c0 + col_of(j, roles.wx) < count
                            ? __fmul_rn(sim, inv_temp)
                            : -CUDART_INF_F;
            tmax = fmaxf(tmax, acc[i][j]);
          }
          const float m_new = fmaxf(m_old, quarter_max(tmax));
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) ps += expf(acc[i][j] - m_new);
          ps = quarter_sum(ps);
          float pv[S];  // the logits at the slots' labels (0 if none)
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int l = lab[s * kRows + r];
            float v = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (c0 + col_of(j, roles.wx) < count && id[j] == l)
                v += acc[i][j];
            pv[s] = quarter_sum(v);
          }
          __syncwarp();  // every lane has read m_old
          if (roles.wx == i) {
            st[1][r] = __fadd_rn(__fmul_rn(st[1][r], expf(m_old - m_new)),
                                 ps);
            st[0][r] = m_new;
#pragma unroll
            for (int s = 0; s < S; ++s) st[2 + s][r] += pv[s];
          }
        }
      });

  // The two class halves of a row merge in the owner of the first.
  __syncthreads();
  const long long row = base + own;
  if (roles.wn != 0 || row >= n) return;
  const float(*other)[kRows] = st + (2 + E::kRoom);
  const float m0 = st[0][own], m1 = other[0][own];
  const float m = fmaxf(m0, m1);
  const float z = __fadd_rn(__fmul_rn(st[1][own], expf(m0 - m)),
                            __fmul_rn(other[1][own], expf(m1 - m)));
  const float lse = m + logf(z);
  if (p.stats != nullptr) {
    p.stats[row] = m;
    p.stats[n + row] = z;
  }
  float wsum = 0.f, wpick = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int l = lab[s * kRows + own];
    float pk = st[2 + s][own] + other[2 + s][own];
    // each row of the selected table with the label's id that is not a
    // member adds its logit, -1e30 (labels outside [0, c) hit no row of
    // the full table)
    if (packed) {
      for (int q = 0; q < p.k; ++q)
        if (__ldg(p.pids + q) == l && __ldg(p.pmask + q) == 0)
          pk = __fadd_rn(pk, rc::kNegInf);
    } else if (l >= 0 && l < p.c && __ldg(p.mask + l) == 0) {
      pk = __fadd_rn(pk, rc::kNegInf);
    }
    const float w = p.valid[s * n + row];
    wsum = __fadd_rn(wsum, w);
    wpick = __fadd_rn(wpick, __fmul_rn(w, pk));
  }
  p.ce[row] = __fsub_rn(__fmul_rn(wsum, lse), wpick);
}

template <typename T, int S>
cudaError_t launch(const MemberParams& p, cudaStream_t stream) {
  constexpr int smem = Extra<T, S>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ce_members_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  // all of the SM's shared memory, so that two blocks are resident
  err = cudaFuncSetAttribute(ce_members_kernel<T, S>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.n + kRows - 1) / kRows));
  ce_members_kernel<T, S><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- the backward --------------------------------------------------------

struct BwdParams {
  const void* x;
  const float* temperature;
  const float* coeff;    // the upstream gradient of the summed CE
  const int* labels;     // [S, n]
  const float* valid;    // [S, n]
  long long n;
  int d;
  const float* table_t;  // [d, ldt] f32: the selected table's members first
  int ldt;
  const int* ids;        // their global ids (then the other rows')
  const int* count;      // [1] members
  const void* table;     // [c, d] the full table, in x's dtype
  const int* mask;       // [c] its membership
  int c;
  const void* ptable;    // [k, d] the packed table, or NULL
  const int* pmask;      // [k]
  const int* pids;       // [k] global ids
  int k;
  const int* use_packed;  // device flag (packed where non-zero), or NULL
  int skip_packed;        // return at once where the flag selects packed
  const float* stats;     // [2, n] the forward's row max and sum-exp
  void* dx;               // [n, d] in x's dtype
  float* dtau;            // [n] per-row d log tau
  float* work;            // per block: delta [ldt, kRows], d_emb [kRows, d]
};

// Per-row values of the block: [kRowValues][kRows] f32.
enum RowValue { kWsum, kScale, kMax, kInvZ, kProj, kRowValues };
// Per class half and row: [2][Bwd::kHalfValues][kRows] f32, written by
// the row's owner lane in that half: the sum of e * logit, then the picks.
enum HalfValue { kHalfTel, kHalfPick };
constexpr int kStagePitch = kCols + 4;  // a d_emb tile staged [rows][dims]

// Dynamic shared memory: the loop's ring (the f32 layout, which the second
// product uses, is the larger), then the block's labels and weights w_s =
// coeff * valid [S][kRows], the row values and the half states; the
// non-member labels' delta [S][kRows] reuses half 0's picks once they are
// merged.  110,592 bytes with room for 4 slots: two blocks per SM.
template <typename T, int S>
struct Bwd {
  static constexpr int kRoom = slot_room(S);
  static constexpr int kHalfValues = kHalfPick + kRoom;
  static constexpr int kLabels =
      Layout<float>::kEnd > Layout<T>::kEnd ? Layout<float>::kEnd
                                            : Layout<T>::kEnd;
  static constexpr int kWeights = kLabels + kRoom * kRows * 4;
  static constexpr int kRowState = kWeights + kRoom * kRows * 4;
  static constexpr int kHalfState = kRowState + kRowValues * kRows * 4;
  static constexpr int kBytes = kHalfState + 2 * kHalfValues * kRows * 4;
  static_assert(kRows * kStagePitch * 4 <= Layout<float>::kScaleOffset,
                "the staged d_emb tile fits in the ring");
};

// Four consecutive values through one 16-byte (f32) or 8-byte (bf16)
// access.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  v[0] = __low2float(h[0]);
  v[1] = __high2float(h[0]);
  v[2] = __low2float(h[1]);
  v[3] = __high2float(h[1]);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(S))
    ce_members_bwd_kernel(const BwdParams p) {
  if (p.skip_packed && *p.use_packed != 0) return;
  extern __shared__ __align__(16) unsigned char smem[];
  using B = Bwd<T, S>;
  int* lab = reinterpret_cast<int*>(smem + B::kLabels);
  float* wt = reinterpret_cast<float*>(smem + B::kWeights);
  float* rowv = reinterpret_cast<float*>(smem + B::kRowState);
  float* halfv = reinterpret_cast<float*>(smem + B::kHalfState);
  auto RV = [&](int v, int r) -> float& { return rowv[v * kRows + r]; };
  auto HV = [&](int h, int v, int r) -> float& {
    return halfv[(h * B::kHalfValues + v) * kRows + r];
  };
  float* coef = &HV(0, kHalfPick, 0);  // [S][kRows], after the merge
  const float* pixel_rs =
      reinterpret_cast<const float*>(smem + Layout<T>::kScaleOffset);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Roles roles = roles_of(tid);
  const int own = roles.row0 + 4 * roles.wx;  // the row this lane owns
  const long long n = p.n;
  const int d = p.d;
  const T* x = static_cast<const T*>(p.x);
  T* dx = static_cast<T*>(p.dx);
  const int count = __ldg(p.count);
  const bool packed = p.use_packed != nullptr && *p.use_packed != 0;
  const T* table = static_cast<const T*>(packed ? p.ptable : p.table);
  // the columns scored: the members; with none, every row of the selected
  // table, masked (count == 0 puts them first, in table order)
  const int ncol = count > 0 ? count : (packed ? p.k : p.c);
  const float inv_temp = 1.0f / *p.temperature;
  const float coeff = *p.coeff;
  // this block's workspace: delta [ldt][kRows], then d_emb [kRows][d]
  float* work = p.work + (size_t)blockIdx.x * (p.ldt + d) * kRows;
  float* d_emb = work + (size_t)p.ldt * kRows;

  // column col's logit from its (unmasked) logit lu
  auto logit = [&](float lu, int col) {
    return col < count ? lu : col < ncol ? rc::kNegInf : -CUDART_INF_F;
  };
  // a valid label's rows of the selected table that are not gathered:
  // visit(row pointer) for each (count > 0 only: with no member every row
  // is a column)
  auto nonmember_rows = [&](int l, auto&& visit) {
    if (count == 0) return;
    if (packed) {
      for (int q = 0; q < p.k; ++q)
        if (__ldg(p.pids + q) == l && __ldg(p.pmask + q) == 0)
          visit(table + (long long)q * d);
    } else if (l >= 0 && l < p.c && __ldg(p.mask + l) == 0) {
      visit(table + (long long)l * d);
    }
  };

  for (long long base = (long long)blockIdx.x * kRows; base < n;
       base += (long long)gridDim.x * kRows) {
    // 0. labels and weights, the half states
    for (int i = tid; i < S * kRows; i += kThreads) {
      const long long row = base + i % kRows;
      const long long at = (i / kRows) * n + row;
      lab[i] = row < n ? p.labels[at] : INT_MIN;
      wt[i] = row < n ? __fmul_rn(coeff, p.valid[at]) : 0.f;
    }
    HV(roles.wn, kHalfTel, own) = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) HV(roles.wn, kHalfPick + s, own) = 0.f;
    __syncthreads();
    if (tid < kRows) {
      float ws = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) ws = __fadd_rn(ws, wt[s * kRows + tid]);
      RV(kWsum, tid) = ws;
      RV(kProj, tid) = 0.f;
      // the forward's row statistics (rows past n: e * 0)
      const long long row = base + tid;
      RV(kMax, tid) = row < n ? p.stats[row] : 0.f;
      RV(kInvZ, tid) = row < n ? 1.0f / p.stats[n + row] : 0.f;
    }
    // (read in the epilogues, after the loop's first barrier)

    // 1. the delta pass: per tile, the logits, delta into the workspace,
    // and the row sums of e * logit and the picks
    score_tiles<T>(
        smem, x, d, base, p.table_t, p.ldt, ncol, n, d, roles,
        [&](float (&acc)[8][8], const float* rs, int tile) {
          const int c0 = tile * kCols + roles.col0;
          int id[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c0 + col_of(j, roles.wx);
            id[j] = col < ncol ? __ldg(p.ids + col) : 0;
          }
          // acc becomes the logits
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = roles.row0 + 4 * i;
            const float scale = Layout<T>::kRoundFirst ? 1.f : rs[r];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = logit(
                  __fmul_rn(Layout<T>::kRoundFirst
                                ? acc[i][j]
                                : __fmul_rn(acc[i][j], scale),
                            inv_temp),
                  c0 + col_of(j, roles.wx));
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = roles.row0 + 4 * i;
            const float m = RV(kMax, r);
            const float f = __fmul_rn(RV(kWsum, r), RV(kInvZ, r));
            float pt = 0.f, pk[S];
#pragma unroll
            for (int s = 0; s < S; ++s) pk[s] = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = c0 + col_of(j, roles.wx);
              if (col >= ncol) continue;
              const float l = acc[i][j];
              const float e = expf(l - m);
              float dl = __fmul_rn(e, f);
#pragma unroll
              for (int s = 0; s < S; ++s)
                if (id[j] == lab[s * kRows + r]) {
                  dl = __fsub_rn(dl, wt[s * kRows + r]);
                  pk[s] += l;
                }
              work[(size_t)col * kRows + r] =
                  rc::to_float(rc::round_to(dl, T()));
              pt = __fadd_rn(pt, __fmul_rn(e, l));
            }
            pt = quarter_sum(pt);
#pragma unroll
            for (int s = 0; s < S; ++s) pk[s] = quarter_sum(pk[s]);
            if (roles.wx == i) {
              HV(roles.wn, kHalfTel, r) += pt;
#pragma unroll
              for (int s = 0; s < S; ++s)
                HV(roles.wn, kHalfPick + s, r) += pk[s];
            }
          }
        });

    // 2. per row: the halves merged; each valid label's rows of the
    // selected table that were not gathered pick -1e30 and get a delta
    // (e = 0, minus the weights of the slots with that label; kept once,
    // at the label's first slot), added to d_emb in step 3; then dtau
    __syncthreads();
    if (tid < kRows) {
      const int r = tid;
      const long long row = base + r;
      float pk[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        pk[s] = __fadd_rn(HV(0, kHalfPick + s, r), HV(1, kHalfPick + s, r));
      const float t_el = __fadd_rn(HV(0, kHalfTel, r), HV(1, kHalfTel, r));
      RV(kScale, r) = pixel_rs[r];
      float wpick = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int l = lab[s * kRows + r];
        bool first = true;
        for (int s2 = 0; s2 < s; ++s2) first &= lab[s2 * kRows + r] != l;
        float cf = 0.f;
        for (int s2 = s; s2 < S; ++s2)
          if (lab[s2 * kRows + r] == l) cf = __fsub_rn(cf, wt[s2 * kRows + r]);
        bool hit = false;
        nonmember_rows(l, [&](const T*) {
          hit = true;
          pk[s] = __fadd_rn(pk[s], rc::kNegInf);
        });
        coef[s * kRows + r] =
            hit && first ? rc::to_float(rc::round_to(cf, T())) : 0.f;
        wpick = __fadd_rn(wpick, __fmul_rn(wt[s * kRows + r], pk[s]));
      }
      if (row < n)
        p.dtau[row] = __fsub_rn(
            wpick, __fmul_rn(RV(kWsum, r), __fmul_rn(t_el, RV(kInvZ, r))));
    }
    __syncthreads();

    // 3. d_emb = delta x table / tau, 128 dims at a time, into the
    // workspace, and proj = emb . d_emb: the gathered table is the loop's
    // field (rows = dims, k = members), the delta slice its table (k =
    // members, columns = this block's pixel rows)
    const int rows_here = (int)min((long long)kRows, n - base);
    for (int d0 = 0; d0 < d; d0 += kCols) {
      score_tiles<float>(
          smem, p.table_t, p.ldt, d0, work, kRows, rows_here, d, ncol, roles,
          [&](float (&acc)[8][8], const float*, int) {
            __syncthreads();  // every warp's last product is done: the
                              // ring is free
            float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                stage[(roles.col0 + col_of(j, roles.wx)) * kStagePitch +
                      roles.row0 + 4 * i] = acc[i][j];
            __syncthreads();
            const int dim = d0 + 4 * lane;
            const bool in = dim < d;
            for (int r = warp; r < rows_here; r += kThreads / 32) {
              float part = 0.f;
              if (in) {
                float v[4];
                load4(stage + r * kStagePitch + 4 * lane, v);
#pragma unroll 1
                for (int s = 0; s < S; ++s) {  // a non-member label's rows
                  const float cf = coef[s * kRows + r];
                  if (cf == 0.f) continue;
                  nonmember_rows(lab[s * kRows + r], [&](const T* t_row) {
                    float t[4];
                    load4(t_row + dim, t);
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                      v[e] = __fadd_rn(v[e], __fmul_rn(cf, t[e]));
                  });
                }
                float xv[4];
                load4(x + (base + r) * d + dim, xv);
                const float rsr = RV(kScale, r);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  v[e] = __fmul_rn(v[e], inv_temp);
                  part = __fadd_rn(part, __fmul_rn(__fmul_rn(xv[e], rsr),
                                                   v[e]));
                }
                store4(d_emb + (size_t)r * d + dim, v);
              }
              part = rc::warp_sum(part);
              if (lane == 0) RV(kProj, r) = __fadd_rn(RV(kProj, r), part);
            }
            __syncthreads();  // the stage is read before the ring reloads
          });
    }

    // 4. dx = rs * (d_emb - emb * proj), a warp per row
    for (int r = warp; r < rows_here; r += kThreads / 32) {
      const float rsr = RV(kScale, r), proj = RV(kProj, r);
      const long long row = base + r;
      for (int dim = 4 * lane; dim < d; dim += 128) {
        float v[4], xv[4], o[4];
        load4(d_emb + (size_t)r * d + dim, v);
        load4(x + row * d + dim, xv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float emb = __fmul_rn(xv[e], rsr);
          o[e] = __fmul_rn(rsr, __fsub_rn(v[e], __fmul_rn(emb, proj)));
        }
        store4(dx + row * d + dim, o);
      }
    }
    __syncthreads();  // the row state is read before the next row tile
  }
}

// Row tiles of 128 pixel rows, and the backward's grid: a block per row
// tile, at most two per SM (the blocks resident at once), each walking its
// row tiles with its own workspace slice.
long long row_tiles(long long n) { return (n + kRows - 1) / kRows; }

long long bwd_blocks(long long n) {
  const long long resident = 2LL * rc::sm_count();
  return resident > 0 ? std::min(row_tiles(n), resident) : row_tiles(n);
}

template <typename T, int S>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  constexpr int smem = Bwd<T, S>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ce_members_bwd_kernel<T, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_members_bwd_kernel<T, S>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return err;
  ce_members_bwd_kernel<T, S>
      <<<(unsigned)bwd_blocks(p.n), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// One of the ten (dtype, slots) instances of a member-only kernel.
template <template <typename, int> class Kernel, typename Params>
cudaError_t dispatch(const Params& p, int is_bf16, int slots,
                     cudaStream_t st) {
  using bf = __nv_bfloat16;
  switch (slots * 2 + (is_bf16 ? 1 : 0)) {
    case 2: return Kernel<float, 1>::run(p, st);
    case 3: return Kernel<bf, 1>::run(p, st);
    case 4: return Kernel<float, 2>::run(p, st);
    case 5: return Kernel<bf, 2>::run(p, st);
    case 6: return Kernel<float, 3>::run(p, st);
    case 7: return Kernel<bf, 3>::run(p, st);
    case 8: return Kernel<float, 4>::run(p, st);
    case 9: return Kernel<bf, 4>::run(p, st);
    case 32: return Kernel<float, kMaxSlots>::run(p, st);
    case 33: return Kernel<bf, kMaxSlots>::run(p, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int S>
struct Forward {
  static cudaError_t run(const MemberParams& p, cudaStream_t st) {
    return launch<T, S>(p, st);
  }
};

template <typename T, int S>
struct Backward {
  static cudaError_t run(const BwdParams& p, cudaStream_t st) {
    return launch_bwd<T, S>(p, st);
  }
};

}  // namespace member

}  // namespace


// The member-only forward.  x: [n, d] f32 (is_bf16 == 0) or bf16,
// un-normalised, 16-byte aligned; temperature: [1] f32; labels: [slots, n]
// int32; valid: [slots, n] f32; table_t: [d, ldt] f32, 16-byte aligned,
// ldt % 4 == 0: the members of the table the flag selects (the packed one
// where *use_packed != 0, else the full one), first and transposed, with
// their global ids and *count (device memory) of them (rc_live_rows); the
// columns past the count are not read.  mask [c]: the full table's
// membership; pmask, pids [k]: the packed table's (NULL without
// use_packed).  A label's pick is its member's logit, plus -1e30 for each
// row of the selected table with its id that is not a member.  With
// skip_packed the kernel returns at once where *use_packed != 0 (the
// tensor-core kernel, launched beside it, takes that branch).  ce: [n] f32;
// stats: [2, n] f32, each row's max logit and sum-exp for the backward, or
// NULL.  slots: 1-4 or 16.
extern "C" int rc_pixel_text_ce_members_fwd(
    const void* x, int is_bf16, const float* temperature, const int* labels,
    const float* valid, int slots, long long n, int d, const float* table_t,
    int ldt, const int* ids, const int* count, const int* mask, int c,
    const int* pmask, const int* pids, int k, const int* use_packed,
    int skip_packed, float* ce, float* stats, void* stream) {
  if (d % 8 != 0 || d <= 0 || c <= 0 || n <= 0 || ldt <= 0 ||
      ldt % 4 != 0 ||
      (use_packed != nullptr && (pmask == nullptr || pids == nullptr ||
                                 k <= 0)) ||
      (skip_packed && use_packed == nullptr))
    return cudaErrorInvalidValue;
  const member::MemberParams p{x,     temperature, labels, valid, n,
                               d,     table_t,     ldt,    ids,   count,
                               mask,  c,           pmask,  pids,  k,
                               use_packed, skip_packed, ce, stats};
  return member::dispatch<member::Forward>(
      p, is_bf16, slots, static_cast<cudaStream_t>(stream));
}

// The member-only backward: arguments as the forward's, plus coeff: [1]
// f32, the upstream gradient of the summed CE; table [c, d] and ptable [k,
// d] (or NULL): the full and packed tables in x's dtype, 16-byte aligned
// (a non-member label's row is read from them); ids must hold ldt entries
// when *count can be 0 (then every row of the selected table is scored,
// as rc_live_rows orders them); stats: the forward's [2, n] row
// statistics on the same operands.  dx: [n, d] in x's dtype; dtau: [n] f32
// per-row d log tau; workspace: rc_pixel_text_ce_workspace(ldt + d, n)
// bytes.
extern "C" int rc_pixel_text_ce_bwd(
    const void* x, int is_bf16, const float* temperature, const float* coeff,
    const int* labels, const float* valid, int slots, long long n, int d,
    const float* table_t, int ldt, const int* ids, const int* count,
    const void* table, const int* mask, int c, const void* ptable,
    const int* pmask, const int* pids, int k, const int* use_packed,
    int skip_packed, const float* stats, void* dx, float* dtau,
    void* workspace, void* stream) {
  if (d % 8 != 0 || d <= 0 || c <= 0 || n <= 0 || ldt < c ||
      ldt % 4 != 0 || workspace == nullptr || stats == nullptr ||
      (use_packed != nullptr &&
       (ptable == nullptr || pmask == nullptr || pids == nullptr || k <= 0 ||
        ldt < c + k)) ||
      (skip_packed && use_packed == nullptr))
    return cudaErrorInvalidValue;
  const member::BwdParams p{x,      temperature, coeff,  labels, valid,
                            n,      d,           table_t, ldt,   ids,
                            count,  table,       mask,   c,      ptable,
                            pmask,  pids,        k,      use_packed,
                            skip_packed, stats,  dx,     dtau,
                            static_cast<float*>(workspace)};
  return member::dispatch<member::Backward>(
      p, is_bf16, slots, static_cast<cudaStream_t>(stream));
}

// Bytes of the backward's workspace at width = ldt + d and n rows: a
// [width, 128] f32 slice per block of its grid (delta, then d_emb).
extern "C" long long rc_pixel_text_ce_workspace(int width, long long n) {
  return member::bwd_blocks(n) * (long long)width * member::kRows *
         (long long)sizeof(float);
}

// The tensor-core kernels of the bf16 packed branch.  x: [n, d] bf16,
// un-normalised, 16-byte aligned, d % 8 == 0, d <= 1280; ptable [k, d] bf16
// normalised, pmask [k] int32, pids [k] int32 global ids; labels, valid,
// temperature, coeff as above; the forward's stats as the member-only
// forward's (or NULL).  They run only where *use_packed != 0 (always when
// it is NULL), so they pair with the member-only kernels called with
// skip_packed = 1: one of the two writes.
extern "C" int rc_pixel_text_ce_tc_fwd(
    const void* x, const float* temperature, const int* labels,
    const float* valid, int slots, long long n, int d, const void* ptable,
    const int* pmask, const int* pids, int k, const int* use_packed,
    float* ce, float* stats, void* stream) {
  const TcParams p{static_cast<const __nv_bfloat16*>(x), temperature,
                   nullptr, labels, valid, n, d, pmask, pids, k, use_packed,
                   ce, nullptr, nullptr, stats};
  if (!tc_shape_ok(p, slots)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 1: return launch_tc_fwd<1>(p, ptable, st);
    case 2: return launch_tc_fwd<2>(p, ptable, st);
    case 3: return launch_tc_fwd<3>(p, ptable, st);
    default: return launch_tc_fwd<4>(p, ptable, st);
  }
}

// ptable_t: the packed table transposed, [d, k8] bf16 with k8 = k rounded
// up to a multiple of 8 (zero columns past k), 16-byte aligned; k <= 128.
// dx: [n, d] bf16; dtau: [n] f32.
extern "C" int rc_pixel_text_ce_tc_bwd(
    const void* x, const float* temperature, const float* coeff,
    const int* labels, const float* valid, int slots, long long n, int d,
    const void* ptable, const void* ptable_t, const int* pmask,
    const int* pids, int k, const int* use_packed, void* dx, float* dtau,
    void* stream) {
  const TcParams p{static_cast<const __nv_bfloat16*>(x), temperature, coeff,
                   labels, valid, n, d, pmask, pids, k, use_packed, nullptr,
                   static_cast<__nv_bfloat16*>(dx), dtau, nullptr};
  if (!tc_shape_ok(p, slots) || k > kMaxTcBwdClasses)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 1: return launch_tc_bwd<1>(p, ptable, ptable_t, st);
    case 2: return launch_tc_bwd<2>(p, ptable, ptable_t, st);
    case 3: return launch_tc_bwd<3>(p, ptable, ptable_t, st);
    default: return launch_tc_bwd<4>(p, ptable, ptable_t, st);
  }
}
