// Causal grouped-query flash attention with an online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/attention.py:flash_attention
// (body _kernel).  q: [B, Sq, Hq, D], k and v: [B, Skv, Hkv, D], f32 or
// bf16, Sq and Skv multiples of 128; kv head = q head / (Hq / Hkv).
// Per kv tile, in the TPU kernel's order:
//   s = q k^T / sqrt(D) in f32; masked scores become the -1e30 sentinel
//   (columns >= kv_valid, and, when causal, qpos + q_offset < kpos);
//   m_next = max(m, rowmax s); alpha = exp(m - m_next); p = exp(s - m_next);
//   l = alpha l + rowsum p; acc = alpha acc + p v.
// At the end out = acc / l (l == 0 -> 1), cast to q's dtype.  A row whose
// every column is masked keeps m = -1e30, so each of its columns gets
// p = 1 and the row becomes the mean of v over the whole padded kv grid,
// as the TPU kernel computes it.  kv tiles past the causal diagonal and
// past kv_valid are skipped only when no row of the q tile is fully
// masked: for such rows they add exactly 0.  The heaviest causal q tiles
// are launched first.  Both bodies take the softmax in base 2: s is
// multiplied by log2(e)/sqrt(D) in f32, which differs from exp(s/sqrt(D))
// by f32 rounding only.
//
// Bound: operations.  At a prefill of S = 2048, 20 heads, D = 128 the
// causal product is ~21 GFLOP against ~42 MB of q, k, v and out in bf16
// (84 MB in f32), far above the card's ~295 FLOP per byte, so the tensor
// cores set the floor.  Two bodies, chosen by the wrapper (flash_body):
//
// * wgmma (bf16, D in {64, 128}): one CTA per (batch * q head, 128-row q
//   tile) with two consumer warpgroups of 64 rows and one producer warp.
//   The producer loads the q tile once and fills a five-stage ring of
//   64-row K and V tiles with TMA (128-byte swizzle, mbarrier completion).
//   Each consumer forms S = q k^T with wgmma from shared memory on the
//   unscaled bf16 inputs (exact products, f32 sums), and masks and updates
//   (m, l) in registers.  O += P V runs as wgmma with P from registers and
//   V [kv, D] from shared memory as an MN-major operand (no transpose),
//   overlapped with the next tile's softmax, and the other warpgroup's
//   products overlap it too.  p stays f32 in effect: it is split
//   into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both products go
//   into the same f32 accumulator, which keeps the TPU kernel's f32 P V to
//   about 2^-16 of p for 1.5x the tensor-core work of one bf16 P V.
// * tf32x3 (f32 at D in {8, 64, 128}, and bf16 at D = 8, widened to f32 as
//   it is staged): the f32 function must hold 1e-5, and one TF32 product
//   keeps ~11 bits of each operand (an error of ~3e-3 here).  Every operand
//   x is split into hi = x rounded to TF32 (its 13 low mantissa bits zero,
//   so a TF32 product reads it whole) and lo = x - hi (exact), and each
//   product is three tf32 wgmma with f32 sums, lo.hi + hi.lo + hi.hi; the
//   dropped lo.lo and the TF32 reading of lo leave ~2^-22 of each term.
//   The tensor cores' sums truncate, so no accumulator runs long (the note
//   at issue_qk_tf32x3): S's hi.hi is summed in one accumulator a 32-column
//   slab of D and its corrections in another, and each kv tile's P V in a
//   fresh one that joins O's running sum in registers, rounded to nearest.
//   The 3x TF32 rate (495 TFLOP/s dense) makes the floor 3 x 21.5
//   GFLOP / 495 TFLOP/s = 0.130 ms at that prefill, against 0.321 ms for
//   FP32 FMAs at 67 TFLOP/s.  TF32 wgmma takes only K-major operands: q
//   and k [rows, D] are, but V [kv, D] is MN-major as the B of P V, so
//   the body stores V transposed, [D, kv], once per tile (the other way
//   round, O^T = V^T P^T, would need V^T K-major as A, the same transpose).
//   A tile must be rewritten anyway (split into hi and lo, V transposed),
//   so a staging warpgroup loads k and v from global memory into registers
//   (16-byte loads, the next tile's issued before the current one is
//   written, so their latency overlaps the wait for a free slot), splits
//   and transposes them, and writes k_hi, k_lo, vt_hi and vt_lo, 128-byte
//   swizzled, into a ring of slots on mbarriers, a slot's k and v halves
//   each with a full barrier (the staging threads fence to the async proxy
//   and arrive) and an empty one (the consumers arrive once the tile's S,
//   or its P V, is in): with two slots at D = 128, k_{j+2} is written while
//   tile j's P V still reads its v.  A TMA copy would land each tile in
//   shared memory only to be read back and written again, and its landing
//   buffer would cost a slot at D = 128.  One consumer warpgroup per CTA owns 64
//   q rows: it stages q_hi and q_lo once, then per kv tile runs S = q k^T
//   with A and B from shared memory, its softmax as the bf16 body does,
//   and O += P V with P from registers, the P V of one tile overlapping the
//   next tile's S and softmax.  Shared-memory bandwidth bounds it on an
//   H100: per 32-row kv tile at D = 128 its wgmma read ~190 KB of shared
//   memory (q again for each of S's 48 products) and the staging writes
//   64 KB, against ~1,500 cycles of 3xTF32 work; without the staging's
//   stores a call takes 2/3 of its time, with one product a product 3/4.
//   attention.tf32x3_plan sizes the launch, and kernels/_build.py compiles
//   it in (TfPlan; TfLayout must come to its bytes): q_hi and q_lo of 64
//   rows at D = 128 are 64 KB and a slot of 32 kv rows another 64 KB, so
//   D = 128 takes 32-row kv tiles, two slots, S in four pieces and O's
//   running sum in shared memory (32 KB: in registers beside a tile's
//   fresh sum it would take 128 of them), ~230 KB; D = 64 64-row tiles,
//   three slots and S in two pieces (~230 KB); D = 8 64-row tiles and
//   four slots.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {

constexpr float kFlashNegInf = -1e30f;  // the TPU kernel's NEG_INF

// Four consecutive elements as floats (16-byte f32 or 8-byte bf16 load).
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// The kv tiles a q tile of tile_q rows from q0 walks.  A row that sees
// any column sees column 0, so after the first tile its m is finite and
// every later fully masked tile adds exp(-1e30 - m) = 0: those tiles, past
// the causal diagonal and past kv_valid, are skipped.  A q tile holding a
// fully masked row walks them all, as the TPU kernel does.
__device__ __forceinline__ int kv_tiles(int q0, int tile_q, int tile_kv, int skv, int kv_valid,
                                        int causal, int q_offset) {
  int kv_end = skv;
  const bool some_row_masked = kv_valid <= 0 || (causal && q0 + q_offset < 0);
  if (!some_row_masked) {
    long long limit = kv_valid;
    if (causal) limit = min(limit, (long long)q0 + tile_q + q_offset);
    kv_end = (int)min((long long)skv, (limit + tile_kv - 1) / tile_kv * tile_kv);
  }
  return kv_end / tile_kv;
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16, D in {64, 128}).
// ---------------------------------------------------------------------------
constexpr int kWgTileQ = 128;                   // q rows per CTA
constexpr int kWgTileKV = 64;                   // kv rows per ring stage
constexpr int kWgStages = 5;
constexpr int kWgConsumers = 256;               // two warpgroups of 64 q rows
constexpr int kWgThreads = kWgConsumers + 32;   // and one producer warp
constexpr int kSlabCols = 64;                   // bf16 columns in a 128-byte row

// Shared-memory layout in bytes from a 1024-byte-aligned base.  Every tile
// is stored as D / 64 slabs of [rows][64] bf16, 128-byte swizzled.
template <int D>
struct WgLayout {
  static constexpr int kSlabs = D / kSlabCols;
  static constexpr int kQSlab = kWgTileQ * 128;
  static constexpr int kKVSlab = kWgTileKV * 128;
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kKVBytes = kSlabs * kKVSlab;   // one K (or V) tile
  static constexpr int kK = kQBytes;                  // K ring
  static constexpr int kV = kK + kWgStages * kKVBytes;  // V ring
  static constexpr int kBar = kV + kWgStages * kKVBytes;  // q, full[], empty[]
  static constexpr size_t kSmem = kBar + 8 * (1 + 2 * kWgStages) + 1024;
};

// wgmma's accumulator layout for a 64-row tile: thread (warp w, lane) of a
// warpgroup holds rows 16 w + lane / 4 (r = 0) and that + 8 (r = 1); of
// each 8-column block n, columns 8 n + 2 (lane % 4) + e at [4 n + 2 r + e].
constexpr int kSRegs = kWgTileKV / 2;   // S (and P) values a thread holds
constexpr int kPSteps = kWgTileKV / 16; // k steps of P V, one A fragment each

// S = q k^T for one warpgroup's 64 q rows and one 64-row kv tile.  (A
// 128-row kv tile needs 64 more registers a thread for S and P; with the
// 224 that 288 threads leave, ptxas then spilled ~560 bytes and serialised
// every wgmma.)
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kSRegs], uint32_t q_wg, uint32_t k_st) {
  static_assert(kWgTileKV == 64, "S is one m64n64 wgmma per k step");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 32 bytes of k per step
    wgmma_m64n64k16_ss(s, wgmma_desc(q_wg + (kk / 4) * kWgTileQ * 128 + off, 16, 1024),
                       wgmma_desc(k_st + (kk / 4) * kWgTileKV * 128 + off, 16, 1024), kk > 0);
  }
}

// O += P V with P as hi and lo bf16 fragments; V [kv, D] is the MN-major B
// operand, 16 kv rows per wgmma, its 64-column slabs one slab apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p_hi)[kPSteps][4],
                                         const uint32_t (&p_lo)[kPSteps][4], uint32_t v_st) {
#pragma unroll
  for (int kk = 0; kk < kPSteps; ++kk) {
    const uint64_t desc_v = wgmma_desc(v_st + kk * 16 * 128, kWgTileKV * 128, 1024);
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs(o, p_hi[kk], desc_v);
      wgmma_m64n128k16_rs(o, p_lo[kk], desc_v);
    } else {
      wgmma_m64n64k16_rs(o, p_hi[kk], desc_v);
      wgmma_m64n64k16_rs(o, p_lo[kk], desc_v);
    }
  }
}

// 2^x on the special-function unit (relative error ~2^-22; 2^x below
// 2^-126 flushes to 0, far under any row sum, which is at least 1).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One S tile of TK kv columns (both bodies) in the TPU kernel's order:
// scale, mask to the sentinel, row max, m_next, alpha, p = exp(s - m_next)
// in place, l.  The scores are kept
// in base 2: s is multiplied by log2(e) / sqrt(D) in f32 (scale_log2), so
// exp(s / sqrt(D) - m) is one ex2 of a difference, and m is kept in the same
// units; masked scores are the -1e30 sentinel there too, so a fully masked
// row still gets p = 2^0 = 1 everywhere.  Each thread holds TK / 4
// values of each of its two rows; both rows go through every step side by
// side and the row max and sum are trees, so the dependent chains stay
// short.  Rows of a quad of threads are then reduced with shuffles.
// kMasked selects the code for tiles that hold a masked score (the causal
// diagonal, the kv_valid edge): a run-time test here would be if-converted
// into compares and selects that every tile then executes.
template <int TK, bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[TK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int row0, int col2,
                                             int kv_valid, int causal, int q_offset,
                                             float scale_log2) {
  constexpr int kBlocks = TK / 8;  // 8-column blocks of the tile
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) {
    // i = 4 n + 2 r + e: column 8 n + col2 + e of row row0 + 8 r
    float x = s[i] * scale_log2;
    if constexpr (kMasked) {
      const int kpos = k0 + 8 * (i / 4) + col2 + (i % 2);
      const int qpos = row0 + 8 * ((i / 2) % 2);
      if (kpos >= kv_valid || (causal && qpos + q_offset < kpos)) x = kFlashNegInf;
    }
    s[i] = x;
  }
  float red[2][kBlocks];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < kBlocks; ++n) red[r][n] = fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]);
#pragma unroll
  for (int w = kBlocks / 2; w >= 1; w /= 2)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < w; ++n) red[r][n] = fmaxf(red[r][n], red[r][n + w]);
  float m_next[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    red[r][0] = fmaxf(red[r][0], __shfl_xor_sync(0xffffffffu, red[r][0], 1));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    red[r][0] = fmaxf(red[r][0], __shfl_xor_sync(0xffffffffu, red[r][0], 2));
    m_next[r] = fmaxf(m[r], red[r][0]);
    alpha[r] = ex2_approx(m[r] - m_next[r]);
  }
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) s[i] = ex2_approx(s[i] - m_next[(i / 2) % 2]);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < kBlocks; ++n) red[r][n] = s[4 * n + 2 * r] + s[4 * n + 2 * r + 1];
#pragma unroll
  for (int w = kBlocks / 2; w >= 1; w /= 2)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < w; ++n) red[r][n] += red[r][n + w];
#pragma unroll
  for (int r = 0; r < 2; ++r) red[r][0] += __shfl_xor_sync(0xffffffffu, red[r][0], 1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    red[r][0] += __shfl_xor_sync(0xffffffffu, red[r][0], 2);
    m[r] = m_next[r];
    l[r] = alpha[r] * l[r] + red[r][0];
  }
}

// P as wgmma A fragments, split into p_hi = bf16(p) and p_lo = bf16(p -
// p_hi).  Fragment kk covers kv columns 16 kk .. 16 kk + 15; its registers
// hold (row r0, block 2kk), (r8, 2kk), (r0, 2kk + 1), (r8, 2kk + 1).
__device__ __forceinline__ void split_p(const float (&s)[kSRegs], uint32_t (&p_hi)[kPSteps][4],
                                        uint32_t (&p_lo)[kPSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < kPSteps; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * (2 * kk + half) + 2 * r;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[i], s[i + 1]);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(s[i] - __low2float(hi),
                                                        s[i + 1] - __high2float(hi));
        p_hi[kk][2 * half + r] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][2 * half + r] = *reinterpret_cast<const uint32_t*>(&lo);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ out, int sq, int skv, int hq, int hkv,
                             int q_offset, int kv_valid, int causal, float scale) {
  using L = WgLayout<D>;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t base = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = base + L::kK;
  const uint32_t s_v = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;                   // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kWgStages;   // + 8 * stage

  const int tid = threadIdx.x;
  // blockIdx.x (heads) varies fastest in launch order, so every head's
  // heaviest causal q tile is launched before any lighter one.
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = q_tile * kWgTileQ;

  const int n_kv =
      kv_tiles(q0, kWgTileQ, kWgTileKV, skv, kv_valid, causal, q_offset);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kWgConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kWgConsumers) {
    // Producer warp: one thread issues every copy.
    if (tid == kWgConsumers) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int sl = 0; sl < L::kSlabs; ++sl)
        tma_load_3d(s_q + sl * L::kQSlab, &q_map, bar_q, sl * kSlabCols, h, b * sq + q0);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kWgStages;
        if (j >= kWgStages) mbar_wait(bar_empty + 8 * st, ((j / kWgStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * L::kKVBytes);
        const int row = b * skv + j * kWgTileKV;
        for (int sl = 0; sl < L::kSlabs; ++sl) {
          const uint32_t off = st * L::kKVBytes + sl * L::kKVSlab;
          tma_load_3d(s_k + off, &k_map, full, sl * kSlabCols, hk, row);
          tma_load_3d(s_v + off, &v_map, full, sl * kSlabCols, hk, row);
        }
      }
    }
    return;
  }

  // Consumers, software-pipelined: while the tensor cores run S_j = q k_j^T
  // and O += P_{j-1} V_{j-1}, the warpgroup waits only for S_j, takes its
  // softmax, then waits for the P V and rescales O by alpha_j.  The two
  // warpgroups run unsynchronised, so one's softmax also runs under the
  // other's products.  (Making them take turns to issue, with named
  // barriers, measured no faster.)
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int col2 = 2 * (lane % 4);
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + lane / 4;
  const uint32_t q_wg = s_q + wg * 64 * 128;  // this warpgroup's rows of each slab
  auto masked = [&](int k0) {  // some column of the tile is masked for some row
    return k0 + kWgTileKV > kv_valid || (causal && k0 + kWgTileKV - 1 > wg_row0 + q_offset);
  };

  float o[D / 2], s[kSRegs];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kSRegs; ++i) s[i] = 0.f;
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e) / sqrt(D)
  float m[2] = {kFlashNegInf, kFlashNegInf};  // in base-2 units
  float l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t p_hi[kPSteps][4], p_lo[kPSteps][4];

  mbar_wait(bar_q, 0);
  mbar_wait(bar_full, 0);
  fence_regs(s);
  wgmma_fence();
  issue_qk<D>(s, q_wg, s_k);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  if (masked(0))
    softmax_tile<kWgTileKV, true>(s, m, l, alpha, 0, row0, col2, kv_valid, causal, q_offset,
                                  scale_log2);
  else
    softmax_tile<kWgTileKV, false>(s, m, l, alpha, 0, row0, col2, kv_valid, causal, q_offset,
                                   scale_log2);
  split_p(s, p_hi, p_lo);  // O is still 0: no rescale

  for (int j = 1; j < n_kv; ++j) {
    const int st = j % kWgStages;
    const int prev = (j - 1) % kWgStages;
    mbar_wait(bar_full + 8 * st, (j / kWgStages) & 1);
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
    issue_qk<D>(s, q_wg, s_k + st * L::kKVBytes);
    wgmma_commit();
    issue_pv<D>(o, p_hi, p_lo, s_v + prev * L::kKVBytes);
    wgmma_commit();
    wgmma_wait<1>();  // S_j is in
    fence_regs(s);
    const int k0 = j * kWgTileKV;
    if (masked(k0))
      softmax_tile<kWgTileKV, true>(s, m, l, alpha, k0, row0, col2, kv_valid, causal, q_offset,
                                    scale_log2);
    else
      softmax_tile<kWgTileKV, false>(s, m, l, alpha, k0, row0, col2, kv_valid, causal, q_offset,
                                     scale_log2);
    // Order the softmax's results before the wait below (volatile
    // statements keep their order), so the softmax overlaps the P V.
    fence_regs(s);
    fence_regs(m);
    fence_regs(l);
    fence_regs(alpha);
    wgmma_wait<0>();  // P_{j-1} V_{j-1} is in
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    mbar_arrive(bar_empty + 8 * prev);
    // Once the row maxima settle, alpha is exactly 1 for every row of the
    // warp and the rescale is skipped.
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[4 * n + 2 * r] *= alpha[r];
          o[4 * n + 2 * r + 1] *= alpha[r];
        }
      }
    }
    split_p(s, p_hi, p_lo);
  }
  fence_regs(o);
  fence_regs(p_hi);
  fence_regs(p_lo);
  wgmma_fence();
  issue_pv<D>(o, p_hi, p_lo, s_v + ((n_kv - 1) % kWgStages) * L::kKVBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(p_hi);
  fence_regs(p_lo);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // __fdividef (2 ulp) rather than '/': the IEEE division's slow path is a
    // called subroutine, and any call makes ptxas serialise every wgmma.
    const float denom = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* row = out + ((size_t)b * sq + row0 + 8 * r) * hq * D + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + col2) = __floats2bfloat162_rn(
          __fdividef(o[4 * n + 2 * r], denom), __fdividef(o[4 * n + 2 * r + 1], denom));
    }
  }
}

// ---------------------------------------------------------------------------
// The split-TF32 tensor-core body (f32 at D in {8, 64, 128}, bf16 at D = 8).
// ---------------------------------------------------------------------------
constexpr int kTfTileQ = 64;                    // q rows per CTA: one consumer warpgroup
constexpr int kTfConsumers = 128;
constexpr int kTfThreads = kTfConsumers + 128;  // and one staging warpgroup

// The launch attention.tf32x3_plan chose at each head width D of
// REPRO_TF32X3_HEAD_DIMS (X(D)...), from kernels/_build.py's defines: the
// kv tile, the ring's slots, the accumulators S's hi.hi is split into,
// whether O's running sum lives in shared memory, and the dynamic shared
// bytes, which TfLayout must reproduce.
#ifndef REPRO_TF32X3_HEAD_DIMS
#error "REPRO_TF32X3_HEAD_DIMS: build through kernels/_build.py, which passes tf32x3_plan"
#endif
template <int D>
struct TfPlan;
#define X(D_)                                                       \
  template <>                                                       \
  struct TfPlan<D_> {                                               \
    static constexpr int kTK = REPRO_TF32X3_TK_##D_;                \
    static constexpr int kStages = REPRO_TF32X3_STAGES_##D_;        \
    static constexpr int kSPieces = REPRO_TF32X3_S_PIECES_##D_;     \
    static constexpr bool kOShared = REPRO_TF32X3_O_SHARED_##D_;    \
    static constexpr size_t kSmem = REPRO_TF32X3_SMEM_##D_;         \
  };
REPRO_TF32X3_HEAD_DIMS
#undef X

// Shared-memory layout in bytes from a 1024-byte-aligned base.  Every
// operand is f32 and K-major (its reduction axis contiguous), stored as
// slabs of 32 columns (128-byte rows), 128-byte swizzled: q_hi and q_lo
// [64][D], then per ring slot k_hi and k_lo [TK][D] and vt_hi and vt_lo
// [D][TK] (V transposed), then, where O_SHARED, O's running sum (64 x D
// f32, o_chunk), then four mbarriers a slot: k_full, k_empty, v_full and
// v_empty.  At D = 8 a slab row holds 8 used columns of 32.
// attention.tf32x3_plan computes the same sizes.
template <int D, int TK, int STAGES, bool O_SHARED = false>
struct TfLayout {
  static constexpr int kSlabsD = (D + 31) / 32;
  static constexpr int kQTile = kTfTileQ * 128 * kSlabsD;
  static constexpr int kKTile = TK * 128 * kSlabsD;
  static constexpr int kVTile = D * 128 * (TK / 32);
  static constexpr int kKLo = kKTile;                  // offsets within a slot
  static constexpr int kVHi = 2 * kKTile;
  static constexpr int kVLo = 2 * kKTile + kVTile;
  static constexpr int kSlot = 2 * kKTile + 2 * kVTile;
  static constexpr int kQLo = kQTile;
  static constexpr int kRing = 2 * kQTile;
  static constexpr int kOSum = kRing + STAGES * kSlot;
  static constexpr int kBar = kOSum + (O_SHARED ? kTfTileQ * D * 4 : 0);  // 4 x [STAGES]
  static constexpr size_t kSmem = kBar + 32 * STAGES + 1024;
  static_assert(TK % 32 == 0 && (TK * D / 4) % 128 == 0 && (TK / 8) * (D / 4) <= 128,
                "a staging thread moves whole 16-byte chunks of k and at most one block of v");
};

// Byte offset of the 16-byte chunk holding columns 4 c4 .. 4 c4 + 3 of row
// `row` in a K-major operand of `rows` rows (32-column slabs, 128-byte
// swizzle: chunk c of row r at chunk c ^ (r % 8) of its 128-byte row).
__device__ __forceinline__ uint32_t swizzled(int rows, int row, int c4) {
  return (c4 >> 3) * rows * 128 + row * 128 + (((c4 & 7) ^ (row & 7)) << 4);
}

// hi = x rounded to the nearest TF32 value (ties away from zero), its 13
// low mantissa bits zero, so that a TF32 product reads it whole; x - hi is
// exact.  Rounding, not clearing the bits, makes lo signed either way: a
// lo of one sign everywhere (clearing) biases the tensor cores' truncating
// sums, which took a causal row of v = 1 to 1 - 2.1e-5 on an H100.
__device__ __forceinline__ float tf32_hi(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Store four values as their hi parts at `hi` and lo parts at `lo`.
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, float a, float b, float c,
                                            float d) {
  const float4 h = make_float4(tf32_hi(a), tf32_hi(b), tf32_hi(c), tf32_hi(d));
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) = make_float4(a - h.x, b - h.y, c - h.z, d - h.w);
}

// One kv tile as a staging thread holds it: kChunks 16-byte chunks of k
// (chunk i = thread + 128 c of the tile, row-major) and one block of 8 kv
// rows x 4 columns of v (which one: v_block).
template <int D, int TK>
struct TfStaged {
  static constexpr int kChunks = TK * D / 4 / 128;
  static constexpr int kVBlocks = (TK / 8) * (D / 4);
  float k[kChunks][4];
  float v[8][4];
};

// The v block of staging thread u: (8-row group n, 4-column group dq).
// Four threads next to each other take four groups of rows, so that a
// warp's stores of vt (store_v_tile) spread over every bank, and a warp's
// loads of one row still cover whole 128-byte lines (8 column groups a
// row); with the columns varying fastest, a warp's 16-byte stores met two
// chunk positions, 16-way conflicts at D = 128.
template <int D, int TK>
__device__ __forceinline__ void v_block(int u, int& n, int& dq) {
  static_assert(TK / 8 >= 4, "four row groups a tile at least");
  n = u % 4 + 4 * (u / D);
  dq = (u / 4) % (D / 4);
}

template <typename T, int D, int TK>
__device__ __forceinline__ void load_kv_tile(TfStaged<D, TK>& t, const T* k_base, const T* v_base,
                                             size_t kv_stride, int k0, int u) {
  using S = TfStaged<D, TK>;
#pragma unroll
  for (int c = 0; c < S::kChunks; ++c) {
    const int i = u + 128 * c;
    load4(k_base + (size_t)(k0 + i / (D / 4)) * kv_stride + (i % (D / 4)) * 4, t.k[c]);
  }
  if (u < S::kVBlocks) {
    int n, dq;
    v_block<D, TK>(u, n, dq);
#pragma unroll
    for (int mm = 0; mm < 8; ++mm)
      load4(v_base + (size_t)(k0 + 8 * n + mm) * kv_stride + dq * 4, t.v[mm]);
  }
}

// Write a staged tile's k into a slot as k_hi and k_lo, in k's own layout.
template <int D, int TK, int STAGES>
__device__ __forceinline__ void store_k_tile(const TfStaged<D, TK>& t, uint8_t* slot, int u) {
  using L = TfLayout<D, TK, STAGES>;
#pragma unroll
  for (int c = 0; c < TfStaged<D, TK>::kChunks; ++c) {
    const int i = u + 128 * c;
    const uint32_t off = swizzled(TK, i / (D / 4), i % (D / 4));
    store_split(slot + off, slot + L::kKLo + off, t.k[c][0], t.k[c][1], t.k[c][2], t.k[c][3]);
  }
}

// Write a staged tile's v into a slot transposed, as vt_hi and vt_lo [D][TK].
// The kv columns of vt are permuted within each group of 8 to match P's
// register fragments (split_p_tf32): kv 8 n + 2 j at column 8 n + j (chunk
// 2 n) and kv 8 n + 2 j + 1 at column 8 n + 4 + j (chunk 2 n + 1).  A
// thread with odd dq writes its odd chunk first: its rows' swizzle differs
// by 4 from its even neighbours', so each store instruction of a warp
// meets 8 chunk positions, every bank.
template <int D, int TK, int STAGES>
__device__ __forceinline__ void store_v_tile(const TfStaged<D, TK>& t, uint8_t* slot, int u) {
  using L = TfLayout<D, TK, STAGES>;
  using S = TfStaged<D, TK>;
  if (u < S::kVBlocks) {
    int n, dq;
    v_block<D, TK>(u, n, dq);
    const bool odd_first = dq & 1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * dq + e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool odd = (h == 1) != odd_first;
        const uint32_t off = swizzled(D, d, 2 * n + odd);
        store_split(slot + L::kVHi + off, slot + L::kVLo + off,
                    odd ? t.v[1][e] : t.v[0][e], odd ? t.v[3][e] : t.v[2][e],
                    odd ? t.v[5][e] : t.v[4][e], odd ? t.v[7][e] : t.v[6][e]);
      }
    }
  }
}

// The tensor cores truncate every sum they carry, toward zero at the
// accumulator's own magnitude: an accumulator that grows over many steps
// loses up to an ulp of itself a step, in one direction.  So no
// accumulator here runs long.  S's hi.hi goes into SP fresh sums, one a
// 32-column slab of D, and the corrections into one more; P V goes into
// a fresh sum a kv tile, added to O's running sum in registers (add_tile),
// where f32 rounds to nearest.  On an H100 at q and k x 3 (logits of std
// ~9) that cut the worst error against f64 from 1.45 to 0.77 of 1e-5 (1 +
// |x|), where the plain f32 version is at 1.98.

// S = q k^T for the warpgroup's 64 q rows and one TK-row kv tile, 8
// columns of D per wgmma: q_hi.k_hi into sp[slab] and the corrections
// q_lo.k_hi + q_hi.k_lo into sc, summed by sum_s once they are in.
template <int D, int TK, int SP>
__device__ __forceinline__ void issue_qk_tf32x3(float (&sp)[SP][TK / 2], float (&sc)[TK / 2],
                                                uint32_t q_hi, uint32_t q_lo,
                                                uint32_t k_hi, uint32_t k_lo) {
  constexpr int kSteps = D / 8 / SP;  // wgmma a piece
  static_assert(kSteps * SP * 8 == D, "S's pieces split D evenly");
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t qa = (kk / 4) * (kTfTileQ * 128) + (kk % 4) * 32;
    const uint32_t kb = (kk / 4) * (TK * 128) + (kk % 4) * 32;
    wgmma_tf32_ss<TK>(sc, wgmma_desc(q_lo + qa, 16, 1024), wgmma_desc(k_hi + kb, 16, 1024),
                      kk > 0);
    wgmma_tf32_ss<TK>(sc, wgmma_desc(q_hi + qa, 16, 1024), wgmma_desc(k_lo + kb, 16, 1024), 1);
    wgmma_tf32_ss<TK>(sp[kk / kSteps], wgmma_desc(q_hi + qa, 16, 1024),
                      wgmma_desc(k_hi + kb, 16, 1024), kk % kSteps > 0);
  }
}

// s = the pieces of hi.hi in order, then the corrections.
template <int TK, int SP>
__device__ __forceinline__ void sum_s(float (&s)[TK / 2], const float (&sp)[SP][TK / 2],
                                      const float (&sc)[TK / 2]) {
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) {
    float x = sp[0][i];
#pragma unroll
    for (int p = 1; p < SP; ++p) x += sp[p][i];
    s[i] = x + sc[i];
  }
}

// One kv tile's P V, p_lo.vt_hi + p_hi.vt_lo + p_hi.vt_hi, 8 kv columns per
// wgmma, into a fresh sum ot.
template <int D, int TK>
__device__ __forceinline__ void issue_pv_tf32x3(float (&ot)[D / 2],
                                                const uint32_t (&p_hi)[TK / 8][4],
                                                const uint32_t (&p_lo)[TK / 8][4],
                                                uint32_t vt_hi, uint32_t vt_lo) {
#pragma unroll
  for (int kk = 0; kk < TK / 8; ++kk) {
    const uint32_t off = (kk / 4) * (D * 128) + (kk % 4) * 32;
    wgmma_tf32_rs<D>(ot, p_lo[kk], wgmma_desc(vt_hi + off, 16, 1024), kk > 0);
    wgmma_tf32_rs<D>(ot, p_hi[kk], wgmma_desc(vt_lo + off, 16, 1024));
    wgmma_tf32_rs<D>(ot, p_hi[kk], wgmma_desc(vt_hi + off, 16, 1024));
  }
}

// P as tf32 A fragments, split into p_hi and p_lo = p - p_hi.  Fragment kk
// covers kv columns 8 kk .. 8 kk + 7.  A tf32 A fragment holds (row g,
// column t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of its 8 columns (g =
// lane / 4, t = lane % 4), while the S accumulator holds columns 2 t and
// 2 t + 1 of rows g and g + 8: fragment column t carries kv 2 t and column
// t + 4 carries kv 2 t + 1, the order in which store_v_tile writes vt.
template <int TK>
__device__ __forceinline__ void split_p_tf32(const float (&s)[TK / 2],
                                             uint32_t (&p_hi)[TK / 8][4],
                                             uint32_t (&p_lo)[TK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < TK / 8; ++kk) {
    const int idx[4] = {4 * kk, 4 * kk + 2, 4 * kk + 1, 4 * kk + 3};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float hi = tf32_hi(s[idx[e]]);
      p_hi[kk][e] = __float_as_uint(hi);
      p_lo[kk][e] = __float_as_uint(s[idx[e]] - hi);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTfThreads, 1)
flash_attention_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
                              int hq, int hkv, int q_offset, int kv_valid, int causal,
                              float scale) {
  using P = TfPlan<D>;
  constexpr int TK = P::kTK, STAGES = P::kStages, SP = P::kSPieces;
  using L = TfLayout<D, TK, STAGES, P::kOShared>;
  static_assert(L::kSmem == P::kSmem, "attention.tf32x3_plan's shared bytes are TfLayout's");
  extern __shared__ uint8_t tf_smem[];
  const uint32_t base = (smem_addr(tf_smem) + 1023u) & ~1023u;
  uint8_t* const sbase = tf_smem + (base - smem_addr(tf_smem));
  // A slot's k and v halves are filled and freed apart: k is free once
  // its tile's S is in, v only once its P V is, a tile later.
  const uint32_t bar_kfull = base + L::kBar;               // + 8 * slot
  const uint32_t bar_kempty = bar_kfull + 8 * STAGES;
  const uint32_t bar_vfull = bar_kempty + 8 * STAGES;
  const uint32_t bar_vempty = bar_vfull + 8 * STAGES;

  const int tid = threadIdx.x;
  // blockIdx.x (heads) varies fastest in launch order, so every head's
  // heaviest causal q tile is launched before any lighter one.
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = q_tile * kTfTileQ;
  const size_t q_stride = (size_t)hq * D;   // between sequence positions
  const size_t kv_stride = (size_t)hkv * D;
  const int n_kv = kv_tiles(q0, kTfTileQ, TK, skv, kv_valid, causal, q_offset);

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_kfull + 8 * st, 128);
      mbar_init(bar_kempty + 8 * st, kTfConsumers);
      mbar_init(bar_vfull + 8 * st, 128);
      mbar_init(bar_vempty + 8 * st, kTfConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kTfConsumers) {
    // The staging warpgroup: load tile j + 1 while tile j waits for its
    // slot, then split and write tile j's k and publish it, then its v.
    const int u = tid - kTfConsumers;
    const T* k_base = k + (size_t)b * skv * kv_stride + (size_t)hk * D;
    const T* v_base = v + (size_t)b * skv * kv_stride + (size_t)hk * D;
    TfStaged<D, TK> cur, next;
    load_kv_tile<T, D, TK>(cur, k_base, v_base, kv_stride, 0, u);
    for (int j = 0; j < n_kv; ++j) {
      if (j + 1 < n_kv) load_kv_tile<T, D, TK>(next, k_base, v_base, kv_stride, (j + 1) * TK, u);
      const int st = j % STAGES;
      const uint32_t parity = ((j / STAGES) - 1) & 1;
      uint8_t* const slot = sbase + L::kRing + st * L::kSlot;
      if (j >= STAGES) mbar_wait(bar_kempty + 8 * st, parity);
      store_k_tile<D, TK, STAGES>(cur, slot, u);
      fence_proxy_async();  // the generic stores, before the products read them
      mbar_arrive(bar_kfull + 8 * st);
      if (j >= STAGES) mbar_wait(bar_vempty + 8 * st, parity);
      store_v_tile<D, TK, STAGES>(cur, slot, u);
      fence_proxy_async();
      mbar_arrive(bar_vfull + 8 * st);
      cur = next;
    }
    return;
  }

  // The consumer warpgroup: stage q_hi and q_lo once.
  {
    const T* q_base = q + ((size_t)b * sq + q0) * q_stride + (size_t)h * D;
    for (int i = tid; i < kTfTileQ * D / 4; i += kTfConsumers) {
      const int row = i / (D / 4), c4 = i % (D / 4);
      float x[4];
      load4(q_base + (size_t)row * q_stride + c4 * 4, x);
      const uint32_t off = swizzled(kTfTileQ, row, c4);
      store_split(sbase + off, sbase + L::kQLo + off, x[0], x[1], x[2], x[3]);
    }
    fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kTfConsumers) : "memory");
  }

  // Then software-pipelined as the bf16 body: S_j and P_{j-1} V_{j-1} in
  // flight together, the softmax of S_j under the P V.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col2 = 2 * (lane % 4);
  const int row0 = q0 + warp * 16 + lane / 4;
  const uint32_t q_hi = base, q_lo = base + L::kQLo;
  auto slot = [&](int j) { return base + L::kRing + (j % STAGES) * L::kSlot; };
  auto masked = [&](int k0) {  // some column of the tile is masked for some row
    return k0 + TK > kv_valid || (causal && k0 + TK - 1 > q0 + q_offset);
  };

  float ot[D / 2], s[TK / 2], sc[TK / 2], sp[SP][TK / 2];
  // O's running sum, in the accumulator's layout (chunk n: columns 8 n +
  // col2, + 1 of rows row0 and row0 + 8), in registers or, where they run
  // out (O_SHARED: at D = 128 the sum and a tile's ot would take 128),
  // in this thread's slots of shared memory, chunk n at 16 (128 n + tid).
  float o_reg[P::kOShared ? 1 : D / 2];
  float4* const o_shared = reinterpret_cast<float4*>(sbase + L::kOSum) + tid;
  auto o_chunk = [&](int n) {
    if constexpr (P::kOShared)
      return o_shared[128 * n];
    else
      return make_float4(o_reg[4 * n], o_reg[4 * n + 1], o_reg[4 * n + 2], o_reg[4 * n + 3]);
  };
  auto set_o_chunk = [&](int n, float4 x) {
    if constexpr (P::kOShared) {
      o_shared[128 * n] = x;
    } else {
      o_reg[4 * n] = x.x; o_reg[4 * n + 1] = x.y; o_reg[4 * n + 2] = x.z; o_reg[4 * n + 3] = x.w;
    }
  };
  // o = (o + ot) alpha: a finished tile's P V joins the sum, which then
  // moves to the next tile's max.
  auto add_tile = [&](float a0, float a1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float4 x = o_chunk(n);
      x.x = (x.x + ot[4 * n]) * a0;
      x.y = (x.y + ot[4 * n + 1]) * a0;
      x.z = (x.z + ot[4 * n + 2]) * a1;
      x.w = (x.w + ot[4 * n + 3]) * a1;
      set_o_chunk(n, x);
    }
  };
#pragma unroll
  for (int n = 0; n < D / 8; ++n) set_o_chunk(n, make_float4(0.f, 0.f, 0.f, 0.f));
#pragma unroll
  for (int i = 0; i < D / 2; ++i) ot[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) {
    sc[i] = 0.f;
#pragma unroll
    for (int p = 0; p < SP; ++p) sp[p][i] = 0.f;
  }
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e) / sqrt(D)
  float m[2] = {kFlashNegInf, kFlashNegInf};  // in base-2 units
  float l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t p_hi[TK / 8][4], p_lo[TK / 8][4];

  mbar_wait(bar_kfull, 0);
  fence_regs(sp);
  fence_regs(sc);
  wgmma_fence();
  issue_qk_tf32x3<D, TK, SP>(sp, sc, q_hi, q_lo, slot(0), slot(0) + L::kKLo);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sp);
  fence_regs(sc);
  mbar_arrive(bar_kempty);
  sum_s<TK, SP>(s, sp, sc);
  if (masked(0))
    softmax_tile<TK, true>(s, m, l, alpha, 0, row0, col2, kv_valid, causal, q_offset,
                           scale_log2);
  else
    softmax_tile<TK, false>(s, m, l, alpha, 0, row0, col2, kv_valid, causal, q_offset,
                            scale_log2);
  split_p_tf32<TK>(s, p_hi, p_lo);  // O is still 0: no rescale

  for (int j = 1; j < n_kv; ++j) {
    const uint32_t cur = slot(j), prev = slot(j - 1);
    mbar_wait(bar_kfull + 8 * (j % STAGES), (j / STAGES) & 1);
    mbar_wait(bar_vfull + 8 * ((j - 1) % STAGES), ((j - 1) / STAGES) & 1);
    fence_regs(ot);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(sp);
    fence_regs(sc);
    wgmma_fence();
    issue_qk_tf32x3<D, TK, SP>(sp, sc, q_hi, q_lo, cur, cur + L::kKLo);
    wgmma_commit();
    issue_pv_tf32x3<D, TK>(ot, p_hi, p_lo, prev + L::kVHi, prev + L::kVLo);
    wgmma_commit();
    wgmma_wait<1>();  // S_j is in
    fence_regs(sp);
    fence_regs(sc);
    mbar_arrive(bar_kempty + 8 * (j % STAGES));
    sum_s<TK, SP>(s, sp, sc);
    const int k0 = j * TK;
    if (masked(k0))
      softmax_tile<TK, true>(s, m, l, alpha, k0, row0, col2, kv_valid, causal, q_offset,
                             scale_log2);
    else
      softmax_tile<TK, false>(s, m, l, alpha, k0, row0, col2, kv_valid, causal, q_offset,
                              scale_log2);
    fence_regs(s);
    fence_regs(m);
    fence_regs(l);
    fence_regs(alpha);
    wgmma_wait<0>();  // P_{j-1} V_{j-1} is in
    fence_regs(ot);
    fence_regs(p_hi);
    fence_regs(p_lo);
    mbar_arrive(bar_vempty + 8 * ((j - 1) % STAGES));
    add_tile(alpha[0], alpha[1]);
    split_p_tf32<TK>(s, p_hi, p_lo);
  }
  mbar_wait(bar_vfull + 8 * ((n_kv - 1) % STAGES), ((n_kv - 1) / STAGES) & 1);
  fence_regs(ot);
  fence_regs(p_hi);
  fence_regs(p_lo);
  wgmma_fence();
  {
    const uint32_t last = slot(n_kv - 1);
    issue_pv_tf32x3<D, TK>(ot, p_hi, p_lo, last + L::kVHi, last + L::kVLo);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(ot);
  fence_regs(p_hi);
  fence_regs(p_lo);

  // out = (o + the last tile's P V) / l
  // __fdividef, as in the bf16 body: no called division subroutine
  const float denom[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
  T* const row = out + ((size_t)b * sq + row0) * q_stride + (size_t)h * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float4 x = o_chunk(n);
    store2(row + 8 * n + col2, __fdividef(x.x + ot[4 * n], denom[0]),
           __fdividef(x.y + ot[4 * n + 1], denom[0]));
    store2(row + 8 * q_stride + 8 * n + col2, __fdividef(x.z + ot[4 * n + 2], denom[1]),
           __fdividef(x.w + ot[4 * n + 3], denom[1]));
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the library needs no link against libcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map of a row-major [B, S, H, D] bf16 tensor seen as [B * S, H, D] whose
// box is `box_rows` positions x one head x 64 columns, 128-byte swizzled.
static bool head_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int d, int heads,
                     long long rows, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kSlabCols, 1, (cuuint32_t)box_rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_flash_wgmma(const void* q, const void* k, const void* v, void* out, int bsz,
                               int sq, int skv, int hq, int hkv, int q_offset, int kv_valid,
                               int causal, float scale, cudaStream_t stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map;
  if (!head_map(encode, &q_map, q, D, hq, (long long)bsz * sq, kWgTileQ) ||
      !head_map(encode, &k_map, k, D, hkv, (long long)bsz * skv, kWgTileKV) ||
      !head_map(encode, &v_map, v, D, hkv, (long long)bsz * skv, kWgTileKV))
    return cudaErrorInvalidValue;
  const size_t smem = WgLayout<D>::kSmem;
  cudaError_t err = allow_smem(flash_attention_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bsz * hq, sq / kWgTileQ);
  flash_attention_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), sq, skv, hq, hkv, q_offset,
      kv_valid, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_flash_tf32x3(const void* q, const void* k, const void* v, void* out,
                                int bsz, int sq, int skv, int hq, int hkv, int q_offset,
                                int kv_valid, int causal, float scale, cudaStream_t stream) {
  if (skv % TfPlan<D>::kTK) return cudaErrorInvalidValue;
  const size_t smem = TfPlan<D>::kSmem;
  cudaError_t err = allow_smem(flash_attention_tf32x3_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bsz * hq, sq / kTfTileQ);
  flash_attention_tf32x3_kernel<T, D><<<grid, kTfThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, hq, hkv, q_offset, kv_valid, causal, scale);
  return cudaGetLastError();
}

}  // namespace repro

// The tf32x3 body: f32 at each head width of REPRO_TF32X3_HEAD_DIMS, bf16 at
// D = 8.  Skv must be positive: a q tile starts from its first kv tile.
extern "C" int repro_flash_attention_tf32x3(const void* q, const void* k, const void* v,
                                            void* out, int bsz, int sq, int skv, int hq,
                                            int hkv, int d, int q_offset, int kv_valid,
                                            int causal, float scale, int dtype, void* stream) {
  if (bsz <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv || sq % repro::kTfTileQ || skv <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_TF32X3_ARGS \
  q, k, v, out, bsz, sq, skv, hq, hkv, q_offset, kv_valid, causal, scale, s
  if (dtype == repro::kDtypeF32) {
#define X(D_) \
  if (d == D_) return repro::launch_flash_tf32x3<float, D_>(REPRO_TF32X3_ARGS);
    REPRO_TF32X3_HEAD_DIMS
#undef X
  }
  if (dtype == repro::kDtypeBF16 && d == 8)
    return repro::launch_flash_tf32x3<__nv_bfloat16, 8>(REPRO_TF32X3_ARGS);
#undef REPRO_TF32X3_ARGS
  return cudaErrorInvalidValue;
}

// The wgmma body: bf16 at D in {64, 128}.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                           void* out, int bsz, int sq, int skv, int hq,
                                           int hkv, int d, int q_offset, int kv_valid,
                                           int causal, float scale, int dtype, void* stream) {
  if (bsz <= 0 || sq <= 0 || hq <= 0) return 0;
  if (dtype != repro::kDtypeBF16 || hkv <= 0 || hq % hkv || sq % repro::kWgTileQ ||
      skv <= 0 || skv % repro::kWgTileKV)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return repro::launch_flash_wgmma<64>(q, k, v, out, bsz, sq, skv, hq, hkv, q_offset,
                                         kv_valid, causal, scale, s);
  if (d == 128)
    return repro::launch_flash_wgmma<128>(q, k, v, out, bsz, sq, skv, hq, hkv, q_offset,
                                          kv_valid, causal, scale, s);
  return cudaErrorInvalidValue;
}
