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
// are launched first.
//
// Bound: operations.  At a prefill of S = 2048, 20 heads, D = 128 the
// causal product is ~21 GFLOP against ~42 MB of q, k, v and out, far above
// the card's ~295 FLOP per byte, so the tensor cores (989 TFLOP/s bf16)
// set the floor.  Two bodies, chosen by the wrapper (flash_body):
//
// * wgmma (bf16, D in {64, 128}): one CTA per (batch * q head, 128-row q
//   tile) with two consumer warpgroups of 64 rows and one producer warp.
//   The producer loads the q tile once and fills a five-stage ring of
//   64-row K and V tiles with TMA (128-byte swizzle, mbarrier completion).
//   Each consumer forms S = q k^T with wgmma from shared memory on the
//   unscaled bf16 inputs (exact products, f32 sums), scales s by
//   log2(e)/sqrt(D) in f32 (the softmax is taken in base 2, which differs
//   from exp(s/sqrt(D)) by f32 rounding only), and masks and updates (m, l)
//   in registers.  O += P V runs as wgmma with P from registers and
//   V [kv, D] from shared memory as an MN-major operand (no transpose),
//   overlapped with the next tile's softmax, and the other warpgroup's
//   products overlap it too.  The heaviest causal q tiles of every head
//   launch first.  p stays f32 in
//   effect: it is split
//   into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both products go
//   into the same f32 accumulator, which keeps the TPU kernel's f32 P V to
//   about 2^-16 of p for 1.5x the tensor-core work of one bf16 P V.
// * simt (f32 at any D, and D = 8): one block of 256 threads per
//   (batch * q head, 64-row q tile); q (scaled), k and v staged in shared
//   memory as f32 and multiplied with scalar FMAs.  f32 must hold 1e-5,
//   which neither bf16 nor TF32 tensor cores give, and D = 8 is below
//   wgmma's depth of 16.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {

constexpr int kFlashTileQ = 64;
constexpr int kFlashTileKV = 64;
constexpr int kFlashThreads = 256;  // 16 row groups x 16 threads
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

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
                       int hq, int hkv, int q_offset, int kv_valid, int causal,
                       float scale) {
  constexpr int TQ = kFlashTileQ;
  constexpr int TK = kFlashTileKV;
  constexpr int NCH = D / 4;                 // float4 chunks in a head row
  constexpr int CH_PER = (NCH + 15) / 16;    // chunks of the accumulator per thread
  extern __shared__ float4 flash_smem[];
  float* s_qt = reinterpret_cast<float*>(flash_smem);  // [D][TQ], q * scale
  float* s_kt = s_qt + D * TQ;                         // [D][TK]
  float* s_v = s_kt + D * TK;                          // [TK][D]
  float* s_p = s_v + TK * D;                           // [TQ][TK]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // score columns tx*4.., accumulator chunks tx + 16 jj
  const int ty = tid >> 4;   // rows ty*4 .. ty*4+3
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = q_tile * TQ;
  const size_t q_stride = (size_t)hq * D;   // between sequence positions
  const size_t kv_stride = (size_t)hkv * D;
  const T* q_base = q + ((size_t)b * sq + q0) * q_stride + (size_t)h * D;
  const T* k_base = k + (size_t)b * skv * kv_stride + (size_t)hk * D;
  const T* v_base = v + (size_t)b * skv * kv_stride + (size_t)hk * D;

  for (int i = tid; i < TQ * NCH; i += kFlashThreads) {
    const int r = i % TQ, ch = i / TQ;
    float x[4];
    load4(q_base + (size_t)r * q_stride + ch * 4, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) s_qt[(ch * 4 + e) * TQ + r] = x[e] * scale;
  }

  // Which kv tiles to walk.  A row that sees any column sees column 0, so
  // after the first tile its m is finite and every later fully masked
  // tile adds exp(-1e30 - m) = 0: those tiles may be skipped.  A q tile
  // holding a fully masked row walks them all, as the TPU kernel does.
  int kv_end = skv;
  const bool some_row_masked = kv_valid <= 0 || (causal && q0 + q_offset < 0);
  if (!some_row_masked) {
    long long limit = kv_valid;
    if (causal) limit = min(limit, (long long)q0 + TQ + q_offset);
    kv_end = (int)min((long long)skv, (limit + TK - 1) / TK * TK);
  }

  float m[4], l[4], acc[4][CH_PER * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kFlashNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CH_PER * 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += TK) {
    __syncthreads();  // the previous tile's k, v and p are no longer read
    for (int i = tid; i < TK * NCH; i += kFlashThreads) {
      const int c = i % TK, ch = i / TK;
      float x[4];
      load4(k_base + (size_t)(k0 + c) * kv_stride + ch * 4, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) s_kt[(ch * 4 + e) * TK + c] = x[e];
    }
    for (int i = tid; i < TK * NCH; i += kFlashThreads) {
      const int ch = i % NCH, c = i / NCH;
      float x[4];
      load4(v_base + (size_t)(k0 + c) * kv_stride + ch * 4, x);
      *reinterpret_cast<float4*>(s_v + c * D + ch * 4) = make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(s_qt + d * TQ + ty * 4);
      const float4 kk = *reinterpret_cast<const float4*>(s_kt + d * TK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float row_max = kFlashNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool keep = kpos < kv_valid && (!causal || qpos + q_offset >= kpos);
        if (!keep) s[i][j] = kFlashNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_next = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_next);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_next);
        row_sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      m[i] = m_next;
      l[i] = alpha * l[i] + row_sum;
#pragma unroll
      for (int j = 0; j < CH_PER * 4; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(s_p + (ty * 4 + i) * TK + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < TK; c += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pp = *reinterpret_cast<const float4*>(s_p + (ty * 4 + i) * TK + c);
        p[i][0] = pp.x; p[i][1] = pp.y; p[i][2] = pp.z; p[i][3] = pp.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < CH_PER; ++jj) {
          const int ch = tx + 16 * jj;
          if (ch < NCH) {
            const float4 vv = *reinterpret_cast<const float4*>(s_v + (c + cc) * D + ch * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][jj * 4 + 0] = fmaf(p[i][cc], vv.x, acc[i][jj * 4 + 0]);
              acc[i][jj * 4 + 1] = fmaf(p[i][cc], vv.y, acc[i][jj * 4 + 1]);
              acc[i][jj * 4 + 2] = fmaf(p[i][cc], vv.z, acc[i][jj * 4 + 2]);
              acc[i][jj * 4 + 3] = fmaf(p[i][cc], vv.w, acc[i][jj * 4 + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* row = out + ((size_t)b * sq + q0 + ty * 4 + i) * q_stride + (size_t)h * D;
#pragma unroll
    for (int jj = 0; jj < CH_PER; ++jj) {
      const int ch = tx + 16 * jj;
      if (ch < NCH) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store_f(row + ch * 4 + e, acc[i][jj * 4 + e] / denom);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int bsz, int sq, int skv, int hq, int hkv, int q_offset,
                                   int kv_valid, int causal, float scale,
                                   cudaStream_t stream) {
  const size_t smem =
      (size_t)(3 * D * kFlashTileKV + kFlashTileQ * kFlashTileKV) * sizeof(float);
  cudaError_t err = allow_smem(flash_attention_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(sq / kFlashTileQ, bsz * hq);
  flash_attention_kernel<T, D><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, hq, hkv, q_offset, kv_valid, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* out, int bsz,
                              int sq, int skv, int hq, int hkv, int d, int q_offset,
                              int kv_valid, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 8:
      return launch_flash_attention<T, 8>(q, k, v, out, bsz, sq, skv, hq, hkv, q_offset,
                                          kv_valid, causal, scale, stream);
    case 64:
      return launch_flash_attention<T, 64>(q, k, v, out, bsz, sq, skv, hq, hkv, q_offset,
                                           kv_valid, causal, scale, stream);
    case 128:
      return launch_flash_attention<T, 128>(q, k, v, out, bsz, sq, skv, hq, hkv, q_offset,
                                            kv_valid, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
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

// One S tile in the TPU kernel's order: scale, mask to the sentinel, row
// max, m_next, alpha, p = exp(s - m_next) in place, l.  The scores are kept
// in base 2: s is multiplied by log2(e) / sqrt(D) in f32 (scale_log2), so
// exp(s / sqrt(D) - m) is one ex2 of a difference, and m is kept in the same
// units; masked scores are the -1e30 sentinel there too, so a fully masked
// row still gets p = 2^0 = 1 everywhere.  Each thread holds kSRegs / 2
// values of each of its two rows; both rows go through every step side by
// side and the row max and sum are trees, so the dependent chains stay
// short.  Rows of a quad of threads are then reduced with shuffles.
// kMasked selects the code for tiles that hold a masked score (the causal
// diagonal, the kv_valid edge): a run-time test here would be if-converted
// into compares and selects that every tile then executes.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[kSRegs], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int row0, int col2,
                                             int kv_valid, int causal, int q_offset,
                                             float scale_log2) {
  constexpr int kBlocks = kWgTileKV / 8;  // 8-column blocks of the tile
#pragma unroll
  for (int i = 0; i < kSRegs; ++i) {
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
  for (int i = 0; i < kSRegs; ++i) s[i] = ex2_approx(s[i] - m_next[(i / 2) % 2]);
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

  // Which kv tiles to walk: as in the simt body, all of them when a row of
  // this q tile is fully masked, else up to the diagonal and kv_valid.
  int kv_end = skv;
  const bool some_row_masked = kv_valid <= 0 || (causal && q0 + q_offset < 0);
  if (!some_row_masked) {
    long long limit = kv_valid;
    if (causal) limit = min(limit, (long long)q0 + kWgTileQ + q_offset);
    kv_end = (int)min((long long)skv, (limit + kWgTileKV - 1) / kWgTileKV * kWgTileKV);
  }
  const int n_kv = kv_end / kWgTileKV;

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
    softmax_tile<true>(s, m, l, alpha, 0, row0, col2, kv_valid, causal, q_offset, scale_log2);
  else
    softmax_tile<false>(s, m, l, alpha, 0, row0, col2, kv_valid, causal, q_offset, scale_log2);
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
      softmax_tile<true>(s, m, l, alpha, k0, row0, col2, kv_valid, causal, q_offset,
                         scale_log2);
    else
      softmax_tile<false>(s, m, l, alpha, k0, row0, col2, kv_valid, causal, q_offset,
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

}  // namespace repro

// The simt body: f32 at D in {8, 64, 128}, bf16 at D = 8.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int bsz, int sq, int skv, int hq, int hkv, int d,
                                     int q_offset, int kv_valid, int causal, float scale,
                                     int dtype, void* stream) {
  if (bsz <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv || sq % repro::kFlashTileQ || skv % repro::kFlashTileKV)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32)
    return repro::dispatch_head_dim<float>(q, k, v, out, bsz, sq, skv, hq, hkv, d, q_offset,
                                           kv_valid, causal, scale, s);
  if (dtype == repro::kDtypeBF16 && d == 8)
    return repro::launch_flash_attention<__nv_bfloat16, 8>(q, k, v, out, bsz, sq, skv, hq,
                                                           hkv, q_offset, kv_valid, causal,
                                                           scale, s);
  return cudaErrorInvalidValue;
}

// The wgmma body: bf16 at D in {64, 128}.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                           void* out, int bsz, int sq, int skv, int hq,
                                           int hkv, int d, int q_offset, int kv_valid,
                                           int causal, float scale, int dtype, void* stream) {
  if (bsz <= 0 || sq <= 0 || hq <= 0) return 0;
  if (dtype != repro::kDtypeBF16 || hkv <= 0 || hq % hkv || sq % repro::kWgTileQ ||
      skv % repro::kWgTileKV)
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
