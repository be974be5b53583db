// Causal grouped-query flash attention with an online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/attention.py:flash_attention
// (body _kernel).  q: [B, Sq, Hq, D], k and v: [B, Skv, Hkv, D], f32 or
// bf16, Sq and Skv multiples of the tile; kv head = q head / (Hq / Hkv).
// Per kv tile, exactly as the TPU kernel orders it:
//   s = (q * 1/sqrt(D)) k^T in f32; masked scores become the -1e30 sentinel
//   (columns >= kv_valid, and, when causal, qpos + q_offset < kpos);
//   m_next = max(m, rowmax s); alpha = exp(m - m_next); p = exp(s - m_next);
//   l = alpha l + rowsum p; acc = alpha acc + p v.
// At the end out = acc / l (l == 0 -> 1), cast to q's dtype.  A row whose
// every column is masked keeps m = -1e30, so each of its columns gets
// p = 1 and the row becomes the mean of v over the whole padded kv grid,
// as the TPU kernel computes it.
//
// Bound: operations.  At a prefill of S = 2048, 20 heads, D = 128 the
// causal product is ~21 GFLOP against ~42 MB of q, k, v and out, far above
// the card's ~295 FLOP per byte, so the tensor cores (989 TFLOP/s bf16)
// set the floor.  Design, a first and simple one: one block of 256 threads
// per (batch * q head, 64-row q tile), streaming 64-column kv tiles.  The
// q tile (scaled), the k tile (both transposed, d-major) and the v tile are
// staged in shared memory as f32; each thread owns a 4 x 4 block of the
// score tile and 4 rows x D/16 columns of the accumulator, computed with
// scalar f32 FMAs from float4 shared-memory loads.  Row max and sum are
// reduced across the 16 threads of a row group with warp shuffles.  The
// TPU's sequential grid carried (m, l, acc) in VMEM across kv steps; here
// they stay in registers of the one block that walks all kv tiles.  Tiles
// past the causal diagonal and past kv_valid are skipped when no row of
// the q tile is fully masked: for such rows they add exactly 0.  Tensor
// cores (mma.sync / wgmma) and TMA are left to a later revision.
#include "common.cuh"

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

}  // namespace repro

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
  if (dtype == repro::kDtypeBF16)
    return repro::dispatch_head_dim<__nv_bfloat16>(q, k, v, out, bsz, sq, skv, hq, hkv, d,
                                                   q_offset, kv_valid, causal, scale, s);
  return cudaErrorInvalidValue;
}
