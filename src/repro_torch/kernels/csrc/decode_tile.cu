// Fused NTTD decode of a [B, T] tile of folded indices -> [B] values.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_tile.py:decode_tile
// (body _kernel).  Per entry: gather x_t = emb[t, idx[:, t]] (an index
// outside [0, M) gathers a zero row, as the TPU's one-hot gather did),
// run the (i, f, g, o) LSTM cell, and interleave the TT chain with it:
// v = h_0 W_first + b_first; v <- v (h_t W_mid + b_mid) for the middle
// steps; out = v . (h_{T-1} W_last + b_last).  All math in f32; the output
// is cast to the embedding dtype.
//
// Bound: operations.  At T = 10, H = 16, R = 8 an entry needs ~58k FP32
// FLOP against 44 bytes of index and output, so the FP32 pipes, not HBM,
// are the limit, and what the kernel must save is instructions that are
// not FMAs.  Design:
// * H and R are template parameters, instantiated for the codec's own
//   architectures: (12, 8) holds 12/6 (paper SMALL) and 8/8 and 5/5,
//   (16, 8) the default 16/8, (20, 12) 18/10 (paper MEDIUM), (32, 16) the
//   hidden = 2 rank shapes up to rank 16, (64, 32) the largest shape
//   tested.  Any other shape is padded with zero weights to the smallest
//   bucket that holds it (a padded hidden unit keeps c = h = 0 exactly, a
//   padded rank column v = 0); the codec pads once per payload.
// * One thread owns one entry for all T steps.  Its state (h, c, v and
//   the gate sums of four hidden units at a time) lives in registers,
//   unrolled over the compile-time H and R, so every FMA takes its state
//   operand from a register.  The kernel is held back by latency (shared
//   loads, the special-function unit) more than by issue, so warps per SM
//   matter most: two entries a thread (each weight feeding both) took
//   226-235 registers at H 16, R 8 and ran slower, and so did fewer blocks.
//   The (12, 8) and (16, 8) buckets ask for four blocks (128 registers a
//   thread), which they meet without spilling; the input row x is re-read
//   from L1 per block of units instead of held, and the entry index is
//   32-bit, to fit.  (20, 12) asks for three, the larger buckets for two.
// * The weights are staged once per block into shared memory as f32 and
//   read as float4 broadcasts: every thread of a warp reads the same
//   address, so one 16-byte shared load feeds four FMAs.  The constant
//   bank was the other choice, as direct FFMA operands, but its cache
//   holds a working set of 8 KB a SM (the (16, 8) weights are 13.6 KB),
//   and the bank must be rewritten before every launch; shared memory takes
//   every bucket's weights but w_mid at H 64, R 32 (256 KB), which that
//   bucket reads as float4 broadcasts from L1.
// * The R x R mid core is never built: each row r of it is formed on the
//   fly, R sums wide, and folded into v_new at once.
// * Buckets with large H or R keep their outer loops rolled (the gate
//   blocks at H > 20, the mid rows at R > 12) so the code stays small;
//   their state arrays indexed by those loops then live in local memory.
// * The LSTM cell (gate sums, staged-weight reads, the step) is
//   lstm_cell.cuh's, shared with the LSTM scan's register body (lstm.cu).
//
// This unit is compiled once per bucket and dtype, with -DREPRO_DECODE_T,
// -DREPRO_DECODE_H and -DREPRO_DECODE_R naming them (kernels/_build.py);
// decode_tile_dispatch.cu holds the C entry point that picks the bucket.
#if !defined(REPRO_DECODE_T) || !defined(REPRO_DECODE_H) || !defined(REPRO_DECODE_R)
#error "decode_tile.cu is built per bucket: define REPRO_DECODE_T, REPRO_DECODE_H, REPRO_DECODE_R"
#endif

#include "decode_tile.cuh"
#include "lstm_cell.cuh"

namespace repro {

constexpr int kDecodeThreads = 128;
// shared memory a block may opt into on Hopper, in floats
constexpr int kMaxSmemFloats = 232448 / 4;

template <int H, int R>
struct DecodeBucket {
  // staged weight arrays, in this order: wi, wh [H][4H], b [4H],
  // w_first, w_last [H][R], b_first, b_last [R], b_mid [R * R], w_mid [H][R * R]
  static constexpr int kSmallFloats = 8 * H * H + 4 * H + 2 * H * R + 2 * R + R * R;
  static constexpr bool kMidInSmem = kSmallFloats + H * R * R <= kMaxSmemFloats;
  static constexpr int kSmemFloats = kSmallFloats + (kMidInSmem ? H * R * R : 0);
  static constexpr int kUnrollMid = R <= 12 ? R : 1;
  // blocks per SM the register budget must leave room for: four at
  // H <= 16, R <= 8 (at most 128 registers a thread, 16 warps), three at
  // H <= 20, R <= 12 (168 registers), two above (255 registers)
  static constexpr int kMinBlocks = (H <= 16 && R <= 8) ? 4 : (H <= 20 && R <= 12) ? 3 : 2;
  static_assert(H % 4 == 0 && R % 4 == 0, "bucket widths are multiples of 4");
};

template <typename T, int N>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int tid) {
  for (int i = tid; i < N; i += kDecodeThreads) dst[i] = load_f(src + i);
}

template <typename T, int H, int R>
__global__ void __launch_bounds__(kDecodeThreads, (DecodeBucket<H, R>::kMinBlocks))
decode_tile_kernel(const int* __restrict__ idx, const T* __restrict__ emb,
                   const T* __restrict__ wi, const T* __restrict__ wh,
                   const T* __restrict__ b, const T* __restrict__ w_first,
                   const T* __restrict__ b_first, const T* __restrict__ w_mid,
                   const T* __restrict__ b_mid, const T* __restrict__ w_last,
                   const T* __restrict__ b_last, T* __restrict__ out, long long bsz,
                   int t_steps, int m_rows) {
  using Bk = DecodeBucket<H, R>;
  constexpr int H4 = 4 * H;
  constexpr int RR = R * R;
  extern __shared__ float4 decode_smem[];
  float* s_wi = reinterpret_cast<float*>(decode_smem);
  float* s_wh = s_wi + H * H4;
  float* s_b = s_wh + H * H4;
  float* s_wf = s_b + H4;
  float* s_wl = s_wf + H * R;
  float* s_bf = s_wl + H * R;
  float* s_bl = s_bf + R;
  float* s_bm = s_bl + R;
  float* s_wm = s_bm + RR;

  const int tid = threadIdx.x;
  stage<T, H * H4>(s_wi, wi, tid);
  stage<T, H * H4>(s_wh, wh, tid);
  stage<T, H4>(s_b, b, tid);
  stage<T, H * R>(s_wf, w_first, tid);
  stage<T, H * R>(s_wl, w_last, tid);
  stage<T, R>(s_bf, b_first, tid);
  stage<T, R>(s_bl, b_last, tid);
  stage<T, RR>(s_bm, b_mid, tid);
  if constexpr (Bk::kMidInSmem) stage<T, H * RR>(s_wm, w_mid, tid);
  __syncthreads();

  const int e = blockIdx.x * kDecodeThreads + tid;  // bsz < 2^31: the launcher checks
  if (e >= bsz) return;

  float h[H], c[H], v[R];
#pragma unroll
  for (int k = 0; k < H; ++k) h[k] = c[k] = 0.f;
  for (int t = 0; t < t_steps; ++t) {
    const int ix = idx[(size_t)e * t_steps + t];
    const bool ok = ix >= 0 && ix < m_rows;
    const T* row = emb + ((size_t)t * m_rows + (ok ? ix : 0)) * H;

    // LSTM cell (lstm_cell.cuh); the embedding row x (zero when the index
    // is out of range) is re-read from L1 four values at a time for each
    // block of units rather than held in H more registers.
    lstm_step<LdgX, H>(h, c, row, ok, s_wi, s_wh, s_b);

    if (t == 0) {
#pragma unroll
      for (int s = 0; s < R; s += 4) {
        float4 a = ld4(s_bf + s);
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const float4 w = ld4(s_wf + k * R + s);
          a.x = fmaf(h[k], w.x, a.x); a.y = fmaf(h[k], w.y, a.y);
          a.z = fmaf(h[k], w.z, a.z); a.w = fmaf(h[k], w.w, a.w);
        }
        v[s] = a.x; v[s + 1] = a.y; v[s + 2] = a.z; v[s + 3] = a.w;
      }
    } else if (t == t_steps - 1) {
      float o = 0.f;
#pragma unroll
      for (int s = 0; s < R; s += 4) {
        float4 a = ld4(s_bl + s);
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const float4 w = ld4(s_wl + k * R + s);
          a.x = fmaf(h[k], w.x, a.x); a.y = fmaf(h[k], w.y, a.y);
          a.z = fmaf(h[k], w.z, a.z); a.w = fmaf(h[k], w.w, a.w);
        }
        o = fmaf(v[s], a.x, o); o = fmaf(v[s + 1], a.y, o);
        o = fmaf(v[s + 2], a.z, o); o = fmaf(v[s + 3], a.w, o);
      }
      store_f(out + e, o);
    } else {
      // v_new[s] = sum_r v[r] (b_mid[r R + s] + sum_k h[k] W_mid[k][r R + s])
      float vn[R];
#pragma unroll
      for (int s = 0; s < R; ++s) vn[s] = 0.f;
#pragma unroll (Bk::kUnrollMid)
      for (int r = 0; r < R; ++r) {
        float mr[R];
#pragma unroll
        for (int s = 0; s < R; s += 4) {
          const float4 bm = ld4(s_bm + r * R + s);
          mr[s] = bm.x; mr[s + 1] = bm.y; mr[s + 2] = bm.z; mr[s + 3] = bm.w;
        }
#pragma unroll
        for (int k = 0; k < H; ++k) {
#pragma unroll
          for (int s = 0; s < R; s += 4) {
            const float4 w = Bk::kMidInSmem ? ld4(s_wm + k * RR + r * R + s)
                                            : ldg4(w_mid + (size_t)k * RR + r * R + s);
            mr[s] = fmaf(h[k], w.x, mr[s]);
            mr[s + 1] = fmaf(h[k], w.y, mr[s + 1]);
            mr[s + 2] = fmaf(h[k], w.z, mr[s + 2]);
            mr[s + 3] = fmaf(h[k], w.w, mr[s + 3]);
          }
        }
        const float vr = v[r];
#pragma unroll
        for (int s = 0; s < R; ++s) vn[s] = fmaf(vr, mr[s], vn[s]);
      }
#pragma unroll
      for (int s = 0; s < R; ++s) v[s] = vn[s];
    }
  }
}

template <typename T, int H, int R>
cudaError_t launch_decode_tile(const void* idx, const void* emb, const void* wi,
                               const void* wh, const void* b, const void* wf,
                               const void* bf, const void* wm, const void* bm,
                               const void* wl, const void* bl, void* out, long long bsz,
                               int t_steps, int m_rows, cudaStream_t stream) {
  const size_t smem = (size_t)DecodeBucket<H, R>::kSmemFloats * sizeof(float);
  cudaError_t err = allow_smem(decode_tile_kernel<T, H, R>, smem);
  if (err != cudaSuccess) return err;
  decode_tile_kernel<T, H, R><<<grid_for(bsz, kDecodeThreads), kDecodeThreads, smem, stream>>>(
      static_cast<const int*>(idx), static_cast<const T*>(emb), static_cast<const T*>(wi),
      static_cast<const T*>(wh), static_cast<const T*>(b), static_cast<const T*>(wf),
      static_cast<const T*>(bf), static_cast<const T*>(wm), static_cast<const T*>(bm),
      static_cast<const T*>(wl), static_cast<const T*>(bl), static_cast<T*>(out), bsz,
      t_steps, m_rows);
  return cudaGetLastError();
}

template cudaError_t launch_decode_tile<REPRO_DECODE_T, REPRO_DECODE_H, REPRO_DECODE_R>(
    const void*, const void*, const void*, const void*, const void*, const void*, const void*,
    const void*, const void*, const void*, const void*, void*, long long, int, int,
    cudaStream_t);

}  // namespace repro
