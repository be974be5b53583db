// The register-resident (i, f, g, o) LSTM cell shared by the fused NTTD
// decode (decode_tile.cu) and the LSTM scan's register body (lstm.cu).
//
// One thread owns one sequence.  Its h and c live in registers, unrolled
// over the compile-time hidden width H; the weights are staged by the
// caller into shared memory as f32, wi and wh as [H][4H] and b as [4H],
// and read as float4 broadcasts: every thread of a warp reads the same
// address, so one 16-byte shared load feeds four FMAs.  The caller hands
// over the input row x as a pointer and a flag (a row that is not there
// reads as 0), and a Load type whose x4(p) reads p[0 .. 3] as a float4 and
// whose block_start() runs before each block of four units: decode_tile
// reads its gathered embedding row from device memory (LdgX), lstm.cu its
// x row from a shared-memory slot.
#pragma once

#include "common.cuh"

namespace repro {

template <int H>
struct LstmCell {
  // blocks of four hidden units unrolled at H <= 20; larger H keeps the
  // loop rolled so the code stays small (its state arrays indexed by that
  // loop then live in local memory)
  static constexpr int kUnrollGates = H <= 20 ? H / 4 : 1;
  static_assert(H % 4 == 0, "hidden widths are multiples of 4");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four consecutive weights from device memory as floats (read-only path).
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// 1 / (1 + e^-x) with the hardware reciprocal (2 ulp): the IEEE division
// has a called slow path, whose call spills registers.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + expf(-x));
}

// x read from device memory through the read-only path
struct LdgX {
  template <typename T>
  __device__ __forceinline__ static float4 x4(const T* p) { return ldg4(p); }
  __device__ __forceinline__ static void block_start() {}
};

// acc[g][u] = x . wi[:, (g0 + g) H + j0 + u] + h . wh[:, (g0 + g) H + j0 + u]
// for G gates of the four hidden units j0 .. j0 + 3; x is the row at `row`
// (zero when !ok), re-read four values at a time for each block of units
// rather than held in H more registers.
template <typename Load, int H, int G, typename T>
__device__ __forceinline__ void gate_sums(float (&acc)[G][4], int g0, int j0,
                                          const T* __restrict__ row, bool ok,
                                          const float (&h)[H], const float* s_wi,
                                          const float* s_wh) {
  constexpr int H4 = 4 * H;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[g][u] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < H; k0 += 4) {
    const float4 x4 = ok ? Load::x4(row + k0) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k0 + kk;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 a = ld4(s_wi + k * H4 + (g0 + g) * H + j0);
        const float4 w = ld4(s_wh + k * H4 + (g0 + g) * H + j0);
        acc[g][0] = fmaf(x[kk], a.x, acc[g][0]);
        acc[g][1] = fmaf(x[kk], a.y, acc[g][1]);
        acc[g][2] = fmaf(x[kk], a.z, acc[g][2]);
        acc[g][3] = fmaf(x[kk], a.w, acc[g][3]);
        acc[g][0] = fmaf(h[k], w.x, acc[g][0]);
        acc[g][1] = fmaf(h[k], w.y, acc[g][1]);
        acc[g][2] = fmaf(h[k], w.z, acc[g][2]);
        acc[g][3] = fmaf(h[k], w.w, acc[g][3]);
      }
    }
  }
}

// One LSTM step of this thread's sequence, four hidden units (16 gate sums)
// at a time: gates = x . wi + h . wh + b, c = f c + i g, h = o tanh c, with
// h and c updated in registers; x as gate_sums reads it.  s_b is the staged
// bias [4H].
template <typename Load, int H, typename T>
__device__ __forceinline__ void lstm_step(float (&h)[H], float (&c)[H], const T* __restrict__ row,
                                          bool ok, const float* s_wi, const float* s_wh,
                                          const float* s_b) {
  float hn[H];
#pragma unroll (LstmCell<H>::kUnrollGates)
  for (int j0 = 0; j0 < H; j0 += 4) {
    float acc[4][4];
    Load::block_start();
    gate_sums<Load, H, 4>(acc, 0, j0, row, ok, h, s_wi, s_wh);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      const float gi = sigmoid_fast(acc[0][u] + s_b[j]);
      const float gf = sigmoid_fast(acc[1][u] + s_b[H + j]);
      const float gg = tanhf(acc[2][u] + s_b[2 * H + j]);
      const float go = sigmoid_fast(acc[3][u] + s_b[3 * H + j]);
      c[j] = gf * c[j] + gi * gg;
      hn[j] = go * tanhf(c[j]);
    }
  }
#pragma unroll
  for (int k = 0; k < H; ++k) h[k] = hn[k];
}

}  // namespace repro
