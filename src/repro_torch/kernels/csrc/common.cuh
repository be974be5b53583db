// Helpers shared by the decode kernels: typed loads through the read-only
// cache, typed stores, the (i, f, g, o) LSTM cell and the launch plumbing.
//
// Every kernel keeps one entry per thread.  A thread's running state (the
// LSTM h and c, its input row, the TT row vector) lives in dynamic shared
// memory laid out column-wise, element k of thread tid at [k * nt + tid],
// so neighbouring threads touch neighbouring banks.  Weights are read with
// __ldg: every thread of a warp reads the same weight at the same time, so
// each load is one broadcast from L1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  const unsigned short raw = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(raw));
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// One LSTM step for this thread's entry.  Reads x (sx) and h (sh), updates c
// (sc) in place and writes the new h to shn, then copies it back to sh.
// gates = x @ wi + h @ wh + b, gate order (i, f, g, o) along the 4H axis.
template <typename T>
__device__ __forceinline__ void lstm_cell(const float* sx, float* sh, float* shn, float* sc,
                                          const T* __restrict__ wi, const T* __restrict__ wh,
                                          const T* __restrict__ b, int hid, int nt, int tid) {
  const int h4 = 4 * hid;
  for (int j = 0; j < hid; ++j) {
    float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f;
    float hi = 0.f, hf = 0.f, hg = 0.f, ho = 0.f;
    for (int k = 0; k < hid; ++k) {
      const float xk = sx[k * nt + tid];
      const float hk = sh[k * nt + tid];
      const T* wir = wi + (size_t)k * h4 + j;
      const T* whr = wh + (size_t)k * h4 + j;
      xi = fmaf(xk, load_f(wir), xi);
      xf = fmaf(xk, load_f(wir + hid), xf);
      xg = fmaf(xk, load_f(wir + 2 * hid), xg);
      xo = fmaf(xk, load_f(wir + 3 * hid), xo);
      hi = fmaf(hk, load_f(whr), hi);
      hf = fmaf(hk, load_f(whr + hid), hf);
      hg = fmaf(hk, load_f(whr + 2 * hid), hg);
      ho = fmaf(hk, load_f(whr + 3 * hid), ho);
    }
    const float gi = sigmoid_f((xi + hi) + load_f(b + j));
    const float gf = sigmoid_f((xf + hf) + load_f(b + hid + j));
    const float gg = tanhf((xg + hg) + load_f(b + 2 * hid + j));
    const float go = sigmoid_f((xo + ho) + load_f(b + 3 * hid + j));
    const float c = gf * sc[j * nt + tid] + gi * gg;
    sc[j * nt + tid] = c;
    shn[j * nt + tid] = go * tanhf(c);
  }
  for (int j = 0; j < hid; ++j) sh[j * nt + tid] = shn[j * nt + tid];
}

// Allow more than the default 48 KB of dynamic shared memory when needed.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

__host__ inline unsigned grid_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace repro
