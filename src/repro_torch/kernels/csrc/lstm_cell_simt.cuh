// The run-time-width (i, f, g, o) LSTM cell of the LSTM scan's simt body
// (lstm_dispatch.cu).
//
// One thread owns one sequence.  Its state sits in dynamic shared memory,
// column-wise per thread (element k of thread tid at [k * nt + tid], nt the
// block's threads), so H is a run-time value.  The weights come through the
// read-only cache as warp-wide broadcasts, about two loads per FMA.
#pragma once

#include "common.cuh"

namespace repro {

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

}  // namespace repro
