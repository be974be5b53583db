// The gate product over a tile of entries, shared by the two simt bodies:
// the fused decode's (decode_tile_simt.cu) and the LSTM scan's
// (lstm_dispatch.cu).
//
// A block owns a tile of TB entries (a multiple of 8) and keeps their LSTM
// state in shared memory transposed, [unit][entry], so a thread reads the 8
// entries of its tile with two 16-byte loads: entry e sits at column
// ((e % 8) / 4) * TB / 2 + (e / 8) * 4 + e % 4 (entry_column).  gate_phase
// runs one LSTM step of the tile as [TB, 2H] . [wi; wh] [2H, 4H], a
// register-tiled FP32 product whose weights stream through a double buffer
// of shared memory (pipeline), each read once a block a step and used by
// all TB entries.  The bodies size the tile to the shared memory: their
// state and two weight stages of simt_stage_floats.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kSimtEntries = 8;   // entries of one thread's tile
constexpr int kSimtThreads = 512;  // threads a block
constexpr int kMaxSmemBytes = 232448;  // a Hopper block's dynamic shared memory

// Floats of one weight stage: room for 16 gate rows of 4H (capped at 32 KB)
// and at least one K row of every product.  rank is a multiple of 4 here.
__host__ __device__ inline long long simt_stage_floats(int hid, int rank) {
  long long s = 64LL * hid < 8192 ? 64LL * hid : 8192;
  if (s < 4LL * hid + 8) s = 4LL * hid + 8;
  if (s < rank) s = rank;
  return s;
}

// What gate_phase reads of a body's plan (the decode's SimtPlan has the
// same fields among its own).
struct SimtTile {
  int hid, tile, half, eg;  // eg: entry groups of 8
  int stage;                // floats of one weight stage
};

// ------------------------------------------------------------------ staging
// One weight into a stage: f32 through cp.async (4 bytes, zero-filled when
// !ok), bf16 widened through registers.
__device__ __forceinline__ void stage_f(float* dst, const float* src, bool ok) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(a), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void stage_f(float* dst, const __nv_bfloat16* src, bool ok) {
  *dst = ok ? load_f(src) : 0.f;
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void stage_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Run n stages through the double buffer, one barrier a stage: stage s + 1
// is in flight while stage s is computed.  Every thread of the block calls
// it; it returns when every thread is done with the buffer.
template <typename Stage, typename Compute>
__device__ __forceinline__ void pipeline(float* buf, int stage, int n, Stage&& fill,
                                         Compute&& compute) {
  fill(0, buf);
  stage_commit();
  for (int s = 0; s < n; ++s) {
    stage_wait_all();
    __syncthreads();  // stage s is in, and every thread is done with stage s - 1
    if (s + 1 < n) {
      fill(s + 1, buf + ((s + 1) & 1) * stage);
      stage_commit();
    }
    compute(s, buf + (s & 1) * stage);
  }
  __syncthreads();
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// The 8 entries of tile eg in row `row` of a transposed state buffer.
__device__ __forceinline__ void load8(const float* row, int half, int eg, float (&a)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(row + eg * 4);
  const float4 hi = *reinterpret_cast<const float4*>(row + half + eg * 4);
  a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
  a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
}

__device__ __forceinline__ void store8(float* row, int half, int eg, const float (&a)[8]) {
  *reinterpret_cast<float4*>(row + eg * 4) = make_float4(a[0], a[1], a[2], a[3]);
  *reinterpret_cast<float4*>(row + half + eg * 4) = make_float4(a[4], a[5], a[6], a[7]);
}

__device__ __forceinline__ int entry_column(int e, int half) {
  return ((e & 7) >> 2) * half + (e >> 3) * 4 + (e & 3);
}

// ------------------------------------------------------------------ gates
// h_new, c <- LSTM cell of (x, h) for the whole tile.  A thread owns 8
// entries x 2 units x the four gates; tile pair * eg + eg_i, so a warp's
// threads share units (a broadcast of their weights) and read neighbouring
// entries.  A stage holds K rows of the columns of a round's units,
// regrouped: column 8 (pair - pair_lo) + 4 u + g is gate g of unit
// 2 pair + u.  It writes c and h_new after its last barrier: the caller
// synchronises before another thread reads them.
template <typename T, typename Plan>
__device__ void gate_phase(const Plan& p, const float* xs, const float* hs, float* hn,
                           float* cs, float* buf, const T* __restrict__ wi,
                           const T* __restrict__ wh, const T* __restrict__ b) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int hid = p.hid, h4 = 4 * hid, lda = p.tile;
  const int pairs = (hid + 1) / 2, tiles = p.eg * pairs;
  for (int t0 = 0; t0 < tiles; t0 += nt) {
    const int p_lo = t0 / p.eg;
    const int p_hi = min(pairs - 1, (t0 + nt - 1) / p.eg);
    const int ncols = 8 * (p_hi - p_lo + 1);
    const int kb = min(2 * hid, p.stage / ncols);
    const int nstage = (2 * hid + kb - 1) / kb;
    const int tile = t0 + tid;
    const bool active = tile < tiles;
    const int pair = active ? tile / p.eg : p_lo;
    const int eg = tile - pair * p.eg;
    float acc[2][4][8];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[u][g][i] = 0.f;

    auto fill = [&](int s, float* dst) {
      const int k0 = s * kb, rows = min(kb, 2 * hid - k0);
      for (int kk = warp; kk < rows; kk += nwarps) {
        const int k = k0 + kk;
        const T* w = k < hid ? wi + (size_t)k * h4 : wh + (size_t)(k - hid) * h4;
        for (int col = lane; col < ncols; col += 32) {
          const int j = 2 * (p_lo + (col >> 3)) + ((col >> 2) & 1);
          const bool ok = j < hid;
          stage_f(dst + kk * ncols + col, w + (ok ? (col & 3) * hid + j : 0), ok);
        }
      }
    };
    auto compute = [&](int s, const float* cur) {
      if (!active) return;
      const int k0 = s * kb, rows = min(kb, 2 * hid - k0);
      const float* bcol = cur + (pair - p_lo) * 8;
#pragma unroll 2
      for (int kk = 0; kk < rows; ++kk) {
        const int k = k0 + kk;
        const float* arow = k < hid ? xs + k * lda : hs + (k - hid) * lda;
        float a[8];
        load8(arow, p.half, eg, a);
        const float4 b0 = *reinterpret_cast<const float4*>(bcol + kk * ncols);
        const float4 b1 = *reinterpret_cast<const float4*>(bcol + kk * ncols + 4);
        const float bw[2][4] = {{b0.x, b0.y, b0.z, b0.w}, {b1.x, b1.y, b1.z, b1.w}};
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[u][g][i] = fmaf(a[i], bw[u][g], acc[u][g][i]);
      }
    };
    pipeline(buf, p.stage, nstage, fill, compute);

    if (active) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * pair + u;
        if (j >= hid) continue;
        const float bi = load_f(b + j), bf = load_f(b + hid + j);
        const float bg = load_f(b + 2 * hid + j), bo = load_f(b + 3 * hid + j);
        float c[8], h[8];
        load8(cs + j * lda, p.half, eg, c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float gi = sigmoid_f(acc[u][0][i] + bi);
          const float gf = sigmoid_f(acc[u][1][i] + bf);
          const float gg = tanhf(acc[u][2][i] + bg);
          const float go = sigmoid_f(acc[u][3][i] + bo);
          c[i] = gf * c[i] + gi * gg;
          h[i] = go * tanhf(c[i]);
        }
        store8(cs + j * lda, p.half, eg, c);
        store8(hn + j * lda, p.half, eg, h);
      }
    }
  }
}

}  // namespace repro
