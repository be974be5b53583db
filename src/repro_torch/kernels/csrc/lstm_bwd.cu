// Backward of the LSTM scan (lstm.cu, lstm_dispatch.cu), backpropagation
// through the T steps: from x [B, T, H], the weights wi, wh [H, 4H] and b
// [4H], the forward's hidden states hs [B, T, H] and their gradient dhs, it
// writes dG [B, T, 4H], the gradient of every step's gate pre-activations
// (i, f, g, o).  The caller turns dG into dx = dG wi^T, dwi = x^T dG,
// dwh = h_prev^T dG and db = sum dG with plain matrix products over B T:
// they do not recur.  f32 only, H <= 256 (kMaxHidden).
//
// Replaces the backward of the Pallas TPU kernel repro/kernels/lstm.py:
// lstm_scan (body _kernel).  The JAX package defines no custom_vjp: its
// gradient is jax.grad of the jnp oracle.
//
// Bound: operations, like the forward: 16 H^2 FLOP a sequence and step to
// recompute the gates and 8 H^2 for the recurrent product dG_t wh^T,
// against 7 H floats of x, hs, dhs and dG.
//
// Design: a block owns a tile of TB sequences (TB = 4 x max(1, 128 / H),
// kernels/lstm.py:bwd_tile) for all T steps; a work item is one hidden unit
// of 4 sequences, items w = eg H + j, so a warp's lanes hold neighbouring
// units and read neighbouring weights.  Shared memory holds the tile's
// operands transposed, [row][sequence] (row stride TB + 4), each item's 4
// sequences one 16-byte load.
// * Phase 1, t = 0 .. T-1, the forward recomputed: the gates of step t are
//   [x_t | h_{t-1}] . [wi; wh] + b, with h_{t-1} the saved hs[:, t-1] (0 at
//   t = 0), so no step waits on another's product; an item keeps c of its
//   unit in shared memory, stores the activated gates (i, f, g, o) into dG
//   and c_t into a scratch [B, T, H].
// * Phase 2, t = T-1 .. 0, the reverse sweep: dh = dhs_t + dh_rec, dc =
//   dc_carry + dh o (1 - tanh^2 c_t), then the gate derivatives; f scales
//   c_{t-1} and carries dc back (dc_carry = dc f), tanh acts on c_t.  dG_t
//   overwrites the activations in dG (the item that stored them reads
//   them back, so no barrier is needed) and goes to shared memory, and
//   dh_rec = dG_t . wh^T is one product over the tile: an item sums 4H
//   terms for its unit, reading wh^T [4H, H] (the wrapper's transposed
//   copy) coalesced along the units.
// The weights are read through the read-only cache.  Every sum runs inside
// one sequence, so there are no atomics.
#include <climits>

#include "common.cuh"

namespace repro {

constexpr int kLstmBwdThreads = 128;
constexpr int kLstmBwdSeqs = 4;  // sequences of a work item
constexpr int kLstmBwdMaxHidden = 256;

__device__ __forceinline__ float sigmoid_bwd(float x) { return 1.0f / (1.0f + expf(-x)); }

// floats of a block's shared memory: phase 2's dG (4H rows), dh_rec and
// dc_carry (H rows each), each row TB + 4 floats; phase 1 uses half
__host__ inline long long lstm_bwd_smem_floats(int hid, int tile) {
  return 6LL * hid * (tile + 4);
}

__global__ void __launch_bounds__(kLstmBwdThreads)
lstm_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wi,
                     const float* __restrict__ wh, const float* __restrict__ b,
                     const float* __restrict__ hs, const float* __restrict__ dhs,
                     const float* __restrict__ wht, float* __restrict__ dg,
                     float* __restrict__ cbuf, long long bsz, int t_steps, int hid, int tile) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = kLstmBwdSeqs;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int lda = tile + 4, h4 = 4 * hid;
  const int items = hid * (tile / S);
  const long long e0 = (long long)blockIdx.x * tile;
  float* as = smem;                // phase 1: [2H][lda], x_t rows then h_{t-1} rows
  float* cs = as + 2 * hid * lda;  // phase 1: [H][lda], c of the step before
  float* dgs = smem;               // phase 2: [4H][lda], dG_t
  float* dhr = dgs + h4 * lda;     // phase 2: [H][lda], dh from step t + 1
  float* dcs = dhr + hid * lda;    // phase 2: [H][lda], dc carried from step t + 1

  // ---- phase 1: the forward, recomputed from the saved h
  for (int f = tid; f < hid * lda; f += nt) cs[f] = 0.f;
  for (int t = 0; t < t_steps; ++t) {
    __syncthreads();  // every item is done with the last step's operands
    for (int e = warp; e < tile; e += nwarps) {
      const long long ge = e0 + e;
      const bool ok = ge < bsz;
      const size_t row = ((size_t)(ok ? ge : 0) * t_steps + t) * hid;
      for (int k = lane; k < hid; k += 32) {
        as[k * lda + e] = ok ? __ldg(x + row + k) : 0.f;
        as[(hid + k) * lda + e] = ok && t > 0 ? __ldg(hs + row - hid + k) : 0.f;
      }
    }
    __syncthreads();
    for (int w = tid; w < items; w += nt) {
      const int j = w % hid, col = (w / hid) * S;
      float acc[4][S];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[g][s] = 0.f;
      for (int k = 0; k < 2 * hid; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(as + k * lda + col);
        const float a[S] = {a4.x, a4.y, a4.z, a4.w};
        const float* wr = k < hid ? wi + (size_t)k * h4 : wh + (size_t)(k - hid) * h4;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float wv = __ldg(wr + g * hid + j);
#pragma unroll
          for (int s = 0; s < S; ++s) acc[g][s] = fmaf(a[s], wv, acc[g][s]);
        }
      }
      const float bi = __ldg(b + j), bf = __ldg(b + hid + j);
      const float bg = __ldg(b + 2 * hid + j), bo = __ldg(b + 3 * hid + j);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float gi = sigmoid_bwd(acc[0][s] + bi);
        const float gf = sigmoid_bwd(acc[1][s] + bf);
        const float gg = tanhf(acc[2][s] + bg);
        const float go = sigmoid_bwd(acc[3][s] + bo);
        float* cp = cs + j * lda + col + s;
        const float c = gf * *cp + gi * gg;
        *cp = c;
        const long long ge = e0 + col + s;
        if (ge < bsz) {
          const size_t bt = (size_t)ge * t_steps + t;
          float* d = dg + bt * h4 + j;
          d[0] = gi;
          d[hid] = gf;
          d[2 * hid] = gg;
          d[3 * hid] = go;
          cbuf[bt * hid + j] = c;
        }
      }
    }
  }
  __syncthreads();  // phase 2 reuses the shared memory
  for (int f = tid; f < 2 * hid * lda; f += nt) dhr[f] = 0.f;  // dh_rec and dc_carry
  __syncthreads();

  // ---- phase 2: the reverse sweep
  for (int t = t_steps - 1; t >= 0; --t) {
    for (int w = tid; w < items; w += nt) {
      const int j = w % hid, col = (w / hid) * S;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const long long ge = e0 + col + s;
        const int at = j * lda + col + s;
        float dai = 0.f, daf = 0.f, dag = 0.f, dao = 0.f;
        if (ge < bsz) {
          const size_t bt = (size_t)ge * t_steps + t;
          float* d = dg + bt * h4 + j;
          const float gi = d[0], gf = d[hid], gg = d[2 * hid], go = d[3 * hid];
          const float c = cbuf[bt * hid + j];
          const float c_prev = t > 0 ? cbuf[(bt - 1) * hid + j] : 0.f;
          const float dh = __ldg(dhs + bt * hid + j) + dhr[at];
          const float tc = tanhf(c);
          const float dc = dcs[at] + dh * go * (1.f - tc * tc);
          dcs[at] = dc * gf;
          dai = dc * gg * gi * (1.f - gi);
          daf = dc * c_prev * gf * (1.f - gf);
          dag = dc * gi * (1.f - gg * gg);
          dao = dh * tc * go * (1.f - go);
          d[0] = dai;
          d[hid] = daf;
          d[2 * hid] = dag;
          d[3 * hid] = dao;
        }
        dgs[at] = dai;
        dgs[hid * lda + at] = daf;
        dgs[2 * hid * lda + at] = dag;
        dgs[3 * hid * lda + at] = dao;
      }
    }
    if (t == 0) break;
    __syncthreads();  // dG_t of every unit is in
    for (int w = tid; w < items; w += nt) {
      const int k = w % hid, col = (w / hid) * S;
      float acc[S] = {0.f, 0.f, 0.f, 0.f};
      for (int jj = 0; jj < h4; ++jj) {
        const float4 a4 = *reinterpret_cast<const float4*>(dgs + jj * lda + col);
        const float wv = __ldg(wht + (size_t)jj * hid + k);
        acc[0] = fmaf(a4.x, wv, acc[0]);
        acc[1] = fmaf(a4.y, wv, acc[1]);
        acc[2] = fmaf(a4.z, wv, acc[2]);
        acc[3] = fmaf(a4.w, wv, acc[3]);
      }
      // the item of unit k reads these at step t - 1: the same thread
      *reinterpret_cast<float4*>(dhr + k * lda + col) = make_float4(acc[0], acc[1], acc[2],
                                                                   acc[3]);
    }
    __syncthreads();  // every item is done reading dG_t
  }
}

}  // namespace repro

// f32 only.  tile: sequences a block owns, a multiple of 4
// (kernels/lstm.py:bwd_tile).  wht: wh transposed, [4H, H].  cbuf: scratch
// [B, T, H].
extern "C" int repro_lstm_scan_bwd(const void* x, const void* wi, const void* wh, const void* b,
                                   const void* hs, const void* dhs, const void* wht, void* dg,
                                   void* cbuf, long long bsz, int t_steps, int hid, int tile,
                                   void* stream) {
  if (bsz <= 0 || t_steps <= 0) return 0;
  if (hid < 1 || hid > repro::kLstmBwdMaxHidden || tile < repro::kLstmBwdSeqs ||
      tile % repro::kLstmBwdSeqs || bsz > INT_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)repro::lstm_bwd_smem_floats(hid, tile) * sizeof(float);
  cudaError_t err = repro::allow_smem(repro::lstm_scan_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  repro::lstm_scan_bwd_kernel<<<repro::grid_for(bsz, tile), repro::kLstmBwdThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wi),
      static_cast<const float*>(wh), static_cast<const float*>(b),
      static_cast<const float*>(hs), static_cast<const float*>(dhs),
      static_cast<const float*>(wht), static_cast<float*>(dg), static_cast<float*>(cbuf), bsz,
      t_steps, hid, tile);
  return cudaGetLastError();
}
