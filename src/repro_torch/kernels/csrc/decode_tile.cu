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
// are the limit.  Design: one thread owns one entry for all T steps, so
// nothing crosses threads and the value is written once.  The TPU kept
// the whole tile in VMEM and ran the grid in order; here blocks carry
// nothing between them.  The thread's state (x, h, h_new, c: 4H floats;
// v, v_new: 2R floats) sits in shared memory, column-wise per thread.  The
// R x R mid core is never built: each v_new[s] = sum_r v[r] (h . W_mid[:, rR
// + s] + b_mid[rR + s]) is formed on the fly, so R = 32 costs no 4 KB of
// state per entry.  Weights stay in device memory and come through the
// read-only cache as warp-wide broadcasts; staging them in shared memory
// (w_mid is 64 KB at H = 16, R = 32) is left to a later revision.
#include "common.cuh"

namespace repro {

constexpr int kDecodeThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
decode_tile_kernel(const int* __restrict__ idx, const T* __restrict__ emb,
                   const T* __restrict__ wi, const T* __restrict__ wh,
                   const T* __restrict__ b, const T* __restrict__ w_first,
                   const T* __restrict__ b_first, const T* __restrict__ w_mid,
                   const T* __restrict__ b_mid, const T* __restrict__ w_last,
                   const T* __restrict__ b_last, T* __restrict__ out, long long bsz,
                   int t_steps, int m_rows, int hid, int rank) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  float* sx = smem;
  float* sh = sx + hid * nt;
  float* shn = sh + hid * nt;
  float* sc = shn + hid * nt;
  float* sv = sc + hid * nt;
  float* svn = sv + rank * nt;
  const long long e = (long long)blockIdx.x * nt + tid;
  if (e >= bsz) return;  // threads never synchronise: each owns its columns

  for (int k = 0; k < hid; ++k) {
    sh[k * nt + tid] = 0.f;
    sc[k * nt + tid] = 0.f;
  }
  const int rr = rank * rank;
  float result = 0.f;
  for (int t = 0; t < t_steps; ++t) {
    const int ix = idx[e * t_steps + t];
    const bool ok = ix >= 0 && ix < m_rows;
    const T* row = emb + ((size_t)t * m_rows + (ok ? ix : 0)) * hid;
    for (int k = 0; k < hid; ++k) sx[k * nt + tid] = ok ? load_f(row + k) : 0.f;
    lstm_cell(sx, sh, shn, sc, wi, wh, b, hid, nt, tid);

    if (t == 0) {
      for (int s = 0; s < rank; ++s) {
        float acc = 0.f;
        for (int k = 0; k < hid; ++k)
          acc = fmaf(sh[k * nt + tid], load_f(w_first + (size_t)k * rank + s), acc);
        sv[s * nt + tid] = acc + load_f(b_first + s);
      }
    } else if (t == t_steps - 1) {
      float o = 0.f;
      for (int s = 0; s < rank; ++s) {
        float acc = 0.f;
        for (int k = 0; k < hid; ++k)
          acc = fmaf(sh[k * nt + tid], load_f(w_last + (size_t)k * rank + s), acc);
        o = fmaf(sv[s * nt + tid], acc + load_f(b_last + s), o);
      }
      result = o;
    } else {
      for (int s = 0; s < rank; ++s) {
        float vs = 0.f;
        for (int r = 0; r < rank; ++r) {
          float acc = 0.f;
          for (int k = 0; k < hid; ++k)
            acc = fmaf(sh[k * nt + tid], load_f(w_mid + (size_t)k * rr + r * rank + s), acc);
          vs = fmaf(sv[r * nt + tid], acc + load_f(b_mid + r * rank + s), vs);
        }
        svn[s * nt + tid] = vs;
      }
      for (int s = 0; s < rank; ++s) sv[s * nt + tid] = svn[s * nt + tid];
    }
  }
  store_f(out + e, result);
}

template <typename T>
cudaError_t launch_decode_tile(const void* idx, const void* emb, const void* wi,
                               const void* wh, const void* b, const void* wf,
                               const void* bf, const void* wm, const void* bm,
                               const void* wl, const void* bl, void* out, long long bsz,
                               int t_steps, int m_rows, int hid, int rank,
                               cudaStream_t stream) {
  const size_t smem = (size_t)kDecodeThreads * (4 * hid + 2 * rank) * sizeof(float);
  cudaError_t err = allow_smem(decode_tile_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decode_tile_kernel<T><<<grid_for(bsz, kDecodeThreads), kDecodeThreads, smem, stream>>>(
      static_cast<const int*>(idx), static_cast<const T*>(emb), static_cast<const T*>(wi),
      static_cast<const T*>(wh), static_cast<const T*>(b), static_cast<const T*>(wf),
      static_cast<const T*>(bf), static_cast<const T*>(wm), static_cast<const T*>(bm),
      static_cast<const T*>(wl), static_cast<const T*>(bl), static_cast<T*>(out), bsz,
      t_steps, m_rows, hid, rank);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_decode_tile(const void* idx, const void* emb, const void* wi,
                                 const void* wh, const void* b, const void* wf,
                                 const void* bf, const void* wm, const void* bm,
                                 const void* wl, const void* bl, void* out, long long bsz,
                                 int t_steps, int m_rows, int hid, int rank, int dtype,
                                 void* stream) {
  if (bsz <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32)
    return repro::launch_decode_tile<float>(idx, emb, wi, wh, b, wf, bf, wm, bm, wl, bl, out,
                                            bsz, t_steps, m_rows, hid, rank, s);
  if (dtype == repro::kDtypeBF16)
    return repro::launch_decode_tile<__nv_bfloat16>(idx, emb, wi, wh, b, wf, bf, wm, bm, wl,
                                                    bl, out, bsz, t_steps, m_rows, hid, rank,
                                                    s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
