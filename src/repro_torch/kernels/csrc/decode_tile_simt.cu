// Fused NTTD decode of a [B, T] tile of folded indices -> [B] values, the
// simt body: any (H, R), both run-time values.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_tile.py:decode_tile
// (body _kernel) for the shapes above the register body's largest bucket
// (decode_tile.cu, H 64, R 32): kernels/decode_tile.py:decode_body chooses,
// by shape.  It computes what decode_tile.cu computes: gather x_t =
// emb[t, idx[:, t]] (a zero row for an index outside [0, M)), run the
// (i, f, g, o) LSTM cell, v = h_0 W_first + b_first, v <- v (h_t W_mid +
// b_mid) for the middle steps, out = v . (h_{T-1} W_last + b_last).  All
// math in f32; the output is cast to the embedding dtype.
//
// Bound: operations (~2.0 MFLOP an entry at H 68, R 34, T 10 against 44
// bytes of index and output).  Design, the first port's: one thread owns
// one entry for all T steps, so nothing crosses threads.  Its state (x, h,
// h_new, c: 4H floats; v, v_new: 2R floats) sits in dynamic shared memory,
// column-wise per thread, and the LSTM cell is lstm_cell_simt.cuh's, shared
// with the LSTM scan's simt body.  The R x R mid core is never built: each
// v_new[s] = sum_r v[r] (h . W_mid[:, rR + s] + b_mid[rR + s]) is formed on
// the fly.  Weights stay in device memory and come through the read-only
// cache as warp-wide broadcasts, about two loads per FMA.  The block's
// thread count is a run-time value too: the wrapper
// (kernels/decode_tile.py:simt_threads) takes the most threads, up to 64,
// whose (4H + 2R) floats each fit a block's shared memory (45 at H 256,
// R 128).
#include <climits>

#include "common.cuh"
#include "lstm_cell_simt.cuh"

namespace repro {

constexpr int kDecodeSimtThreads = 64;  // the most threads a block runs

template <typename T>
__global__ void __launch_bounds__(kDecodeSimtThreads)
decode_tile_simt_kernel(const int* __restrict__ idx, const T* __restrict__ emb,
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
  const size_t rr = (size_t)rank * rank;
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
            acc = fmaf(sh[k * nt + tid], load_f(w_mid + k * rr + (size_t)r * rank + s), acc);
          vs = fmaf(sv[r * nt + tid], acc + load_f(b_mid + (size_t)r * rank + s), vs);
        }
        svn[s * nt + tid] = vs;
      }
      for (int s = 0; s < rank; ++s) sv[s * nt + tid] = svn[s * nt + tid];
    }
  }
  store_f(out + e, result);
}

template <typename T>
cudaError_t launch_decode_tile_simt(const void* idx, const void* emb, const void* wi,
                                    const void* wh, const void* b, const void* wf,
                                    const void* bf, const void* wm, const void* bm,
                                    const void* wl, const void* bl, void* out, long long bsz,
                                    int t_steps, int m_rows, int hid, int rank, int threads,
                                    cudaStream_t stream) {
  const size_t smem = (size_t)threads * (4 * hid + 2 * rank) * sizeof(float);
  cudaError_t err = allow_smem(decode_tile_simt_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decode_tile_simt_kernel<T><<<grid_for(bsz, threads), threads, smem, stream>>>(
      static_cast<const int*>(idx), static_cast<const T*>(emb), static_cast<const T*>(wi),
      static_cast<const T*>(wh), static_cast<const T*>(b), static_cast<const T*>(wf),
      static_cast<const T*>(bf), static_cast<const T*>(wm), static_cast<const T*>(bm),
      static_cast<const T*>(wl), static_cast<const T*>(bl), static_cast<T*>(out), bsz,
      t_steps, m_rows, hid, rank);
  return cudaGetLastError();
}

}  // namespace repro

// threads: the block's thread count, 1 .. kDecodeSimtThreads
extern "C" int repro_decode_tile_simt(const void* idx, const void* emb, const void* wi,
                                      const void* wh, const void* b, const void* wf,
                                      const void* bf, const void* wm, const void* bm,
                                      const void* wl, const void* bl, void* out,
                                      long long bsz, int t_steps, int m_rows, int hid,
                                      int rank, int threads, int dtype, void* stream) {
  if (bsz <= 0) return 0;
  if (bsz > INT_MAX || t_steps < 2 || hid < 1 || rank < 1 || threads < 1 ||
      threads > repro::kDecodeSimtThreads)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32)
    return repro::launch_decode_tile_simt<float>(idx, emb, wi, wh, b, wf, bf, wm, bm, wl, bl,
                                                 out, bsz, t_steps, m_rows, hid, rank,
                                                 threads, s);
  if (dtype == repro::kDtypeBF16)
    return repro::launch_decode_tile_simt<__nv_bfloat16>(idx, emb, wi, wh, b, wf, bf, wm, bm,
                                                         wl, bl, out, bsz, t_steps, m_rows,
                                                         hid, rank, threads, s);
  return cudaErrorInvalidValue;
}
