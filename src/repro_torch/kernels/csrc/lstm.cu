// Single-layer LSTM over T steps, every hidden state out: x [B, T, H] ->
// hs [B, T, H], weights wi, wh [H, 4H], bias b [4H], gates (i, f, g, o).
//
// Replaces the Pallas TPU kernel repro/kernels/lstm.py:lstm_scan (body
// _kernel), forward only; the backward comes with the fitting path.
//
// Bound: operations at the decode widths (H = 16: 16H^2 = 4 kFLOP per
// entry and step against 2H * 4 = 128 bytes of input and output, above
// the card's ~20 FLOP/byte FP32 ridge).  Design: one thread owns one
// sequence; (h, c) never leave the SM across the T steps (the TPU kept
// them in VMEM).  The thread's x, h, h_new and c sit in shared memory,
// column-wise per thread; weights come through the read-only cache as
// warp-wide broadcasts.  Math in f32, output cast to x's dtype.
#include "common.cuh"

namespace repro {

constexpr int kLstmThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kLstmThreads)
lstm_scan_kernel(const T* __restrict__ x, const T* __restrict__ wi, const T* __restrict__ wh,
                 const T* __restrict__ b, T* __restrict__ out, long long bsz, int t_steps,
                 int hid) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  float* sx = smem;
  float* sh = sx + hid * nt;
  float* shn = sh + hid * nt;
  float* sc = shn + hid * nt;
  const long long e = (long long)blockIdx.x * nt + tid;
  if (e >= bsz) return;

  for (int k = 0; k < hid; ++k) {
    sh[k * nt + tid] = 0.f;
    sc[k * nt + tid] = 0.f;
  }
  for (int t = 0; t < t_steps; ++t) {
    const size_t row = ((size_t)e * t_steps + t) * hid;
    for (int k = 0; k < hid; ++k) sx[k * nt + tid] = load_f(x + row + k);
    lstm_cell(sx, sh, shn, sc, wi, wh, b, hid, nt, tid);
    for (int k = 0; k < hid; ++k) store_f(out + row + k, sh[k * nt + tid]);
  }
}

template <typename T>
cudaError_t launch_lstm_scan(const void* x, const void* wi, const void* wh, const void* b,
                             void* out, long long bsz, int t_steps, int hid,
                             cudaStream_t stream) {
  const size_t smem = (size_t)kLstmThreads * 4 * hid * sizeof(float);
  cudaError_t err = allow_smem(lstm_scan_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  lstm_scan_kernel<T><<<grid_for(bsz, kLstmThreads), kLstmThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wi), static_cast<const T*>(wh),
      static_cast<const T*>(b), static_cast<T*>(out), bsz, t_steps, hid);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_lstm_scan(const void* x, const void* wi, const void* wh, const void* b,
                               void* out, long long bsz, int t_steps, int hid, int dtype,
                               void* stream) {
  if (bsz <= 0 || t_steps <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32)
    return repro::launch_lstm_scan<float>(x, wi, wh, b, out, bsz, t_steps, hid, s);
  if (dtype == repro::kDtypeBF16)
    return repro::launch_lstm_scan<__nv_bfloat16>(x, wi, wh, b, out, bsz, t_steps, hid, s);
  return cudaErrorInvalidValue;
}
