// C entry points of the LSTM scan, x [B, T, H] -> hs [B, T, H], and its
// simt body.
//
// repro_lstm_scan_register picks the launcher of the register body's
// bucket and dtype (lstm.cu, built once per bucket and dtype in a compile
// unit of its own, kernels/_build.py).  repro_lstm_scan runs the simt body
// below, which takes any H and is what LSTMs wider than the largest bucket
// (64) run: kernels/lstm.py:lstm_body chooses, by shape.
//
// The simt body replaces the Pallas TPU kernel repro/kernels/lstm.py:
// lstm_scan (body _kernel) as the first port did: one thread owns one
// sequence; its x, h, h_new and c sit in shared memory, column-wise per
// thread, and the cell is lstm_cell_simt.cuh's.  H is a run-time value; the
// block's thread count is sized to the shared memory by the caller.  Math
// in f32, output cast to x's dtype.
#include <climits>

#include "lstm.cuh"
#include "lstm_cell_simt.cuh"

namespace repro {

// the most threads a simt block runs; the wrapper (kernels/lstm.py:
// simt_threads) sizes each launch to the shared memory, 16 H bytes a thread
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
                             void* out, long long bsz, int t_steps, int hid, int threads,
                             cudaStream_t stream) {
  const size_t smem = (size_t)threads * 4 * hid * sizeof(float);
  cudaError_t err = allow_smem(lstm_scan_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  lstm_scan_kernel<T><<<grid_for(bsz, threads), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wi), static_cast<const T*>(wh),
      static_cast<const T*>(b), static_cast<T*>(out), bsz, t_steps, hid);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_lstm_bucket(const void* x, const void* wi, const void* wh, const void* b,
                                 void* out, long long bsz, int t_steps, int hid, int bucket,
                                 bool vec, cudaStream_t s) {
#define REPRO_LSTM_BUCKET(HH)                                                          \
  if (bucket == HH)                                                                    \
    return launch_lstm_scan_register<T, HH>(x, wi, wh, b, out, bsz, t_steps, hid, vec, s);
  REPRO_LSTM_BUCKETS(REPRO_LSTM_BUCKET)
#undef REPRO_LSTM_BUCKET
  return cudaErrorInvalidValue;
}

}  // namespace repro

// threads: the simt block's thread count, 1 .. kLstmThreads
extern "C" int repro_lstm_scan(const void* x, const void* wi, const void* wh, const void* b,
                               void* out, long long bsz, int t_steps, int hid, int threads,
                               int dtype, void* stream) {
  if (bsz <= 0 || t_steps <= 0) return 0;
  if (hid <= 0 || threads < 1 || threads > repro::kLstmThreads) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32)
    return repro::launch_lstm_scan<float>(x, wi, wh, b, out, bsz, t_steps, hid, threads, s);
  if (dtype == repro::kDtypeBF16)
    return repro::launch_lstm_scan<__nv_bfloat16>(x, wi, wh, b, out, bsz, t_steps, hid,
                                                  threads, s);
  return cudaErrorInvalidValue;
}

// vec: every x and out row is read and written with 16-byte (f32) or 8-byte
// (bf16) vectors; the wrapper passes it only when hid % 4 == 0 and both
// pointers are aligned to that width.
extern "C" int repro_lstm_scan_register(const void* x, const void* wi, const void* wh,
                                        const void* b, void* out, long long bsz, int t_steps,
                                        int hid, int bucket, int vec, int dtype, void* stream) {
  if (bsz <= 0 || t_steps <= 0) return 0;
  // elements are indexed with 32 bits; the bucket must hold hid, and vec
  // rows must be whole vectors
  if (bsz * t_steps * hid > INT_MAX || hid <= 0 || hid > bucket || (vec && hid % 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32)
    return repro::dispatch_lstm_bucket<float>(x, wi, wh, b, out, bsz, t_steps, hid, bucket,
                                              vec != 0, s);
  if (dtype == repro::kDtypeBF16)
    return repro::dispatch_lstm_bucket<__nv_bfloat16>(x, wi, wh, b, out, bsz, t_steps, hid,
                                                      bucket, vec != 0, s);
  return cudaErrorInvalidValue;
}
