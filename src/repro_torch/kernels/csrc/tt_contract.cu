// Batched TT-core chain contraction: per entry first[R] . mid_1 ... mid_K .
// last[R] with mid [B, K, R, R] -> [B], accumulated in f32, cast to the
// dtype of `first`.  K >= 1 here; K = 0 is a row dot done by the caller.
//
// Replaces the Pallas TPU kernel repro/kernels/tt_contract.py:tt_contract
// (body _kernel), forward only; the backward comes with the fitting path.
//
// Bound: bytes.  Each entry reads K R^2 mid values once and does 2 FLOP per
// value, far below the ridge.  Design: one thread owns one entry and keeps
// the running row vector v (and v_new) in shared memory, column-wise per
// thread, so every mid value is read from device memory exactly once and
// nothing but the final value is written.  A thread walks its own R x R
// block row by row; coalescing across threads (a warp per entry, or a
// transposed mid layout) is left to a later revision.
#include "common.cuh"

namespace repro {

constexpr int kTTThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kTTThreads)
tt_contract_kernel(const T* __restrict__ first, const T* __restrict__ mid,
                   const T* __restrict__ last, T* __restrict__ out, long long bsz, int k_steps,
                   int rank) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  float* sv = smem;
  float* svn = sv + rank * nt;
  const long long e = (long long)blockIdx.x * nt + tid;
  if (e >= bsz) return;

  for (int s = 0; s < rank; ++s) sv[s * nt + tid] = load_f(first + (size_t)e * rank + s);
  const size_t rr = (size_t)rank * rank;
  for (int k = 0; k < k_steps; ++k) {
    const T* m = mid + ((size_t)e * k_steps + k) * rr;
    for (int s = 0; s < rank; ++s) {
      float acc = 0.f;
      for (int r = 0; r < rank; ++r) acc = fmaf(sv[r * nt + tid], load_f(m + r * rank + s), acc);
      svn[s * nt + tid] = acc;
    }
    for (int s = 0; s < rank; ++s) sv[s * nt + tid] = svn[s * nt + tid];
  }
  float o = 0.f;
  for (int s = 0; s < rank; ++s)
    o = fmaf(sv[s * nt + tid], load_f(last + (size_t)e * rank + s), o);
  store_f(out + e, o);
}

template <typename T>
cudaError_t launch_tt_contract(const void* first, const void* mid, const void* last, void* out,
                               long long bsz, int k_steps, int rank, cudaStream_t stream) {
  const size_t smem = (size_t)kTTThreads * 2 * rank * sizeof(float);
  cudaError_t err = allow_smem(tt_contract_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  tt_contract_kernel<T><<<grid_for(bsz, kTTThreads), kTTThreads, smem, stream>>>(
      static_cast<const T*>(first), static_cast<const T*>(mid), static_cast<const T*>(last),
      static_cast<T*>(out), bsz, k_steps, rank);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_tt_contract(const void* first, const void* mid, const void* last,
                                 void* out, long long bsz, int k_steps, int rank, int dtype,
                                 void* stream) {
  if (bsz <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32)
    return repro::launch_tt_contract<float>(first, mid, last, out, bsz, k_steps, rank, s);
  if (dtype == repro::kDtypeBF16)
    return repro::launch_tt_contract<__nv_bfloat16>(first, mid, last, out, bsz, k_steps,
                                                    rank, s);
  return cudaErrorInvalidValue;
}
