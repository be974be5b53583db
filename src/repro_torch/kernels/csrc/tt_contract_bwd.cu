// Backward of the batched TT-core chain contraction (tt_contract.cu): per
// entry, with out = first . mid_1 ... mid_K . last and g = dout, the
// gradients
//   dfirst = g u_1,  dmid_k = g v_{k-1} (x) u_{k+1},  dlast = g v_K,
// where v_0 = first, v_k = v_{k-1} . mid_k (the prefix row vectors) and
// u_{K+1} = last, u_k = mid_k . u_{k+1} (the suffix column vectors).  f32
// in and out, K >= 1; the K = 0 chain is a row dot that the caller
// differentiates.
//
// Replaces the backward of the Pallas TPU kernel repro/kernels/
// tt_contract.py:tt_contract (body _kernel).  The JAX package defines no
// custom_vjp: its gradient is jax.grad of the jnp oracle.
//
// Bound: bytes.  An entry reads its K R^2 mid values and writes K R^2 dmid
// values (the same count), at ~6 FLOP per mid value, far below the ridge;
// the bound is those bytes over 3.35 TB/s.  The kernel reads mid twice
// (the prefix sweep, then the suffix sweep), so it moves ~1.5x the bytes
// the bound counts.
//
// Design: the forward's lane group per entry (kernels/tt_contract.py:
// lanes_per_entry: G lanes, the smallest power of two >= R, at most 32).
// Lane j of a group owns the columns j, j + G, ... of every row, so each
// row of mid is read, and each row of dmid written, by the group as R
// neighbouring values: whole sectors.
// * Prefix sweep: the forward's loop, keeping every v_0 .. v_K in shared
//   memory ((K + 1) R floats an entry).
// * Suffix sweep, k = K down to 1: for each row r of mid_k, the group
//   writes dmid_k[r, :] = g v_{k-1}[r] u[:] and sums mid_k[r, :] . u[:]
//   over its lanes with shuffles, which gives u_new[r].  Two u buffers of R
//   floats an entry; one __syncwarp a step.
// No sum runs across entries, so there are no atomics.  Shared memory keeps
// R and K run-time values: (K + 3) R floats an entry, 256 / G entries a
// block.  Offsets are 64-bit.
#include "common.cuh"

namespace repro {

constexpr int kTTBwdThreads = 256;

__global__ void __launch_bounds__(kTTBwdThreads)
tt_contract_bwd_kernel(const float* __restrict__ first, const float* __restrict__ mid,
                       const float* __restrict__ last, const float* __restrict__ dout,
                       float* __restrict__ dfirst, float* __restrict__ dmid,
                       float* __restrict__ dlast, long long bsz, int k_steps, int rank,
                       int group) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int groups = kTTBwdThreads / group;  // entries a block
  const int g = tid / group;
  const int j = tid % group;
  // as in the forward: a warp whose first entry is past the end returns
  // whole, every other warp runs whole, so the shuffles see all 32 lanes
  const long long e0 = (long long)blockIdx.x * groups;
  if (e0 + (tid & ~31) / group >= bsz) return;
  const long long e = e0 + g;
  const bool valid = e < bsz;
  const long long ec = valid ? e : bsz - 1;  // a lane past the end reads the last entry
  float* vs = smem + (size_t)g * (k_steps + 3) * rank;  // v_0 .. v_K
  float* u = vs + (size_t)(k_steps + 1) * rank;
  float* un = u + rank;
  const size_t rr = (size_t)rank * rank;
  const float* me = mid + (size_t)ec * k_steps * rr;
  const float gd = __ldg(dout + ec);

  for (int c = j; c < rank; c += group) vs[c] = __ldg(first + ec * rank + c);
  __syncwarp();
  for (int k = 0; k < k_steps; ++k) {
    const float* m = me + k * rr;
    const float* v = vs + (size_t)k * rank;
    float* vn = vs + (size_t)(k + 1) * rank;
    for (int c = j; c < rank; c += group) {
      float acc = 0.f;
#pragma unroll 8
      for (int r = 0; r < rank; ++r) acc = fmaf(v[r], __ldg(m + (size_t)r * rank + c), acc);
      vn[c] = acc;
    }
    __syncwarp();
  }
  for (int c = j; c < rank; c += group) {
    if (valid) dlast[ec * rank + c] = gd * vs[(size_t)k_steps * rank + c];
    u[c] = __ldg(last + ec * rank + c);
  }
  __syncwarp();
  for (int k = k_steps - 1; k >= 0; --k) {
    const float* m = me + k * rr;
    float* dm = dmid + ((size_t)ec * k_steps + k) * rr;
    const float* v = vs + (size_t)k * rank;  // the prefix before mid k
    for (int r = 0; r < rank; ++r) {
      const float gv = gd * v[r];
      const float* mrow = m + (size_t)r * rank;
      float part = 0.f;
      for (int c = j; c < rank; c += group) {
        const float uc = u[c];
        part = fmaf(__ldg(mrow + c), uc, part);
        if (valid) dm[(size_t)r * rank + c] = gv * uc;
      }
      for (int off = group / 2; off > 0; off /= 2)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (j == (r & (group - 1))) un[r] = part;
    }
    __syncwarp();
    float* tmp = u;
    u = un;
    un = tmp;
  }
  if (valid)
    for (int c = j; c < rank; c += group) dfirst[ec * rank + c] = gd * u[c];
}

}  // namespace repro

// f32 only.  group: lanes per entry, a power of two from 1 to 32.
extern "C" int repro_tt_contract_bwd(const void* first, const void* mid, const void* last,
                                     const void* dout, void* dfirst, void* dmid, void* dlast,
                                     long long bsz, int k_steps, int rank, int group,
                                     void* stream) {
  if (bsz <= 0) return 0;
  if (k_steps < 1 || rank < 1 || group < 1 || group > 32 || (group & (group - 1)))
    return cudaErrorInvalidValue;
  const int groups = repro::kTTBwdThreads / group;
  const size_t smem = (size_t)groups * (k_steps + 3) * rank * sizeof(float);
  cudaError_t err = repro::allow_smem(repro::tt_contract_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  repro::tt_contract_bwd_kernel<<<repro::grid_for(bsz, groups), repro::kTTBwdThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(first), static_cast<const float*>(mid),
      static_cast<const float*>(last), static_cast<const float*>(dout),
      static_cast<float*>(dfirst), static_cast<float*>(dmid), static_cast<float*>(dlast), bsz,
      k_steps, rank, group);
  return cudaGetLastError();
}
