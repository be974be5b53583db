// Batched TT-core chain contraction: per entry first[R] . mid_1 ... mid_K .
// last[R] with mid [B, K, R, R] -> [B], accumulated in f32, cast to the
// dtype of `first`.  K >= 1 here; K = 0 is a row dot done by the caller.
//
// Replaces the Pallas TPU kernel repro/kernels/tt_contract.py:tt_contract
// (body _kernel), forward only; the backward comes with the fitting path.
//
// Bound: bytes.  Each entry reads K R^2 mid values once and does 2 FLOP per
// value (0.25 FLOP a byte in f32), far below the ridge, so the kernel must
// use every byte of every HBM sector it fetches and keep enough loads in
// flight.  The first port's thread per entry did neither: neighbouring
// lanes read addresses K R^2 values apart, so a load touched 32 sectors for
// 4 bytes of each and a block's live footprint (128 entries x 2 KB at K 8,
// R 8) overflowed L1, and sectors were fetched again (15.6 % of the bound).
//
// Design: a lane group per entry.  G lanes share one entry (G the smallest
// power of two >= R, at most 32: kernels/tt_contract.py:lanes_per_entry
// computes it), and a warp holds 32 / G consecutive entries.  Lane j of a
// group owns the columns j, j + G, ... of v_new = v . mid_k, so for each
// row r of mid_k the group reads R neighbouring values: whole sectors, and
// a warp's load covers 32 / G entries' rows at once.  None of those loads
// depends on v, and the row loop is unrolled by 8, so eight loads a lane are
// in flight before their FMAs; with ~48 warps a SM that keeps tens of KB a
// SM in flight, past what HBM's latency needs.  The slab-through-shared-
// memory design (cp.async or TMA into a ring) was the other choice; it needs
// per-k staging above R ~ 32 and a layout free of bank conflicts, and buys
// nothing here: the lane groups already read every sector whole.
//
// v and v_new sit in shared memory, one R-float row per group in each of two
// buffers (group stride R, so the groups of a warp read distinct banks; a
// group's lanes read the same v[r], a broadcast).  One __syncwarp per k
// separates writing v_new from reading it.  Shared memory keeps R a
// run-time value, so one body takes every R >= 1: 2 x (256 / G) x R floats
// a block.  The final v . last is summed across the group with shuffles.
// Offsets are 64-bit.
#include "common.cuh"

namespace repro {

constexpr int kTTThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kTTThreads)
tt_contract_kernel(const T* __restrict__ first, const T* __restrict__ mid,
                   const T* __restrict__ last, T* __restrict__ out, long long bsz, int k_steps,
                   int rank, int group) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int groups = kTTThreads / group;  // entries a block
  const int g = tid / group;              // this lane's group in the block
  const int j = tid % group;              // this lane's place in its group
  // a warp whose first entry is past the end has nothing to do; every other
  // warp runs whole, so __syncwarp and the shuffles see all 32 lanes
  const long long e0 = (long long)blockIdx.x * groups;
  if (e0 + (tid & ~31) / group >= bsz) return;
  const long long e = e0 + g;
  const bool valid = e < bsz;
  const long long ec = valid ? e : bsz - 1;  // a lane past the end reads the last entry
  float* sv = smem + g * rank;
  float* svn = sv + groups * rank;

  for (int c = j; c < rank; c += group) sv[c] = load_f(first + ec * rank + c);
  __syncwarp();
  const size_t rr = (size_t)rank * rank;
  for (int k = 0; k < k_steps; ++k) {
    const T* m = mid + ((size_t)ec * k_steps + k) * rr;
    for (int c = j; c < rank; c += group) {
      const T* col = m + c;
      float acc = 0.f;
#pragma unroll 8
      for (int r = 0; r < rank; ++r) acc = fmaf(sv[r], load_f(col + (size_t)r * rank), acc);
      svn[c] = acc;
    }
    __syncwarp();
    float* tmp = sv;
    sv = svn;
    svn = tmp;
  }
  float o = 0.f;
  for (int c = j; c < rank; c += group) o = fmaf(sv[c], load_f(last + ec * rank + c), o);
  for (int off = group / 2; off > 0; off /= 2) o += __shfl_xor_sync(0xffffffffu, o, off);
  if (valid && j == 0) store_f(out + e, o);
}

template <typename T>
cudaError_t launch_tt_contract(const void* first, const void* mid, const void* last, void* out,
                               long long bsz, int k_steps, int rank, int group,
                               cudaStream_t stream) {
  const int groups = kTTThreads / group;
  const size_t smem = (size_t)2 * groups * rank * sizeof(float);
  cudaError_t err = allow_smem(tt_contract_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  tt_contract_kernel<T><<<grid_for(bsz, groups), kTTThreads, smem, stream>>>(
      static_cast<const T*>(first), static_cast<const T*>(mid), static_cast<const T*>(last),
      static_cast<T*>(out), bsz, k_steps, rank, group);
  return cudaGetLastError();
}

}  // namespace repro

// group: lanes per entry, a power of two from 1 to 32 (rank 0 gives 0s)
extern "C" int repro_tt_contract(const void* first, const void* mid, const void* last,
                                 void* out, long long bsz, int k_steps, int rank, int group,
                                 int dtype, void* stream) {
  if (bsz <= 0) return 0;
  if (k_steps < 1 || rank < 0 || group < 1 || group > 32 || (group & (group - 1)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32)
    return repro::launch_tt_contract<float>(first, mid, last, out, bsz, k_steps, rank, group,
                                            s);
  if (dtype == repro::kDtypeBF16)
    return repro::launch_tt_contract<__nv_bfloat16>(first, mid, last, out, bsz, k_steps,
                                                    rank, group, s);
  return cudaErrorInvalidValue;
}
