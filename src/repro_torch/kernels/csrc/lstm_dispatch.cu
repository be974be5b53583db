// C entry points of the LSTM scan, x [B, T, H] -> hs [B, T, H], and its
// simt body.
//
// repro_lstm_scan_register picks the launcher of the register body's
// bucket and dtype (lstm.cu, built once per bucket and dtype in a compile
// unit of its own, kernels/_build.py).  repro_lstm_scan runs the simt body
// below, which takes any H a tile of 8 sequences holds (up to 1304) and is
// what LSTMs wider than the largest bucket (64) run: kernels/lstm.py:
// lstm_body chooses, by shape.
//
// The simt body replaces the Pallas TPU kernel repro/kernels/lstm.py:
// lstm_scan (body _kernel) in that kernel's design: a block owns a tile of
// TB sequences for all T steps and runs each step as one FP32 product over
// the tile, gates = [x_t | h] . [wi; wh] + b, with the cell applied to the
// product's sums; every h is written out in x's dtype.  No TF32: f32 FMAs,
// bf16 widened to f32 as it is loaded.
//
// Bound: operations, 16 H^2 FLOP a sequence and step (1.44 ms at B 65,536,
// T 10, H 96 over 67 TFLOP/s) against 8 H bytes of x and h, so the FP32
// rate bounds it.  Design:
// * State.  x_t, h, h_new and c of the tile sit in shared memory transposed,
//   [unit][sequence] (simt_tile.cuh's layout); TB, a multiple of 8, is the
//   largest tile whose state and two weight stages fit a block's shared
//   memory (kernels/lstm.py:simt_tile, lstm_simt_smem_floats below).
// * Each step: gather x_t, one row of x a warp, coalesced, all of it in
//   flight at once (a sequence past B reads as zeros); the gate product
//   and the cell (simt_tile.cuh's gate_phase: a thread owns 8 sequences x
//   2 units x the four gates, the weights streamed through a double buffer
//   of shared memory, each read once a block a step); write h_new to out,
//   one row a warp, coalesced (a sequence past B is never stored); swap h
//   and h_new.
// * 512 threads a block, one block a SM by shared memory, as the decode's
//   simt body.
#include <climits>

#include "lstm.cuh"
#include "simt_tile.cuh"

namespace repro {

// Dynamic shared memory of a block, in floats: x, h, h_new, c ([H][TB]
// each) and two weight stages.
__host__ inline long long lstm_simt_smem_floats(int hid, int tile) {
  return (long long)tile * 4LL * hid + 2 * simt_stage_floats(hid, 0);
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
lstm_scan_simt_kernel(const T* __restrict__ x, const T* __restrict__ wi,
                      const T* __restrict__ wh, const T* __restrict__ b, T* __restrict__ out,
                      long long bsz, int t_steps, const SimtTile p) {
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int hid = p.hid, lda = p.tile;
  float* xs = smem;
  float* hs = xs + hid * lda;
  float* hn = hs + hid * lda;
  float* cs = hn + hid * lda;
  float* buf = cs + hid * lda;
  const long long e0 = (long long)blockIdx.x * p.tile;

  for (int f = tid; f < hid * lda; f += nt) hs[f] = cs[f] = 0.f;
  for (int t = 0; t < t_steps; ++t) {
    // x_t, one row a warp, every load in flight at once (cp.async in f32)
    for (int e = warp; e < p.tile; e += nwarps) {
      const long long ge = e0 + e;
      const bool ok = ge < bsz;
      const T* row = x + ((size_t)(ok ? ge : 0) * t_steps + t) * hid;
      const int col = entry_column(e, p.half);
      for (int k = lane; k < hid; k += 32) stage_f(xs + k * lda + col, row + k, ok);
    }
    stage_commit();
    stage_wait_all();
    __syncthreads();
    gate_phase(p, xs, hs, hn, cs, buf, wi, wh, b);
    __syncthreads();  // h_new and c of every unit are in
    // h_t, one row a warp
    for (int e = warp; e < p.tile; e += nwarps) {
      const long long ge = e0 + e;
      if (ge >= bsz) break;
      T* row = out + ((size_t)ge * t_steps + t) * hid;
      const int col = entry_column(e, p.half);
      for (int k = lane; k < hid; k += 32) store_f(row + k, hn[k * lda + col]);
    }
    float* tmp = hs;
    hs = hn;
    hn = tmp;
  }
}

template <typename T>
cudaError_t launch_lstm_scan_simt(const void* x, const void* wi, const void* wh, const void* b,
                                  void* out, long long bsz, int t_steps, const SimtTile& p,
                                  cudaStream_t stream) {
  const size_t smem = (size_t)lstm_simt_smem_floats(p.hid, p.tile) * sizeof(float);
  cudaError_t err = allow_smem(lstm_scan_simt_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  lstm_scan_simt_kernel<T><<<grid_for(bsz, p.tile), kSimtThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wi), static_cast<const T*>(wh),
      static_cast<const T*>(b), static_cast<T*>(out), bsz, t_steps, p);
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

// tile: the sequences a block owns, a multiple of 8 whose state fits
// (kernels/lstm.py:simt_tile)
extern "C" int repro_lstm_scan(const void* x, const void* wi, const void* wh, const void* b,
                               void* out, long long bsz, int t_steps, int hid, int tile,
                               int dtype, void* stream) {
  if (bsz <= 0 || t_steps <= 0) return 0;
  if (bsz > INT_MAX || hid < 1 || tile < repro::kSimtEntries || tile % repro::kSimtEntries ||
      repro::lstm_simt_smem_floats(hid, tile) * 4 > repro::kMaxSmemBytes)
    return cudaErrorInvalidValue;
  repro::SimtTile p{};
  p.hid = hid;
  p.tile = tile;
  p.half = tile / 2;
  p.eg = tile / repro::kSimtEntries;
  p.stage = static_cast<int>(repro::simt_stage_floats(hid, 0));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32)
    return repro::launch_lstm_scan_simt<float>(x, wi, wh, b, out, bsz, t_steps, p, s);
  if (dtype == repro::kDtypeBF16)
    return repro::launch_lstm_scan_simt<__nv_bfloat16>(x, wi, wh, b, out, bsz, t_steps, p, s);
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
