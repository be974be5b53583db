// Single-layer LSTM over T steps, every hidden state out: x [B, T, hid] ->
// hs [B, T, hid], weights wi, wh [hid, 4 hid], bias b [4 hid], gates
// (i, f, g, o); all math in f32, the output cast to x's dtype.  This is the
// register body, for hid <= 64; wider LSTMs run lstm_dispatch.cu's simt body
// (kernels/lstm.py:lstm_body names the choice).
//
// Replaces the Pallas TPU kernel repro/kernels/lstm.py:lstm_scan (body
// _kernel), forward only; the backward comes with the fitting path.
//
// Bound: operations.  gates = x wi + h wh is 16 hid^2 FLOP per entry and
// step: at B 65,536, T 10, hid 16 that is 2.68 GFLOP, 0.0401 ms at the
// card's 67 TFLOP/s FP32, against 84 MB of x read and h written, 0.025 ms
// at 3.35 TB/s.  So the FP32 pipes are the limit, and what the kernel must
// save is instructions that are not FMAs.  Design:
// * The cell is the fused decode's (lstm_cell.cuh): one thread owns one
//   sequence for all T steps, its h, c and the gate sums of four hidden
//   units at a time in registers, unrolled over the compile-time bucket H;
//   the weights are staged once per block into shared memory as f32 and
//   read as float4 broadcasts, one 16-byte shared load feeding four FMAs.
// * H is one of the decode buckets' widths, 12, 16, 20, 32, 64 (lstm.cuh).
//   A narrower hid is padded inside the kernel, never on the host: the
//   staging loop writes 0 for every padded weight, padded lanes of x read
//   as 0 and padded lanes of h are never stored.  That is exact: a padded
//   unit's gates are (1/2, 1/2, 0, 1/2), so its c and h stay 0.
// * x comes from HBM, not from an L1-resident table as in decode.  Each
//   thread keeps two x rows in shared memory: while it computes on row t,
//   row t + 1 is in flight through cp.async, 16 bytes (f32) or 8 (bf16) a
//   copy, where every row is aligned (hid % 4 == 0 and the pointers
//   aligned: the host chooses and passes vec); other rows are loaded with
//   scalar loads at the start of their step.  The cell re-reads the row
//   from the slot four values at a time for each block of units, so it is
//   not held in H more registers.  h[:hid] is stored into out in x's
//   dtype, four values a store where vec.
// * Blocks of 128 threads, four per SM up to H 20 (128 registers a thread,
//   no spills), two at H 32.  H 64's staged weights take 132 KB of shared
//   memory, so one block per SM: registers are not what limits it, and the
//   bucket is not made to spill for more.
// * Tried and dropped, at H 16: holding the x row in registers (spilled),
//   re-reading it from L1 per block of units as decode does (no spills but
//   slower: no prefetch), an L1 prefetch of the next row, three blocks per
//   SM (168 registers: ptxas spilled more, and it ran slower), the new h in
//   shared memory, and vec as a template flag.
//
// This unit is compiled once per bucket and dtype, with -DREPRO_LSTM_T and
// -DREPRO_LSTM_H naming them (kernels/_build.py); lstm_dispatch.cu holds
// the C entry points that pick the bucket.
#if !defined(REPRO_LSTM_T) || !defined(REPRO_LSTM_H)
#error "lstm.cu is built per bucket: define REPRO_LSTM_T and REPRO_LSTM_H"
#endif

#include "lstm.cuh"
#include "lstm_cell.cuh"

namespace repro {

constexpr int kLstmRegisterThreads = 128;

template <int H>
struct LstmBucket {
  // staged arrays, in this order: wi, wh [H][4H], b [4H]; then the x slots
  static constexpr int kWeightFloats = 8 * H * H + 4 * H;
  static constexpr int kMinBlocks = H <= 20 ? 4 : H <= 32 ? 2 : 1;
};

// Stage src [rows][4 hid] into dst [H][4H] (rows <= H; the bias is one row)
// as f32, each gate block widened from hid to H and every padded slot 0.
template <typename T, int H>
__device__ __forceinline__ void stage_padded(float* dst, const T* __restrict__ src, int rows,
                                             int hid, int tid) {
  constexpr int H4 = 4 * H;
  for (int i = tid; i < rows * H4; i += kLstmRegisterThreads) {
    const int k = i / H4;
    const int g = (i - k * H4) / H;
    const int j = i - k * H4 - g * H;
    dst[i] = (k < hid && j < hid) ? load_f(src + (size_t)k * 4 * hid + g * hid + j) : 0.f;
  }
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// Each thread keeps two x rows in shared memory, one it computes on and one
// in flight: kSlots slots a thread of kStride elements of x's dtype, row s
// of thread tid at [s][tid][kStride].  kStride is H, or H + 4 where H / 4 is
// even, so that a warp's 16-byte (f32) or 8-byte (bf16) reads of one group
// of four fall in distinct banks.
constexpr int kSlots = 2;

template <int H>
struct LstmSlot {
  static constexpr int kStride = (H / 4) % 2 ? H : H + 4;
};

// x read from this thread's slot.  The load is an asm statement so that the
// compiler issues it anew for each block of units instead of merging the
// blocks' loads into one and holding the row in H more registers.  A warp
// barrier before each block keeps ptxas from hoisting a block's shared loads
// above the block before it: with every block's loads in one region it
// scheduled past the 128-register budget at H 12 to 20 and spilled (or, at
// a 168-register budget, spilled more), without the barrier it does not.
struct SharedX {
  __device__ __forceinline__ static void block_start() { __syncwarp(); }

  __device__ __forceinline__ static float4 x4(const float* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
    return v;
  }

  __device__ __forceinline__ static float4 x4(const __nv_bfloat16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    uint2 raw;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(raw.x), "=r"(raw.y) : "r"(a));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
  }
};

// Copy x[:hid] of one row into a slot: vec rows through cp.async, four
// values a copy, without waiting (the caller commits and waits); others
// with scalar loads and stores, 0 written to the padded lanes.  In vec
// mode the padded groups are zeroed once, before the first row.
template <int H, typename T>
__device__ __forceinline__ void fill_slot(T* slot, const T* __restrict__ row, int hid, bool vec) {
  if (vec) {
#pragma unroll
    for (int k0 = 0; k0 < H; k0 += 4) {
      if (k0 < hid) {
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot + k0));
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                     ::"r"(dst), "l"(row + k0), "n"(4 * sizeof(T)) : "memory");
      }
    }
  } else {
#pragma unroll 1
    for (int k = 0; k < H; ++k) slot[k] = k < hid ? row[k] : T(0.f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// h[:hid] into one row of out; the padded lanes are not stored.
template <int H, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ row, const float (&h)[H], int hid,
                                          bool vec) {
  if (vec) {
#pragma unroll
    for (int k0 = 0; k0 < H; k0 += 4)
      if (k0 < hid) st4(row + k0, h[k0], h[k0 + 1], h[k0 + 2], h[k0 + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < H; ++k)
      if (k < hid) store_f(row + k, h[k]);
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kLstmRegisterThreads, (LstmBucket<H>::kMinBlocks))
lstm_scan_register_kernel(const T* __restrict__ x, const T* __restrict__ wi,
                          const T* __restrict__ wh, const T* __restrict__ b,
                          T* __restrict__ out, int bsz, int t_steps, int hid, bool vec) {
  constexpr int H4 = 4 * H;
  constexpr int kStride = LstmSlot<H>::kStride;
  constexpr int kSlot = kStride * kLstmRegisterThreads;  // elements of one slot of the block
  extern __shared__ float4 lstm_smem[];
  float* s_wi = reinterpret_cast<float*>(lstm_smem);
  float* s_wh = s_wi + H * H4;
  float* s_b = s_wh + H * H4;
  const int tid = threadIdx.x;
  T* s_x = reinterpret_cast<T*>(s_b + H4) + kStride * tid;  // this thread's slot 0

  const int e = blockIdx.x * kLstmRegisterThreads + tid;
  const bool live = e < bsz;
  // element offset of this sequence's row t, < 2^31 (the wrapper checks);
  // unsigned, so that the compiler keeps it one 32-bit register rather than
  // widening it into 64-bit row pointers, which spilled at H 16
  const unsigned seq = static_cast<unsigned>(live ? e : 0) * t_steps * hid;
  if (vec) {  // padded groups read as 0; row 0 starts its flight before the staging
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int k0 = (hid + 3) & ~3; k0 < H; k0 += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) s_x[s * kSlot + k0 + u] = T(0.f);
    if (live) fill_slot<H>(s_x, x + seq, hid, true);
    cp_async_commit();
  }
  stage_padded<T, H>(s_wi, wi, H, hid, tid);
  stage_padded<T, H>(s_wh, wh, H, hid, tid);
  stage_padded<T, H>(s_b, b, 1, hid, tid);
  __syncthreads();
  if (!live) return;

  float h[H], c[H];
#pragma unroll
  for (int k = 0; k < H; ++k) h[k] = c[k] = 0.f;
  for (int t = 0; t < t_steps; ++t) {
    const unsigned row = seq + static_cast<unsigned>(t) * hid;
    const T* slot = s_x + (t & 1) * kSlot;
    if (vec) {  // row t + 1 in flight while row t is computed on
      if (t + 1 < t_steps) fill_slot<H>(s_x + ((t + 1) & 1) * kSlot, x + (row + hid), hid, true);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      fill_slot<H>(s_x + (t & 1) * kSlot, x + row, hid, false);
    }
    lstm_step<SharedX, H>(h, c, slot, true, s_wi, s_wh, s_b);
    store_row<H>(out + row, h, hid, vec);
  }
}

template <typename T, int H>
cudaError_t launch_lstm_scan_register(const void* x, const void* wi, const void* wh,
                                      const void* b, void* out, long long bsz, int t_steps,
                                      int hid, bool vec, cudaStream_t stream) {
  const size_t smem = (size_t)LstmBucket<H>::kWeightFloats * sizeof(float) +
                      (size_t)kSlots * LstmSlot<H>::kStride * kLstmRegisterThreads * sizeof(T);
  cudaError_t err = allow_smem(lstm_scan_register_kernel<T, H>, smem);
  if (err != cudaSuccess) return err;
  lstm_scan_register_kernel<T, H>
      <<<grid_for(bsz, kLstmRegisterThreads), kLstmRegisterThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(wi), static_cast<const T*>(wh),
          static_cast<const T*>(b), static_cast<T*>(out), static_cast<int>(bsz), t_steps, hid,
          vec);
  return cudaGetLastError();
}

template cudaError_t launch_lstm_scan_register<REPRO_LSTM_T, REPRO_LSTM_H>(
    const void*, const void*, const void*, const void*, void*, long long, int, int, bool,
    cudaStream_t);

}  // namespace repro
