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
// the bound is those bytes over 3.35 TB/s.
//
// What held the first design (the wide plan below) back at the MEDIUM fit
// shape (B 8192, K 8, R 10: 21 % of its bound): it reads mid twice, in the
// prefix sweep and again in the suffix sweep; its suffix sweep is a chain of
// dependent latencies, a row's scalar load, its 40-byte partial-row store of
// dmid and a shuffle reduction before the next row; its lane groups are
// padded to a power of two (16 lanes at R 10, 6 idle); and its blocks fill
// half the SMs' warps.
//
// Two plans, chosen by the wrapper before any launch (kernels/
// tt_contract.py:bwd_plan):
// * slab, where two buffers of an entry fit half an SM's shared memory (at
//   K 8 every R up to 42).  Persistent blocks walk over slabs of E entries;
//   a slab's mid is one contiguous range of E K R^2 floats, and so is its
//   dmid.  Warp 0 copies the next slab into the other of two buffers with
//   TMA 1-D bulk copies (cp.async.bulk, one an entry, completing on that
//   buffer's mbarrier) while the block sweeps this one, so mid is read from
//   device memory once.  An entry's 16-byte-aligned interior goes in bulk;
//   its ragged head and tail (K R^2 not a multiple of 4) are plain loads.
//   Threads are packed to R, a thread per (entry, j): E R threads rounded
//   up to whole warps, so only a warp's tail idles.  Both sweeps read the
//   buffer: the prefix, thread (e, j) owning column j, keeps v_0 .. v_K in
//   shared memory; the suffix, thread (e, j) owning row j, computes u_k[j]
//   from row j of mid_k, four columns at a time, and overwrites those
//   columns in place with dmid_k's, so it needs no shuffle and no other
//   thread's row.  Warp 0 then stores the finished slab's dmid with TMA bulk
//   copies, an entry's interior each (the ragged head and tail as plain
//   stores): whole 16-byte chunks, no partial rows, and the threads go on
//   to the next slab while the copies drain; the buffer is refilled once
//   they have read it.  An entry's slot in a buffer is padded to a stride
//   (the wrapper's slab_stride) that spreads the entries of a warp over the
//   banks: K R^2 = 800 floats, a multiple of 32, would put every entry of a
//   warp on the same banks.
// * wide, above that: the first design, unchanged.  A lane group per entry
//   (lanes_per_entry: G lanes, the smallest power of two >= R, at most 32);
//   lane j owns the columns j, j + G, ... of every row.  The prefix sweep
//   keeps every v_0 .. v_K in shared memory; the suffix sweep writes each
//   row of dmid_k and sums mid_k[r, :] . u over its lanes with shuffles.
//   (K + 3) R floats an entry, 256 / G entries a block.
// No sum runs across entries, so there are no atomics.  Offsets are 64-bit.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {

constexpr int kTTBwdWideThreads = 256;
constexpr int kTTBwdSlabThreads = 256;  // most threads of a slab block

__global__ void __launch_bounds__(kTTBwdWideThreads)
tt_contract_bwd_wide_kernel(const float* __restrict__ first, const float* __restrict__ mid,
                            const float* __restrict__ last, const float* __restrict__ dout,
                            float* __restrict__ dfirst, float* __restrict__ dmid,
                            float* __restrict__ dlast, long long bsz, int k_steps, int rank,
                            int group) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int groups = kTTBwdWideThreads / group;  // entries a block
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

// Where an entry's `per` floats at `p` lie against the 16-byte grid: its
// first float's offset from a 16-byte boundary (`shift`, in floats), the
// floats before the bulk interior (`head`) and the interior's bytes
// (`bulk`, a multiple of 16; 0, and head = per, when the entry holds no
// whole aligned 16 bytes).  The floats after the interior are the tail.
// An entry's slot in a buffer holds float f at shift + f, so the interior
// lands 16-byte aligned.
struct EntrySpan {
  int shift;
  int head;
  uint32_t bulk;
};

__device__ __forceinline__ EntrySpan entry_span(const float* p, int per) {
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
  const int head = min((4 - shift) & 3, per);
  const int chunks = (per - head) >> 2;
  return {shift, chunks ? head : per, static_cast<uint32_t>(chunks) * 16u};
}

// Warp 0: start the copy of the slab of `n` entries from `e0` into `buf`,
// each entry's interior one bulk copy, all counted on `bar`.
__device__ __forceinline__ void load_slab(float* buf, const float* __restrict__ mid,
                                          long long e0, int n, int per, int stride,
                                          uint32_t bar, int lane) {
  uint32_t bytes = 0;
  for (int i = lane; i < n; i += 32) bytes += entry_span(mid + (e0 + i) * per, per).bulk;
  bytes = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) mbar_expect_tx(bar, bytes);
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const float* src = mid + (e0 + i) * per;
    const EntrySpan s = entry_span(src, per);
    if (s.bulk)
      bulk_load(smem_addr(buf + (size_t)i * stride + s.shift + s.head), src + s.head, s.bulk,
                bar);
  }
}

// Shared memory: two mbarriers (16 bytes), two buffers of `entries` slots
// of `stride` floats, then each entry's v_0 .. v_K and two u rows.
__global__ void __launch_bounds__(kTTBwdSlabThreads)
tt_contract_bwd_slab_kernel(const float* __restrict__ first, const float* __restrict__ mid,
                            const float* __restrict__ last, const float* __restrict__ dout,
                            float* __restrict__ dfirst, float* __restrict__ dmid,
                            float* __restrict__ dlast, long long bsz, int k_steps, int rank,
                            int entries, int stride) {
  extern __shared__ __align__(16) unsigned char tt_slab_smem[];
  const uint32_t bars = smem_addr(tt_slab_smem);
  float* bufs = reinterpret_cast<float*>(tt_slab_smem + 16);
  float* vs = bufs + (size_t)2 * entries * stride;
  float* us = vs + (size_t)entries * (k_steps + 1) * rank;
  const int tid = threadIdx.x;
  const int e = tid / rank;  // this thread's entry in a slab
  const int j = tid - e * rank;  // its column (prefix) and row (suffix)
  const int per = k_steps * rank * rank;
  const int rr = rank * rank;
  const long long slabs = (bsz + entries - 1) / entries;
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  long long s = blockIdx.x;  // the grid has no more blocks than slabs
  if (tid < 32)
    load_slab(bufs, mid, s * entries, (int)min((long long)entries, bsz - s * entries), per,
              stride, bars, tid);
  for (int it = 0; s < slabs; s += gridDim.x, ++it) {
    const int b = it & 1;
    float* buf = bufs + (size_t)b * entries * stride;
    const long long next = s + gridDim.x;
    // the other buffer was last read and written before the barrier that
    // closed the previous slab, and its stores must have read it
    if (tid < 32) bulk_wait_read();
    if (tid < 32 && next < slabs)
      load_slab(bufs + (size_t)(b ^ 1) * entries * stride, mid, next * entries,
                (int)min((long long)entries, bsz - next * entries), per, stride,
                bars + 8 * (b ^ 1), tid);
    const long long e0 = s * entries;
    const bool active = e < min((long long)entries, bsz - e0);
    const long long ec = e0 + e;
    const float* src = mid + ec * per;
    EntrySpan span{0, 0, 0};
    float* m = nullptr;
    float* v = nullptr;
    float* u = nullptr;
    float gd = 0.f;
    if (active) {
      span = entry_span(src, per);
      m = buf + (size_t)e * stride + span.shift;
      v = vs + (size_t)e * (k_steps + 1) * rank;
      u = us + (size_t)e * 2 * rank;
      gd = __ldg(dout + ec);
      v[j] = __ldg(first + ec * rank + j);
      u[j] = __ldg(last + ec * rank + j);
      for (int f = j; f < span.head; f += rank) m[f] = __ldg(src + f);
      for (int f = span.head + (int)(span.bulk >> 2) + j; f < per; f += rank)
        m[f] = __ldg(src + f);
    }
    mbar_wait(bars + 8 * b, (it >> 1) & 1);
    __syncthreads();
    // prefix: v_{k+1}[j] = v_k . column j of mid_k
    for (int k = 0; k < k_steps; ++k) {
      if (active) {
        const float* col = m + k * rr + j;
        const float* vk = v + k * rank;
        float acc = 0.f;
#pragma unroll 4
        for (int r = 0; r < rank; ++r) acc = fmaf(vk[r], col[r * rank], acc);
        v[(k + 1) * rank + j] = acc;
      }
      __syncthreads();
    }
    // suffix: u_k[j] = row j of mid_k . u_{k+1}, then dmid_k's row j over it
    int cur = 0;
    for (int k = k_steps - 1; k >= 0; --k) {
      if (active) {
        float* row = m + k * rr + j * rank;
        const float* uk = u + cur * rank;
        const float gv = gd * v[k * rank + j];
        float acc = 0.f;
        // four columns at a time: their loads ahead of the stores over them
        for (int c0 = 0; c0 < rank; c0 += 4) {
          float rv[4], uv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            rv[c] = c0 + c < rank ? row[c0 + c] : 0.f;
            uv[c] = c0 + c < rank ? uk[c0 + c] : 0.f;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc = fmaf(rv[c], uv[c], acc);
            if (c0 + c < rank) row[c0 + c] = gv * uv[c];
          }
        }
        u[(cur ^ 1) * rank + j] = acc;
      }
      cur ^= 1;
      __syncthreads();
    }
    if (active) {
      dfirst[ec * rank + j] = gd * u[cur * rank + j];
      dlast[ec * rank + j] = gd * v[k_steps * rank + j];
      float* dst = dmid + ec * per;
      for (int f = j; f < span.head; f += rank) dst[f] = m[f];
      for (int f = span.head + (int)(span.bulk >> 2) + j; f < per; f += rank) dst[f] = m[f];
    }
    // the slab's interiors, one bulk store an entry, once every thread's
    // writes to buf are visible to the copies (async proxy)
    fence_proxy_async();
    __syncthreads();
    if (tid < 32) {
      const int n = (int)min((long long)entries, bsz - e0);
      for (int i = tid; i < n; i += 32) {
        const long long off = (e0 + i) * per;
        const EntrySpan sp = entry_span(mid + off, per);
        if (sp.bulk)
          bulk_store(dmid + off + sp.head,
                     smem_addr(buf + (size_t)i * stride + sp.shift + sp.head), sp.bulk);
      }
      bulk_commit();
    }
  }
  if (tid < 32) bulk_wait_read();  // shared memory outlives the last stores' reads
}

}  // namespace repro

// f32 only.  plan 0 (slab): `entries` a slab, slots of `stride` floats,
// `threads` a block (whole warps, at least entries x rank), `blocks`
// persistent blocks; mid and dmid at the same offset from the 16-byte grid.
// plan 1 (wide): `entries` a block, a lane group of threads / entries lanes
// each (a power of two up to 32); `stride` and `blocks` unused.
extern "C" int repro_tt_contract_bwd(const void* first, const void* mid, const void* last,
                                     const void* dout, void* dfirst, void* dmid, void* dlast,
                                     long long bsz, int k_steps, int rank, int plan,
                                     int entries, int stride, int threads, int blocks,
                                     void* stream) {
  if (bsz <= 0) return 0;
  if (k_steps < 1 || rank < 1 || entries < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(first);
  const float* m = static_cast<const float*>(mid);
  const float* l = static_cast<const float*>(last);
  const float* d = static_cast<const float*>(dout);
  float* df = static_cast<float*>(dfirst);
  float* dm = static_cast<float*>(dmid);
  float* dl = static_cast<float*>(dlast);
  if (plan == 1) {
    if (threads != repro::kTTBwdWideThreads || threads % entries) return cudaErrorInvalidValue;
    const int group = threads / entries;
    if (group > 32 || (group & (group - 1))) return cudaErrorInvalidValue;
    const size_t smem = (size_t)entries * (k_steps + 3) * rank * sizeof(float);
    cudaError_t err = repro::allow_smem(repro::tt_contract_bwd_wide_kernel, smem);
    if (err != cudaSuccess) return err;
    repro::tt_contract_bwd_wide_kernel<<<repro::grid_for(bsz, entries), threads, smem, st>>>(
        f, m, l, d, df, dm, dl, bsz, k_steps, rank, group);
    return cudaGetLastError();
  }
  const long long per = (long long)k_steps * rank * rank;
  if (plan != 0 || threads % 32 || threads > repro::kTTBwdSlabThreads ||
      threads < entries * rank || stride % 4 || stride < per + 3 || blocks < 1 ||
      blocks > (bsz + entries - 1) / entries)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(mid) - reinterpret_cast<uintptr_t>(dmid)) % 16)
    return cudaErrorMisalignedAddress;
  const size_t smem = 16 + (size_t)entries * (2 * stride + (k_steps + 3) * rank) * sizeof(float);
  cudaError_t err = repro::allow_smem(repro::tt_contract_bwd_slab_kernel, smem);
  if (err != cudaSuccess) return err;
  repro::tt_contract_bwd_slab_kernel<<<blocks, threads, smem, st>>>(
      f, m, l, d, df, dm, dl, bsz, k_steps, rank, entries, stride);
  return cudaGetLastError();
}
