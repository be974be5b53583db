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
// the bound is those bytes over 3.35 TB/s.  So mid is read from device
// memory once and dmid written once, and the sweeps' dependent steps must
// hide behind that traffic.
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
// * wide, above that (K 8: R 43 .. 128), where one entry's cores fill most
//   of an SM (K 8, R 57: 104 KB) or more than one (R 128: 512 KB).  A
//   cluster of C blocks (1, 2, 4 or 8, the wrapper's wide_plan: the fewest
//   whose blocks fit two a SM) splits every core by rows: block c holds
//   rows [c S, c S + S) of each of the entry's K cores, S = ceil(R / C),
//   one slot a core, so the cluster holds the whole entry and mid is read
//   from device memory once.  Persistent clusters walk over the entries,
//   two or three blocks a SM, so that several entries' sweeps hide each
//   other's latencies.  Each slot has its own mbarrier: warp 0 copies a
//   core into its slot (one TMA bulk copy, the ragged head and tail by
//   4-byte cp.async, all completing on the slot's mbarrier) as soon as the
//   sweeps are done with the slot's previous core.  For that the entries
//   alternate the order of the sweeps: an even entry runs the prefix, then
//   the suffix, which frees the cores K-1 .. 0; an odd entry the suffix
//   (keeping every u), then the prefix, which frees them 0 .. K-1; so the
//   core freed first is the one the next entry's first sweep needs first,
//   and its copy has a whole sweep to land.  Each sweep step is one
//   product of a core's rows with a vector, all blocks at once:
//   - prefix, v_{k+1} = v_k mid_k: thread (p, j) of a block sums its rows
//     p, p + P, ... (P = threads / R) of column j against its rows of v_k
//     and writes the partial sum into the shared memory of the block that
//     owns row j of v_{k+1} (st.async, distributed shared memory, counted
//     in bytes on that block's mbarrier); each block waits for its C P
//     partials of its rows and adds them, a group of lanes a row, by
//     shuffles;
//   - suffix, u_k = mid_k u_{k+1}: a group of L lanes a row (L the most,
//     up to 32, whose groups cover the block's rows), each lane over the
//     columns j = lane + L i, visited from a start rotated by the row so
//     that the rows of a warp fall on other banks, summed by log2(L)
//     butterfly shuffles; every lane then holds u_k[row] and the group
//     writes it into every block's u_k by st.async, and each block waits
//     for all R.
//   An exchange's buffers and mbarrier alternate between two sets, safe
//   without a cluster barrier: a block sends step s + 2 only after it has
//   received step s + 1 from every block, which each sent only after
//   reading step s.  dmid_k = g v_k (x) u_{k+1} needs no mid: the second
//   sweep stores its rows straight to device memory from v and u,
//   coalesced, while the step's exchange is awaited.  2K - 1 exchanges an
//   entry (the last suffix step exchanges nothing: dfirst needs only a
//   block's own rows); a cluster barrier only at the start and, where K
//   <= 3, after an even entry; a cluster of one block writes its own
//   shared memory and syncs its threads instead.  An entry's g, first and
//   last are read one entry ahead.
// No sum runs across entries, so there are no atomics.  Offsets are 64-bit.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {

constexpr int kTTBwdWideThreads = 512;  // most threads of a wide block
constexpr int kTTBwdSlabThreads = 256;  // most threads of a slab block

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

// Warp 0 of a wide block: start the copy of `count` floats at `src` (a
// block's rows of one core) into the slot `dst`, at their offset from the
// 16-byte grid: the aligned interior by one TMA bulk copy, the ragged head
// and tail (at most 3 + 3 floats) by 4-byte cp.async, all completing on
// `bar`, whose phase expects 33 arrivals: lane 0's with the interior's
// bytes and each lane's once its cp.async are done.
__device__ __forceinline__ void load_core(float* dst, const float* __restrict__ src, int count,
                                          uint32_t bar, int lane) {
  const EntrySpan s = entry_span(src, count);
  float* m = dst + s.shift;
  const int tail = s.head + (int)(s.bulk >> 2);
  if (lane < s.head + count - tail) {
    const int f = lane < s.head ? lane : tail + lane - s.head;
    cp_async4(smem_addr(m + f), src + f);
  }
  cp_async_arrive(bar);
  if (lane == 0) {
    mbar_expect_tx(bar, s.bulk);
    if (s.bulk) bulk_load(smem_addr(m + s.head), src + s.head, s.bulk, bar);
  }
}

// The cluster's barrier, or the block's where the cluster is one block.
__device__ __forceinline__ void wide_sync(int nc) {
  if (nc > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// Shared memory: K mbarriers (8 bytes each, rounded up to 16 bytes), K
// slots of `slot` floats (this block's rows of a core and their offset
// from the 16-byte grid), this block's rows of v_0 .. v_K ((K + 1) `rows`
// floats), every u_0 .. u_K ((K + 1) R) and two sets of the prefix's
// partial sums (2 C P `rows`).  Launched in clusters of C blocks along x.
__global__ void __launch_bounds__(kTTBwdWideThreads, 2)
tt_contract_bwd_wide_cluster_kernel(const float* __restrict__ first,
                                    const float* __restrict__ mid,
                                    const float* __restrict__ last,
                                    const float* __restrict__ dout, float* __restrict__ dfirst,
                                    float* __restrict__ dmid, float* __restrict__ dlast,
                                    long long bsz, int k_steps, int rank, int rows, int slot) {
  extern __shared__ __align__(16) unsigned char tt_wide_smem[];
  const uint32_t bars = smem_addr(tt_wide_smem);
  const int nc = (int)cluster_blocks();
  const int c = (int)cluster_rank();
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const bool loader = tid < 32;
  const int parts = nt / rank;
  // mbarriers: one a slot, then the partials' two sets', then u's two sets'
  const uint32_t red_bars = bars + 8 * k_steps;
  const uint32_t u_bars = red_bars + 16;
  float* slots = reinterpret_cast<float*>(tt_wide_smem + ((k_steps + 4) * 8 + 15) / 16 * 16);
  float* vs = slots + (size_t)k_steps * slot;
  float* us = vs + (size_t)(k_steps + 1) * rows;
  float* red = us + (size_t)(k_steps + 1) * rank;
  const int red_set = nc * parts * rows;
  const int r0 = c * rows;
  const int nr = min(rows, rank - r0);  // this block's rows
  const int count = nr * rank;          // its floats of a core
  const long long rr = (long long)rank * rank;
  // prefix: thread (pp, pj) sums column pj over rows pp, pp + parts, ...
  // and hands the partial to the block owning row pj of the next v
  const int pp = tid / rank;
  const int pj = tid - pp * rank;
  const bool prefix = pp < parts;
  const int owner = pj / rows;
  float* red_out = red + (c * parts + pp) * rows + pj - owner * rows;
  const uint32_t red_dst = cluster_map(smem_addr(red_out), owner);
  const uint32_t red_dst_bars = cluster_map(red_bars, owner);
  // the partials' sum: `group` lanes a row (vr) of v_{k+1}, lane vq over
  // the slots vq, vq + group, ..., then butterfly shuffles
  const int nslots = nc * parts;
  int group = 1;
  while (group < 32 && group * 2 <= nslots && nr * group * 2 <= nt) group *= 2;
  const int vr = tid / group;
  const int vq = tid - vr * group;
  // suffix: `lanes` lanes a row (sr), lane sq over columns sq + lanes i,
  // i from a start rotated by the row, then butterfly shuffles
  int lanes = 32;
  while (lanes > 1 && nr * lanes > nt) lanes >>= 1;
  const int sr = tid / lanes;
  const int sq = tid - sr * lanes;
  const bool suffix = sr < nr;
  const int spans = (rank + lanes - 1) / lanes;
  const int rot = sr % spans;
  // dmid's rows: thread tid stores floats tid, tid + nt, ... of a core's rows
  const int dr = nt / rank;
  const int dj = nt - dr * rank;
  const int d_r = tid / rank;
  const int d_j = tid - d_r * rank;

  if (tid == 0) {
    for (int k = 0; k < k_steps; ++k) mbar_init(bars + 8 * k, 33);
    for (int b = 0; b < 4; ++b) mbar_init(red_bars + 8 * b, 1);
    mbar_init_fence();
  }
  wide_sync(nc);  // every block of the cluster running, its barriers ready
  const long long nq = cluster_count();
  long long e = cluster_index();
  if (loader && e < bsz)
    for (int k = 0; k < k_steps; ++k)
      load_core(slots + (size_t)k * slot, mid + (e * k_steps + k) * rr + (long long)r0 * rank,
                count, bars + 8 * k, lane);
  // an entry's g, its last (thread tid's column) and its first (tid's
  // row), read from device memory one entry ahead
  float gd_next = 0.f, last_next = 0.f, first_next = 0.f;
  if (e < bsz) {
    gd_next = __ldg(dout + e);
    if (tid < rank) last_next = __ldg(last + e * rank + tid);
    if (tid < nr) first_next = __ldg(first + e * rank + r0 + tid);
  }
  // the cluster's prefix steps and suffix exchanges so far: each one's set
  // of buffers and mbarrier is its count's parity, the mbarrier's phase
  // parity the next bit
  long long step = 0, ustep = 0;
  for (int it = 0; e < bsz; e += nq, ++it) {
    // Entries alternate the order of the sweeps, so that the core a sweep
    // frees first is the one the next entry's first sweep needs first: an
    // even entry runs the prefix, then the suffix (which stores dmid and
    // frees cores K-1 .. 0); an odd one the suffix (keeping every u), then
    // the prefix (which stores dmid and frees cores 0 .. K-1).  A freed
    // core's slot takes the next entry's core at once.
    const bool up = !(it & 1);
    const long long en = e + nq;
    const uint32_t parity = it & 1;
    const float gd = gd_next;
    if (tid < rank) us[(size_t)k_steps * rank + tid] = last_next;
    if (tid < nr) vs[tid] = first_next;
    if (en < bsz) {
      gd_next = __ldg(dout + en);
      if (tid < rank) last_next = __ldg(last + en * rank + tid);
      if (tid < nr) first_next = __ldg(first + en * rank + r0 + tid);
    }
    __syncthreads();
    for (int sweep = 0; sweep < 2; ++sweep) {
      const bool second = sweep == 1;
      if (up != second) {
        // prefix: v_{k+1}[j] = sum over the blocks of their rows of v_k . column j
        for (int k = 0; k < k_steps; ++k, ++step) {
          const int set = (int)(step & 1);
          const float* src = mid + (e * k_steps + k) * rr + (long long)r0 * rank;
          const float* m = slots + (size_t)k * slot + entry_span(src, count).shift;
          if (!second) mbar_wait(bars + 8 * k, parity);
          if (nc > 1 && tid == 0) mbar_expect_tx(red_bars + 8 * set, 4 * nslots * nr);
          if (prefix) {
            const float* v = vs + (size_t)k * rows;
            float acc0 = 0.f, acc1 = 0.f;
            int r = pp;
            for (; r + parts < nr; r += 2 * parts) {
              acc0 = fmaf(v[r], m[r * rank + pj], acc0);
              acc1 = fmaf(v[r + parts], m[(r + parts) * rank + pj], acc1);
            }
            if (r < nr) acc0 = fmaf(v[r], m[r * rank + pj], acc0);
            if (nc > 1)
              st_async(red_dst + 4 * set * red_set, acc0 + acc1, red_dst_bars + 8 * set);
            else
              red_out[set * red_set] = acc0 + acc1;
          }
          if (second) {  // dmid_k = g v_k (x) u_{k+1}, this block's rows
            float* dst = dmid + (e * k_steps + k) * rr + (long long)r0 * rank;
            const float* v = vs + (size_t)k * rows;
            const float* u = us + (size_t)(k + 1) * rank;
            int r = d_r, j = d_j;
            for (int f = tid; f < count; f += nt) {
              dst[f] = gd * v[r] * u[j];
              r += dr;
              j += dj;
              if (j >= rank) {
                j -= rank;
                ++r;
              }
            }
          }
          // every block's partials of this block's rows
          if (nc > 1)
            mbar_wait_cluster(red_bars + 8 * set, (uint32_t)(step >> 1) & 1);
          else
            __syncthreads();
          float sum = 0.f;
          if (vr < nr)
            for (int i = vq; i < nslots; i += group) sum += red[set * red_set + i * rows + vr];
          for (int off = group >> 1; off; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (vr < nr && vq == 0) vs[(size_t)(k + 1) * rows + vr] = sum;
          __syncthreads();  // every thread here is done with slot k
          if (second && loader && en < bsz)
            load_core(slots + (size_t)k * slot,
                      mid + (en * k_steps + k) * rr + (long long)r0 * rank, count, bars + 8 * k,
                      lane);
        }
        if (tid < nr) dlast[e * rank + r0 + tid] = gd * vs[(size_t)k_steps * rows + tid];
      } else {
        // suffix: u_k[row] = row of mid_k . u_{k+1}, into every block's u_k
        for (int k = k_steps - 1; k >= 0; --k) {
          const float* src = mid + (e * k_steps + k) * rr + (long long)r0 * rank;
          const float* m = slots + (size_t)k * slot + entry_span(src, count).shift;
          const float* u = us + (size_t)(k + 1) * rank;
          if (!second) mbar_wait(bars + 8 * k, parity);
          const int uset = (int)(ustep & 1);
          if (nc > 1 && k > 0 && tid == 0) mbar_expect_tx(u_bars + 8 * uset, 4 * rank);
          float acc0 = 0.f, acc1 = 0.f;
          if (suffix) {
            const float* row = m + sr * rank;
            int i = 0;
            for (int s = rot; i + 1 < spans; i += 2) {
              const int j0 = sq + s * lanes;
              if (++s == spans) s = 0;
              const int j1 = sq + s * lanes;
              if (++s == spans) s = 0;
              if (j0 < rank) acc0 = fmaf(row[j0], u[j0], acc0);
              if (j1 < rank) acc1 = fmaf(row[j1], u[j1], acc1);
            }
            if (i < spans) {
              const int j0 = sq + ((rot + i) % spans) * lanes;
              if (j0 < rank) acc0 = fmaf(row[j0], u[j0], acc0);
            }
          }
          float acc = acc0 + acc1;
          for (int off = lanes >> 1; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
          if (k > 0 && suffix) {
            float* dst = us + (size_t)k * rank + r0 + sr;
            if (nc == 1 && sq == 0) *dst = acc;
            if (nc > 1)
              for (int d = sq; d < nc; d += lanes)
                st_async(cluster_map(smem_addr(dst), d), acc, cluster_map(u_bars + 8 * uset, d));
          } else if (k == 0 && suffix && sq == 0) {
            dfirst[e * rank + r0 + sr] = gd * acc;
          }
          if (second) {  // dmid_k = g v_k (x) u_{k+1}, this block's rows
            float* dst = dmid + (e * k_steps + k) * rr + (long long)r0 * rank;
            const float* v = vs + (size_t)k * rows;
            int r = d_r, j = d_j;
            for (int f = tid; f < count; f += nt) {
              dst[f] = gd * v[r] * u[j];
              r += dr;
              j += dj;
              if (j >= rank) {
                j -= rank;
                ++r;
              }
            }
          }
          if (k > 0) {
            // every block's rows of u_k here; so every warp here that holds
            // a row has passed its shuffles, done with slot k
            if (nc > 1)
              mbar_wait_cluster(u_bars + 8 * uset, (uint32_t)(ustep >> 1) & 1);
            else
              __syncthreads();
            ++ustep;
            if (second && loader && en < bsz)
              load_core(slots + (size_t)k * slot,
                        mid + (en * k_steps + k) * rr + (long long)r0 * rank, count, bars + 8 * k,
                        lane);
          }
        }
      }
    }
    // the entry's v and u are free here.  Past an even entry, a block may
    // run on into the next entry's first exchange, u_{K-1}, while another
    // still reads u_1 and u_2 in its last steps: a race where K <= 3 only,
    // which a cluster barrier closes
    if (up && k_steps <= 3)
      wide_sync(nc);
    else
      __syncthreads();
    if (up && loader && en < bsz)  // core 0, which the last suffix step read
      load_core(slots, mid + en * k_steps * rr + (long long)r0 * rank, count, bars, lane);
  }
}

}  // namespace repro

// f32 only.  plan 0 (slab): `entries` a slab, slots of `stride` floats,
// `threads` a block (whole warps, at least entries x rank), `blocks`
// persistent blocks; mid and dmid at the same offset from the 16-byte grid.
// plan 1 (wide): clusters of `cluster` blocks, each holding ceil(rank /
// cluster) rows of every core in slots of `stride` floats, `threads` a
// block (at least rank); `blocks` persistent blocks (a multiple of
// `cluster`) at most, and no more clusters than fit the card at once.
// `cluster` is 1 for the slab plan.
extern "C" int repro_tt_contract_bwd(const void* first, const void* mid, const void* last,
                                     const void* dout, void* dfirst, void* dmid, void* dlast,
                                     long long bsz, int k_steps, int rank, int plan,
                                     int entries, int stride, int threads, int blocks,
                                     int cluster, void* stream) {
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
    if (cluster < 1 || cluster > 8) return cudaErrorInvalidValue;
    const int rows = (rank + cluster - 1) / cluster;
    const int parts = threads / rank;
    if (threads % 32 || threads > repro::kTTBwdWideThreads || parts < 1 ||
        rows * (cluster - 1) >= rank || stride % 4 || stride < rows * rank + 3 || blocks < 1 ||
        blocks % cluster)
      return cudaErrorInvalidValue;
    const size_t smem = ((k_steps + 4) * 8 + 15) / 16 * 16 +
                        ((size_t)k_steps * stride + (size_t)(k_steps + 1) * (rows + rank) +
                         2 * (size_t)cluster * parts * rows) *
                            sizeof(float);
    cudaError_t err = repro::allow_smem(repro::tt_contract_bwd_wide_cluster_kernel, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, repro::tt_contract_bwd_wide_cluster_kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    if (blocks > fit * cluster) cfg.gridDim = dim3(fit * cluster);
    err = cudaLaunchKernelEx(&cfg, repro::tt_contract_bwd_wide_cluster_kernel, f, m, l, d, df, dm,
                             dl, bsz, k_steps, rank, rows, stride);
    if (err != cudaSuccess) return err;
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
