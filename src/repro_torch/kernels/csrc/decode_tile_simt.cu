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
// math in f32 FMAs (no TF32); bf16 weights are widened to f32 as they are
// staged, and the output is cast to the embedding dtype.
//
// Bound: operations, 2.0 MFLOP an entry at H 68, R 34, T 10 (8.0 at H 114,
// R 57) against 44 bytes of index and output, so the FP32 rate bounds it.
// Design, the TPU kernel's: a block owns a tile of TB entries for all T
// steps and runs every step as products over the tile, so that each weight
// is read once a block and used TB times.
//
// * State.  x_t, h (two buffers), c, v and v_new of the tile sit in shared
//   memory transposed, [unit][entry], so a thread reads the 8 entries of its
//   tile with two 16-byte loads: entry e sits at column
//   ((e % 8) / 4) * TB / 2 + (e / 8) * 4 + e % 4.  The block gathers x_t
//   one embedding row a warp, coalesced.  TB, a multiple of 8, is the
//   largest tile whose state and two weight stages fit a block's shared
//   memory (kernels/decode_tile.py:simt_tile, simt_smem_floats below).
//   The state layout, the weight staging and the gate product are
//   simt_tile.cuh's, shared with the LSTM scan's simt body.
// * Weights stream through a double buffer of shared memory, one barrier a
//   stage: stage s + 1 is in flight (cp.async in f32; bf16 is widened to f32
//   through registers) while stage s is computed.  Each is read once a block
//   a step and used by all TB entries.
// * Gates.  [TB, 2H] . [wi; wh] [2H, 4H] as a register-tiled product: a
//   thread owns 8 entries x 2 units x the four gates (64 sums), so the cell
//   update happens in its registers.  Gate columns are regrouped by unit as
//   they are staged (column 8 p + 4 u + g holds gate g of unit 2 p + u), so
//   a thread reads its 8 weights of a K row with two 16-byte loads that the
//   warp shares.  c is read and written once a step beside h_new, in shared
//   memory: a thread owns several (entry, unit) tiles when they outnumber
//   the block's threads, a run-time count that registers cannot index.
// * Mid step.  v_new[e, s] = sum_r v[e, r] (h[e, :] . W_mid[:, r R + s] +
//   b_mid[r R + s]), with w_mid [H, R R] read as [H R, R] (row k R + r sits
//   at k R^2 + r R, 16-byte aligned since the wrapper pads R to a multiple
//   of 4 with zeros, which keeps the padded columns of v at 0), so the
//   R x R core is never built and no [B, R^2] intermediate leaves the SM.
//   A thread owns 8 entries x 4 columns of v_new; for each r it sums
//   h . W_mid over the K rows of r (32 sums), then folds v[e, r] (sum +
//   b_mid) into v_new, in the plain version's order.  The (entry, column)
//   tiles are fewer than the threads, so the r range is split among G
//   groups whose sums are added in group order through shared memory: the
//   result does not depend on the schedule.  The first and last heads are
//   the same product with one r and a factor of 1.
// * 512 threads a block (one block a SM by shared memory): 16 warps hide
//   the shared-load latency better than fewer threads with fewer idle ones
//   (PERF.md, section 6).  SimtPlan picks G for the fewest rounds of r's.
#include <climits>

#include "simt_tile.cuh"

namespace repro {

constexpr int kSimtMaxGroups = 4;  // r groups of the mid step

// Dynamic shared memory of a block, in floats: x, h, h_new, c ([H][TB]
// each), v, v_new ([R][TB] each) and two weight stages.
__host__ __device__ inline long long simt_smem_floats(int hid, int rank, int tile) {
  return (long long)tile * (4LL * hid + 2LL * rank) + 2 * simt_stage_floats(hid, rank);
}

// gate_phase's fields (those of simt_tile.cuh's SimtTile) and the heads'
struct SimtPlan {
  int hid, rank, tile, half, eg;  // eg: entry groups of 8
  int cgs;                        // column groups of 4 in R
  int stage;                      // floats of one weight stage
  int groups, rg;                 // mid: r groups and r's per group
  int kb_mid, chunks_mid;         // mid: K rows a stage holds per r, stages per r
  int kb_head, chunks_head;       // first / last heads (one r, one group)
};

__host__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// rank a multiple of 4 (the caller's rank, kernels/decode_tile.py:simt_rank)
__host__ inline SimtPlan simt_plan(int hid, int rank, int tile) {
  SimtPlan p{};
  p.hid = hid;
  p.rank = rank;
  p.tile = tile;
  p.half = tile / 2;
  p.eg = tile / kSimtEntries;
  p.cgs = rank / 4;
  p.stage = static_cast<int>(simt_stage_floats(hid, rank));
  // the r groups that take the fewest rounds of r's (a round: a tile per
  // thread of the block)
  int best = 0;
  for (int g = 1; g <= kSimtMaxGroups && g <= rank && g * rank <= p.stage; ++g) {
    const int cost = ceil_div(p.eg * p.cgs * g, kSimtThreads) * ceil_div(rank, g);
    if (best == 0 || cost < best) {
      best = cost;
      p.groups = g;
    }
  }
  p.rg = ceil_div(rank, p.groups);
  p.chunks_mid = ceil_div(hid, p.stage / (p.groups * rank));
  p.kb_mid = ceil_div(hid, p.chunks_mid);
  p.chunks_head = ceil_div(hid, p.stage / rank);
  p.kb_head = ceil_div(hid, p.chunks_head);
  return p;
}

// ------------------------------------------------------------------ heads
// Four weights (16-byte aligned in f32, 8 in bf16) as f32.
__device__ __forceinline__ float4 load4_f(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4_f(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// Four weights into a stage: f32 through one 16-byte cp.async, bf16
// widened through registers.
__device__ __forceinline__ void stage4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<float4*>(dst) = load4_f(src);
}

// vout[e, s] = sum_{r < nr} vin[e, r] (h[e, :] . W[:, r, s] + bias[r, s]),
// W row (k nr + r) of R values; vin == nullptr reads as 1 (the first and
// last heads, nr = 1).  A thread owns 8 entries x 4 columns in one of
// `groups` groups of rg r's, item (grp eg + eg_i) cgs + cg, so a warp's
// threads read neighbouring columns and share entries.  A stage holds kb K
// rows of one r of each group: stage row g kb + kk.
template <typename T>
__device__ void head_phase(const SimtPlan& p, const float* hs, const float* vin, float* vout,
                           float* buf, const T* __restrict__ w, const T* __restrict__ bias,
                           int nr, int groups, int rg, int kb, int chunks) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int hid = p.hid, rank = p.rank, lda = p.tile;
  const int per_group = p.eg * p.cgs;
  const int items = per_group * groups;
  const int nstage = rg * chunks;
  // the fill's float4s, stepping by nt: (stage row g kb + kk, column c4)
  const int q4 = rank / 4, total4 = groups * kb * q4;
  const int dkk = nt / q4, dc4 = nt - dkk * q4;
  const int g0 = tid / q4 / kb, kk0 = tid / q4 - g0 * kb, c40 = tid - tid / q4 * q4;
  for (int t0 = 0; t0 < items; t0 += nt) {
    const int item = t0 + tid;
    const bool active = item < items;
    const int grp = active ? item / per_group : 0;
    const int rem = item - grp * per_group;
    const int eg = rem / p.cgs;
    const int cg = rem - eg * p.cgs;
    float acc[4][8], vac[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[q][i] = vac[q][i] = 0.f;

    // rows the compute does not read (past the group's r's, past H) are
    // not staged
    auto fill = [&](int s, float* dst) {
      const int ri = s / chunks, k0 = (s - ri * chunks) * kb;
      const int rows = min(kb, hid - k0);
      int g = g0, kk = kk0, c4 = c40;
      for (int f = tid; f < total4; f += nt) {
        const int r = g * rg + ri;
        if (r < nr && kk < rows)
          stage4(dst + 4 * f, w + ((size_t)(k0 + kk) * nr + r) * rank + 4 * c4);
        c4 += dc4;
        kk += dkk;
        if (c4 >= q4) {
          c4 -= q4;
          ++kk;
        }
        while (kk >= kb) {
          kk -= kb;
          ++g;
        }
      }
    };
    auto compute = [&](int s, const float* cur) {
      if (!active) return;
      const int ri = s / chunks, chunk = s - ri * chunks;
      const int r = grp * rg + ri;
      if (r >= nr) return;
      const int k0 = chunk * kb, rows = min(kb, hid - k0);
      const float* bcol = cur + grp * kb * rank + cg * 4;
#pragma unroll 4
      for (int kk = 0; kk < rows; ++kk) {
        float a[8];
        load8(hs + (k0 + kk) * lda, p.half, eg, a);
        const float4 b4 = *reinterpret_cast<const float4*>(bcol + kk * rank);
        const float bw[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[q][i] = fmaf(a[i], bw[q], acc[q][i]);
      }
      if (chunk == chunks - 1) {  // r is complete: fold it into vout
        float vr[8];
        if (vin) {
          load8(vin + r * lda, p.half, eg, vr);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) vr[i] = 1.f;
        }
        const float4 b4 = load4_f(bias + (size_t)r * rank + cg * 4);
        const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            vac[q][i] = fmaf(vr[i], acc[q][i] + bq[q], vac[q][i]);
            acc[q][i] = 0.f;
          }
      }
    };
    pipeline(buf, p.stage, nstage, fill, compute);

    // the groups' sums, added in group order
    for (int g = 0; g < groups; ++g) {
      if (active && grp == g) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float* row = vout + (cg * 4 + q) * lda;
          float prev[8];
          if (g > 0) {
            load8(row, p.half, eg, prev);
#pragma unroll
            for (int i = 0; i < 8; ++i) vac[q][i] += prev[i];
          }
          store8(row, p.half, eg, vac[q]);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
decode_tile_simt_kernel(const int* __restrict__ idx, const T* __restrict__ emb,
                        const T* __restrict__ wi, const T* __restrict__ wh,
                        const T* __restrict__ b, const T* __restrict__ w_first,
                        const T* __restrict__ b_first, const T* __restrict__ w_mid,
                        const T* __restrict__ b_mid, const T* __restrict__ w_last,
                        const T* __restrict__ b_last, T* __restrict__ out, long long bsz,
                        int t_steps, int m_rows, const SimtPlan p) {
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int hid = p.hid, lda = p.tile;
  float* xs = smem;
  float* hs = xs + hid * lda;
  float* hn = hs + hid * lda;
  float* cs = hn + hid * lda;
  float* vs = cs + hid * lda;
  float* vn = vs + p.rank * lda;
  float* buf = vn + p.rank * lda;
  const long long e0 = (long long)blockIdx.x * p.tile;

  for (int f = tid; f < hid * lda; f += nt) hs[f] = cs[f] = 0.f;
  for (int t = 0; t < t_steps; ++t) {
    // x_t = emb[t, idx[:, t]], one row a warp
    for (int e = warp; e < p.tile; e += nwarps) {
      const long long ge = e0 + e;
      const int ix = ge < bsz ? idx[ge * t_steps + t] : -1;
      const bool ok = ix >= 0 && ix < m_rows;
      const T* row = emb + ((size_t)t * m_rows + (ok ? ix : 0)) * hid;
      const int col = entry_column(e, p.half);
      for (int k = lane; k < hid; k += 32) xs[k * lda + col] = ok ? load_f(row + k) : 0.f;
    }
    __syncthreads();
    gate_phase(p, xs, hs, hn, cs, buf, wi, wh, b);
    float* tmp = hs;
    hs = hn;
    hn = tmp;
    if (t == 0) {
      head_phase(p, hs, nullptr, vs, buf, w_first, b_first, 1, 1, 1, p.kb_head, p.chunks_head);
    } else if (t == t_steps - 1) {
      head_phase(p, hs, nullptr, vn, buf, w_last, b_last, 1, 1, 1, p.kb_head, p.chunks_head);
    } else {
      head_phase(p, hs, vs, vn, buf, w_mid, b_mid, p.rank, p.groups, p.rg, p.kb_mid,
                 p.chunks_mid);
      tmp = vs;
      vs = vn;
      vn = tmp;
    }
  }
  // out = v . last, both in shared memory (padded columns are 0)
  for (int e = tid; e < p.tile; e += nt) {
    if (e0 + e >= bsz) continue;
    const int col = entry_column(e, p.half);
    float o = 0.f;
    for (int s = 0; s < p.rank; ++s) o = fmaf(vs[s * lda + col], vn[s * lda + col], o);
    store_f(out + e0 + e, o);
  }
}

template <typename T>
cudaError_t launch_decode_tile_simt(const void* idx, const void* emb, const void* wi,
                                    const void* wh, const void* b, const void* wf,
                                    const void* bf, const void* wm, const void* bm,
                                    const void* wl, const void* bl, void* out, long long bsz,
                                    int t_steps, int m_rows, const SimtPlan& p,
                                    cudaStream_t stream) {
  const size_t smem = (size_t)simt_smem_floats(p.hid, p.rank, p.tile) * sizeof(float);
  cudaError_t err = allow_smem(decode_tile_simt_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decode_tile_simt_kernel<T><<<grid_for(bsz, p.tile), kSimtThreads, smem, stream>>>(
      static_cast<const int*>(idx), static_cast<const T*>(emb), static_cast<const T*>(wi),
      static_cast<const T*>(wh), static_cast<const T*>(b), static_cast<const T*>(wf),
      static_cast<const T*>(bf), static_cast<const T*>(wm), static_cast<const T*>(bm),
      static_cast<const T*>(wl), static_cast<const T*>(bl), static_cast<T*>(out), bsz,
      t_steps, m_rows, p);
  return cudaGetLastError();
}

}  // namespace repro

// tile: the entries a block owns, a multiple of 8 whose state fits
// (kernels/decode_tile.py:simt_tile)
extern "C" int repro_decode_tile_simt(const void* idx, const void* emb, const void* wi,
                                      const void* wh, const void* b, const void* wf,
                                      const void* bf, const void* wm, const void* bm,
                                      const void* wl, const void* bl, void* out,
                                      long long bsz, int t_steps, int m_rows, int hid,
                                      int rank, int tile, int dtype, void* stream) {
  if (bsz <= 0) return 0;
  if (bsz > INT_MAX || t_steps < 2 || hid < 1 || rank < 1 || rank % 4 ||
      tile < repro::kSimtEntries || tile % repro::kSimtEntries ||
      repro::simt_smem_floats(hid, rank, tile) * 4 > repro::kMaxSmemBytes)
    return cudaErrorInvalidValue;
  const repro::SimtPlan p = repro::simt_plan(hid, rank, tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32)
    return repro::launch_decode_tile_simt<float>(idx, emb, wi, wh, b, wf, bf, wm, bm, wl, bl,
                                                 out, bsz, t_steps, m_rows, p, s);
  if (dtype == repro::kDtypeBF16)
    return repro::launch_decode_tile_simt<__nv_bfloat16>(idx, emb, wi, wh, b, wf, bf, wm, bm,
                                                         wl, bl, out, bsz, t_steps, m_rows, p,
                                                         s);
  return cudaErrorInvalidValue;
}
