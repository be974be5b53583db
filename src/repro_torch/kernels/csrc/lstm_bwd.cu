// Backward of the LSTM scan (lstm.cu, lstm_dispatch.cu), backpropagation
// through the T steps: from x [B, T, H], the weights wi, wh [H, 4H] and b
// [4H], the forward's hidden states hs [B, T, H] and their gradient dhs, it
// writes dx [B, T, H], G [B T, 4H], the gradient of every step's gate
// pre-activations (i, f, g, o), and A [B T, 2H + 1], every step's operand
// row [x_t | h_{t-1} | 1], so that the caller's weight gradients are one
// product over B T: [dwi; dwh; db] = A^T G (kernels/lstm.py:weight_grads).
// f32 only, 1 <= H <= 256 (kLstmBwdMaxHidden), any T >= 1, B < 2^31.
//
// Replaces the gradient of the Pallas TPU kernel repro/kernels/lstm.py:
// lstm_scan (body _kernel).  The JAX package defines no custom_vjp: its
// gradient is jax.grad of the jnp oracle, which this kernel computes.
//
// Bound: at the MEDIUM fit shape (B 8192, T 10, H 18) bytes, 0.0141 ms at
// 3.35 TB/s: x, hs and dhs read (3 B T H floats), dx and G written (5 B T
// H); the operations, 32 H^2 FLOP a sequence and step (the gates once, 16
// H^2, and [dx | dh] = dG [wi; wh]^T, 16 H^2), take 0.0127 ms at 67
// TFLOP/s.  A (B T (2H + 1) floats, a copy of x and hs) is not in the
// bound: the design writes it so the weight gradients are one product.
//
// Design: a block owns a tile of TB = S G sequences for all T steps; a
// thread owns one hidden unit j of one group of S sequences (thread = j G +
// group: a warp spans a few units and a few groups, so each of its shared
// loads touches one or two 128-byte lines), and so holds a register tile in
// both products: the four gates of unit j for its S sequences, then dx and
// dh of unit j.  Each step's operands sit in shared memory transposed,
// [row][sequence]: x_t and h_{t-1} (two buffers, the next step's cp.async
// in flight while this one computes) and dG_t.
// * Weights, [wi; wh] unit-major: row k of 4H as (unit, gate), row stride
//   4 (H | 1), so the gate product reads a unit's four gates as one 16-byte
//   load and the backward product reads its own rows j (of wi) and H + j
//   (of wh), whose odd stride spreads neighbouring units over the banks.
//   Three plans (kernels/lstm.py:bwd_plan), by where the weights live:
//   - narrow (H <= 45, at most 64 KB, every width a fit of the paper runs):
//     S 4, blocks of at most 128 threads; the block stages the weights
//     into shared memory once, from wi and wh as they are, so a product
//     costs its FMAs alone and the reverse sweep recomputes the gates;
//   - mid (H <= 71, at most 160 KB): S 8, one block a SM holding them the
//     same way, its tile sized to the batch so the blocks fill the SMs in
//     whole waves;
//   - wide: S 8, one group a block; the caller lays the weights out so once
//     a call (bwd_weights) and each product reads them through the L1
//     cache, so each weight read feeds 32 FMAs.
//   Mid and wide keep the gates of every step instead of recomputing them.
// * Forward sweep, t = 0 .. T-1: the gates [x_t | h_{t-1}] . [wi; wh] + b
//   from x and the saved hs (no product waits on another step's), the row
//   of A written from the staged operands, and c_t = f c_{t-1} + i g,
//   carried in registers and stored for every step in a scratch of the
//   caller's (7 MB at the fit shape, so it stays in L2), each thread reading back
//   only its own float4s, one step ahead; mid and wide store the activated
//   gates there too.
// * Reverse sweep, t = T-1 .. 0: the narrow plan recomputes the gates (the
//   same product on the same operands, so bit for bit the forward's), the
//   others read them back.  Then dh = dhs_t + dh_rec, dc = dc_carry + dh o
//   (1 - tanh^2 c_t), dc_carry = dc f, and dG_t (i: dc g i(1-i), f: dc
//   c_{t-1} f(1-f), g: dc i(1-g^2), o: dh tanh(c_t) o(1-o)) goes to G once
//   and to shared memory; then [dx_t | dh_rec] = dG_t . [wi; wh]^T is one
//   product over the tile, dx_t written by the kernel, dh_rec kept in
//   registers for step t - 1.
// Every sum runs inside one sequence, so there are no atomics.
#include <climits>

#include "lstm_cell.cuh"
#include "simt_tile.cuh"

namespace repro {

constexpr int kLstmBwdMaxHidden = 256;

// The three plans (kernels/lstm.py:bwd_plan), by where the weights are read
// from: each plan's sequences of a thread's tile and threads a block at most.
enum LstmBwdKind { kBwdNarrow = 0, kBwdMid = 1, kBwdWide = 2 };
__host__ __device__ constexpr int lstm_bwd_seqs(int kind) { return kind == kBwdNarrow ? 4 : 8; }
__host__ __device__ constexpr int lstm_bwd_max_threads(int kind) {
  return kind == kBwdNarrow ? 128 : kind == kBwdMid ? 384 : 256;
}
// Floats a thread keeps of every step: c, and where the gates are not
// recomputed (mid, wide) the four gates too.
__host__ __device__ constexpr int lstm_bwd_kept(int kind) {
  return kind == kBwdNarrow ? 4 : 5 * 8;
}

// A block's plan (kernels/lstm.py:BwdPlan): tile = S G sequences, threads
// >= G H.
struct LstmBwdPlan {
  int hid, tile, threads, kind;
};

// Floats of a unit-major weight row: 4 a unit, an odd number of units.
__host__ __device__ inline int lstm_bwd_row_stride(int hid) { return 4 * (hid | 1); }

// Floats of a block's shared memory: x_t | h_{t-1} (two buffers) and dG_t,
// [row][sequence] each; the weights where they are in shared memory.
__host__ inline long long lstm_bwd_smem_floats(const LstmBwdPlan& p) {
  const long long h = p.hid;
  long long f = 8 * h * p.tile;
  if (p.kind != kBwdWide) f += 2 * h * lstm_bwd_row_stride(p.hid);
  return f;
}

// S floats as S / 4 float4s, `stride` float4s apart
template <int S>
__device__ __forceinline__ void store_quads(float4* p, size_t stride, const float (&v)[S]) {
#pragma unroll
  for (int q = 0; q < S / 4; ++q)
    p[q * stride] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int S>
__device__ __forceinline__ void load_quads(const float4* p, size_t stride, float (&v)[S]) {
#pragma unroll
  for (int q = 0; q < S / 4; ++q) {
    const float4 f = p[q * stride];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

template <int kKind>
__global__ void __launch_bounds__(lstm_bwd_max_threads(kKind), kKind == kBwdNarrow ? 4 : 1)
lstm_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wi,
                     const float* __restrict__ wh, const float* __restrict__ wt,
                     const float* __restrict__ b, const float* __restrict__ hs,
                     const float* __restrict__ dhs, float* __restrict__ dx,
                     float* __restrict__ dg, float* __restrict__ aop, float* scratch,
                     long long bsz, int t_steps, const LstmBwdPlan p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = lstm_bwd_seqs(kKind);
  constexpr int Q = S / 4;                         // float4s of S floats
  constexpr int kept = lstm_bwd_kept(kKind) / 4;   // float4s kept a thread and step
  constexpr bool kSmemW = kKind != kBwdWide;       // the weights in shared memory
  constexpr bool kRecompute = kKind == kBwdNarrow;  // the gates recomputed, not kept
  // the products' unrolling: deeper where the weights come through L1
  constexpr int kUnroll = kKind == kBwdWide ? 4 : 2;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int hid = p.hid, h2 = 2 * hid, h4 = 4 * hid, ld = p.tile, groups = p.tile / S;
  const int rs = lstm_bwd_row_stride(hid);
  const bool active = tid < groups * hid;
  const int j = tid / groups, col = (tid - j * groups) * S;
  const long long e0 = (long long)blockIdx.x * p.tile;
  float* as = smem;               // [2][2H][TB]: x_t rows, then h_{t-1} rows
  float* dgs = as + 2 * h2 * ld;  // [4H][TB]: dG_t, gate g of unit u in row g H + u
  float* wres = dgs + h4 * ld;     // the weights, where in shared memory
  // what a thread keeps of every step, float4s [t][field][thread]: c in
  // fields 0 .. Q - 1, then (mid and wide plans) gate g in fields Q (g + 1)
  // ..; each thread reads only its own
  float4* keep =
      reinterpret_cast<float4*>(scratch + (size_t)blockIdx.x * t_steps * kept * nt * 4) + tid;
  const float* wsrc = kSmemW ? wres : wt;

  // x_t and h_{t-1} (0 at t = 0, and for a sequence past B) of the tile,
  // element f = e 2H + k; a thread steps through f by nt
  const int de = nt / h2, dk = nt - de * h2;
  const int e_first = tid / h2, k_first = tid - e_first * h2;
  auto fill_step = [&](float* dst, int t) {
    for (int e = e_first, k = k_first; e < p.tile;) {
      const long long ge = e0 + e;
      const bool ok = ge < bsz && (k < hid || t > 0);
      const float* src = x;
      if (ok) {
        const size_t row = ((size_t)ge * t_steps + t) * hid;
        src = k < hid ? x + row + k : hs + (row - hid) + (k - hid);
      }
      stage_f(dst + k * ld + e, src, ok);
      e += de;
      k += dk;
      if (k >= h2) {
        k -= h2;
        ++e;
      }
    }
  };
  // A's rows of step t, [x_t | h_{t-1} | 1], from the staged operands
  const int wa = h2 + 1, dea = nt / wa, dka = nt - dea * wa;
  const int ea_first = tid / wa, ka_first = tid - ea_first * wa;
  auto write_a = [&](const float* src, int t) {
    for (int e = ea_first, k = ka_first; e < p.tile && e0 + e < bsz;) {
      aop[((size_t)(e0 + e) * t_steps + t) * wa + k] = k < h2 ? src[k * ld + e] : 1.f;
      e += dea;
      k += dka;
      if (k >= wa) {
        k -= wa;
        ++e;
      }
    }
  };
  auto load_w = [&](const float* w) {
    return kSmemW ? ld4(w) : __ldg(reinterpret_cast<const float4*>(w));
  };

  float acc[4][S];  // gate g of unit j, sequence col + s
  auto gate_product = [&](const float* a) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int s = 0; s < S; ++s) acc[g][s] = 0.f;
    if (!active) return;
    const float* ak = a + col;
    const float* wk = wsrc + 4 * j;
#pragma unroll kUnroll
    for (int k = 0; k < h2; ++k, ak += ld, wk += rs) {
      float av[S];
      load_quads(reinterpret_cast<const float4*>(ak), 1, av);
      const float4 w4 = load_w(wk);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[g][s] = fmaf(av[s], wv[g], acc[g][s]);
    }
  };

  // the bias is read where it is used (an L1 hit), not held in registers
  // over the kernel: the mid plan's 8 sequences then fit 168 registers
  float c[S], dcc[S], dhr[S];
#pragma unroll
  for (int s = 0; s < S; ++s) c[s] = dcc[s] = dhr[s] = 0.f;
  // what reverse step t reads from memory, loaded one step ahead: dhs_t,
  // c_{t-1} and (the wide plan) the gates of step t; c_t is carried
  float c_now[S], c_pre[S], g_pre[4][S], dhs_pre[S];
  auto prefetch = [&](int t) {
    if (!active) return;
    const float4* kt = keep + (size_t)t * kept * nt;
#pragma unroll
    for (int s = 0; s < S; ++s) c_pre[s] = 0.f;
    if (t > 0) load_quads(kt - (size_t)kept * nt, nt, c_pre);
    if constexpr (!kRecompute)
#pragma unroll
      for (int g = 0; g < 4; ++g) load_quads(kt + (size_t)Q * (g + 1) * nt, nt, g_pre[g]);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long ge = e0 + col + s;
      dhs_pre[s] = ge < bsz ? __ldg(dhs + ((size_t)ge * t_steps + t) * hid + j) : 0.f;
    }
  };

  if constexpr (kSmemW) {
    // wi and wh as they are, [k][g H + u], into the unit-major rows
    for (int f = tid; f < h2 * h4; f += nt) {
      const int k = f / h4, cc = f - k * h4, g = cc / hid, u = cc - g * hid;
      const float* src = k < hid ? wi + (size_t)k * h4 : wh + (size_t)(k - hid) * h4;
      stage_f(wres + k * rs + 4 * u + g, src + cc, true);
    }
  }
  fill_step(as, 0);
  stage_commit();
  // steps n = 0 .. 2T - 1: the forward sweep, then the reverse one; the
  // staged operands alternate between the two buffers by n
  const int steps = 2 * t_steps, staged = kRecompute ? steps : t_steps;
  for (int n = 0; n < steps; ++n) {
    const bool rev = n >= t_steps;
    const int t = rev ? steps - 1 - n : n;
    const float* a = as + (n & 1) * h2 * ld;
    if (n < staged) stage_wait_all();
    __syncthreads();  // this step's operands are in; every thread is done with the last step's
    if (n + 1 < staged) {
      fill_step(as + ((n + 1) & 1) * h2 * ld, n + 1 < t_steps ? n + 1 : steps - 2 - n);
      stage_commit();
    }
    float4* kt = keep + (size_t)t * kept * nt;
    if (!rev) {
      write_a(a, t);
      gate_product(a);
      if (active) {
        float gv[4][S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          gv[0][s] = sigmoid_fast(acc[0][s] + __ldg(b + j));
          gv[1][s] = sigmoid_fast(acc[1][s] + __ldg(b + hid + j));
          gv[2][s] = tanhf(acc[2][s] + __ldg(b + 2 * hid + j));
          if constexpr (!kRecompute) gv[3][s] = sigmoid_fast(acc[3][s] + __ldg(b + 3 * hid + j));
          c[s] = gv[1][s] * c[s] + gv[0][s] * gv[2][s];
          c_now[s] = c[s];
        }
        store_quads(kt, nt, c);
        if constexpr (!kRecompute)
#pragma unroll
          for (int g = 0; g < 4; ++g) store_quads(kt + (size_t)Q * (g + 1) * nt, nt, gv[g]);
      }
      if (t == t_steps - 1) prefetch(t);
      continue;
    }
    float ct[S], cp[S], gv[4][S], dhs_t[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ct[s] = c_now[s];
      c_now[s] = cp[s] = c_pre[s];
      dhs_t[s] = dhs_pre[s];
      if constexpr (!kRecompute)
#pragma unroll
        for (int g = 0; g < 4; ++g) gv[g][s] = g_pre[g][s];
    }
    if (t > 0) prefetch(t - 1);
    if constexpr (kRecompute) gate_product(a);
    if (active) {
      if constexpr (kRecompute)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float z = acc[g][s] + __ldg(b + g * hid + j);
            gv[g][s] = g == 2 ? tanhf(z) : sigmoid_fast(z);
          }
      float d[4][S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float gi = gv[0][s], gf = gv[1][s], gg = gv[2][s], go = gv[3][s];
        const float dh = dhs_t[s] + dhr[s];
        const float tc = tanhf(ct[s]);
        const float dc = dcc[s] + dh * go * (1.f - tc * tc);
        dcc[s] = dc * gf;
        d[0][s] = dc * gg * gi * (1.f - gi);
        d[1][s] = dc * cp[s] * gf * (1.f - gf);
        d[2][s] = dc * gi * (1.f - gg * gg);
        d[3][s] = dh * tc * go * (1.f - go);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
        store_quads(reinterpret_cast<float4*>(dgs + (g * hid + j) * ld + col), 1, d[g]);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const long long ge = e0 + col + s;
        if (ge >= bsz) continue;
        float* out = dg + ((size_t)ge * t_steps + t) * h4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) out[g * hid] = d[g][s];
      }
    }
    __syncthreads();  // dG_t of every unit is in
    if (!active) continue;
    // [dx_t | dh_rec] = dG_t . [wi; wh]^T: rows j and H + j of the weights;
    // with 4 sequences, gates i, f and gates g, o in two sums each, joined
    // at the end
    constexpr int kSums = S == 4 ? 2 : 1;
    float ax[kSums][S] = {}, ah[kSums][S] = {};
    const float* wx = wsrc + (size_t)j * rs;
    const float* wr = wsrc + (size_t)(hid + j) * rs;
    const float* dr = dgs + col;
#pragma unroll kUnroll
    for (int u = 0; u < hid; ++u, wx += 4, wr += 4, dr += ld) {
      const float4 u4 = load_w(wx), v4 = load_w(wr);
      const float uv[4] = {u4.x, u4.y, u4.z, u4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float dv[S];
        load_quads(reinterpret_cast<const float4*>(dr + g * hid * ld), 1, dv);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          ax[(g >> 1) % kSums][s] = fmaf(dv[s], uv[g], ax[(g >> 1) % kSums][s]);
          ah[(g >> 1) % kSums][s] = fmaf(dv[s], vv[g], ah[(g >> 1) % kSums][s]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long ge = e0 + col + s;
      float sx = ax[0][s], sh = ah[0][s];
      if constexpr (kSums == 2) {
        sx += ax[1][s];
        sh += ah[1][s];
      }
      if (ge < bsz) dx[((size_t)ge * t_steps + t) * hid + j] = sx;
      dhr[s] = sh;
    }
  }
}

}  // namespace repro

// f32 only.  The plan's fields are kernels/lstm.py:BwdPlan's.  wt: the
// unit-major weights [2H][4 (H | 1)] for a wide plan, else unused; dx: [B,
// T, H]; dg: [B T, 4H]; aop: [B T, 2H + 1] (rows past B T untouched);
// scratch: blocks x T x threads x lstm_bwd_kept floats.
extern "C" int repro_lstm_scan_bwd(const void* x, const void* wi, const void* wh, const void* wt,
                                   const void* b, const void* hs, const void* dhs, void* dx,
                                   void* dg, void* aop, void* scratch, long long bsz,
                                   int t_steps, int hid, int tile, int threads, int kind,
                                   void* stream) {
  using namespace repro;
  if (bsz <= 0 || t_steps <= 0) return 0;
  const LstmBwdPlan p{hid, tile, threads, kind};
  if (kind < kBwdNarrow || kind > kBwdWide) return cudaErrorInvalidValue;
  const int seqs = lstm_bwd_seqs(kind);
  if (hid < 1 || hid > kLstmBwdMaxHidden || bsz > INT_MAX || tile < seqs || tile % seqs ||
      threads % 32 || threads > lstm_bwd_max_threads(kind) || threads < tile / seqs * hid ||
      (kind == kBwdWide && !wt) || !scratch)
    return cudaErrorInvalidValue;
  const long long floats = lstm_bwd_smem_floats(p);
  if (floats * 4 > kMaxSmemBytes) return cudaErrorInvalidValue;
  const size_t smem = (size_t)floats * sizeof(float);
  const auto kernel = kind == kBwdNarrow ? lstm_scan_bwd_kernel<kBwdNarrow>
                      : kind == kBwdMid  ? lstm_scan_bwd_kernel<kBwdMid>
                                         : lstm_scan_bwd_kernel<kBwdWide>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(bsz, tile), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wi),
      static_cast<const float*>(wh), static_cast<const float*>(wt),
      static_cast<const float*>(b), static_cast<const float*>(hs),
      static_cast<const float*>(dhs), static_cast<float*>(dx), static_cast<float*>(dg),
      static_cast<float*>(aop), static_cast<float*>(scratch), bsz, t_steps, p);
  return cudaGetLastError();
}
