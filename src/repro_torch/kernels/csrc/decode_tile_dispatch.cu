// C entry point of the fused NTTD decode: picks the launcher of the (H, R)
// bucket and dtype, each built from decode_tile.cu in a compile unit of its
// own (kernels/_build.py).  The wrapper, kernels/decode_tile.py, pads any
// other shape a bucket holds to that bucket before it calls; shapes above
// the largest bucket run decode_tile_simt.cu's body instead.
#include <climits>

#include "decode_tile.cuh"

namespace repro {

template <typename T>
cudaError_t dispatch_bucket(const void* idx, const void* emb, const void* wi, const void* wh,
                            const void* b, const void* wf, const void* bf, const void* wm,
                            const void* bm, const void* wl, const void* bl, void* out,
                            long long bsz, int t_steps, int m_rows, int hid, int rank,
                            cudaStream_t s) {
#define REPRO_DECODE_BUCKET(HH, RR_)                                                         \
  if (hid == HH && rank == RR_)                                                              \
    return launch_decode_tile<T, HH, RR_>(idx, emb, wi, wh, b, wf, bf, wm, bm, wl, bl, out, \
                                          bsz, t_steps, m_rows, s);
  REPRO_DECODE_BUCKETS(REPRO_DECODE_BUCKET)
#undef REPRO_DECODE_BUCKET
  return cudaErrorInvalidValue;
}

}  // namespace repro

extern "C" int repro_decode_tile(const void* idx, const void* emb, const void* wi,
                                 const void* wh, const void* b, const void* wf,
                                 const void* bf, const void* wm, const void* bm,
                                 const void* wl, const void* bl, void* out, long long bsz,
                                 int t_steps, int m_rows, int hid, int rank, int dtype,
                                 void* stream) {
  if (bsz <= 0) return 0;
  if (bsz > INT_MAX) return cudaErrorInvalidValue;  // entries are indexed with int
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32)
    return repro::dispatch_bucket<float>(idx, emb, wi, wh, b, wf, bf, wm, bm, wl, bl, out, bsz,
                                         t_steps, m_rows, hid, rank, s);
  if (dtype == repro::kDtypeBF16)
    return repro::dispatch_bucket<__nv_bfloat16>(idx, emb, wi, wh, b, wf, bf, wm, bm, wl, bl,
                                                 out, bsz, t_steps, m_rows, hid, rank, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
