// Shared by the fused NTTD decode's compile units: the bucket list and the
// launcher that decode_tile.cu defines once per bucket and dtype.
#pragma once

#include "common.cuh"

// The instantiated (H, R) buckets, smallest first.  kernels/decode_tile.py:
// BUCKETS lists the same (tests/test_torch_kernels.py holds the two
// together), and kernels/_build.py compiles decode_tile.cu once per bucket
// and dtype, all in parallel.
#define REPRO_DECODE_BUCKETS(X) X(12, 8) X(16, 8) X(20, 12) X(32, 16) X(64, 32)

namespace repro {

template <typename T, int H, int R>
cudaError_t launch_decode_tile(const void* idx, const void* emb, const void* wi,
                               const void* wh, const void* b, const void* wf,
                               const void* bf, const void* wm, const void* bm,
                               const void* wl, const void* bl, void* out, long long bsz,
                               int t_steps, int m_rows, cudaStream_t stream);

}  // namespace repro
