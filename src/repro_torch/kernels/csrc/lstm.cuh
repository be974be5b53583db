// Shared by the LSTM scan's compile units: the hidden-width buckets of the
// register body and the launcher that lstm.cu defines once per bucket and
// dtype.
#pragma once

#include "common.cuh"

// The instantiated hidden widths, smallest first: the decode buckets'
// widths, which hold every LSTM width the repo runs.  kernels/lstm.py:
// BUCKETS lists the same (tests/test_torch_kernels.py holds the two
// together), and kernels/_build.py compiles lstm.cu once per bucket and
// dtype, all in parallel.
#define REPRO_LSTM_BUCKETS(X) X(12) X(16) X(20) X(32) X(64)

namespace repro {

template <typename T, int H>
cudaError_t launch_lstm_scan_register(const void* x, const void* wi, const void* wh,
                                      const void* b, void* out, long long bsz, int t_steps,
                                      int hid, bool vec, cudaStream_t stream);

}  // namespace repro
