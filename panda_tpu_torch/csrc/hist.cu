// Per-window histogram of the MSM's bucket digits.
//
// Replaces the TPU kernel panda_tpu/ops/hist_pallas.py::hist_counts, which
// built one-hot int8 matrix products because the TPU has no atomics.  Here
// each thread takes one digit and increments counts[w, d - 1] with a global
// atomicAdd when 1 <= d <= D; digit 0 and dead keys > D are ignored.  The
// counts are exact integers, so the result equals the TPU kernel's.  The
// caller zeroes `counts` (W, D) first.
//
// Bound on the H100: atomic throughput to L2 under contention on popular
// buckets.  Simple, correct first version: no shared-memory privatisation.

#include "field.cuh"

namespace ptt {

PT_FN void hist_elem(const uint32_t* digits, int32_t* counts, int64_t i,
                     int64_t N, int D) {
  const int64_t w = i / N;
  const uint32_t d = digits[i];
  if (d >= 1u && d <= (uint32_t)D) atomic_inc(&counts[w * D + (d - 1u)]);
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    hist_kernel(const uint32_t* digits, int32_t* counts, int64_t total,
                int64_t N, int D) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) ptt::hist_elem(digits, counts, i, N, D);
}

extern "C" int ptt_hist_counts(const uint32_t* digits, int32_t* counts,
                               int64_t W, int64_t N, int D, void* stream) {
  const int64_t total = W * N;
  hist_kernel<<<PTT_LAUNCH_DIMS(total, kThreads), 0, (cudaStream_t)stream>>>(
      digits, counts, total, N, D);
  return (int)cudaGetLastError();
}

#endif
