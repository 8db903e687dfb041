// Weighted bucket-reduction scan: run += B_s; wsum += run, in reverse.
//
// Replaces the TPU kernel panda_tpu/ops/point_pallas.py::weighted_scan.
// One thread per column (batch element x lane) with both accumulators in
// registers; a reverse loop over the S steps replaces the TPU's sequential
// grid axis.  Returns run = sum_s B_s and wsum = sum_s (s + 1) B_s.
//
// Layouts (uint32 words): B coordinates (8, S, N), step-major so a warp's
// loads are coalesced; outputs (8, N).
//
// Bound on the H100: 32-bit multiply throughput (two complete adds per
// step).  Simple, correct first version: one column per thread.

#include "field.cuh"

namespace ptt {

PT_FN void wscan_col(const uint32_t* bx, const uint32_t* by,
                     const uint32_t* bz, uint32_t* rx, uint32_t* ry,
                     uint32_t* rz, uint32_t* wx, uint32_t* wy, uint32_t* wz,
                     int64_t col, int64_t N, int64_t S) {
  xyz run = pt_identity();
  xyz wsum = pt_identity();
  for (int64_t s = S - 1; s >= 0; --s) {
    run = pt_add(run, load_pt(bx, by, bz, s * N + col, S * N));
    wsum = pt_add(wsum, run);
  }
  store_pt(rx, ry, rz, col, N, run);
  store_pt(wx, wy, wz, col, N, wsum);
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    wscan_kernel(const uint32_t* bx, const uint32_t* by, const uint32_t* bz,
                 uint32_t* rx, uint32_t* ry, uint32_t* rz, uint32_t* wx,
                 uint32_t* wy, uint32_t* wz, int64_t N, int64_t S) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col < N) ptt::wscan_col(bx, by, bz, rx, ry, rz, wx, wy, wz, col, N, S);
}

extern "C" int ptt_weighted_scan(const uint32_t* bx, const uint32_t* by,
                                 const uint32_t* bz, uint32_t* rx,
                                 uint32_t* ry, uint32_t* rz, uint32_t* wx,
                                 uint32_t* wy, uint32_t* wz, int64_t N,
                                 int64_t S, void* stream) {
  wscan_kernel<<<PTT_LAUNCH_DIMS(N, kThreads), 0, (cudaStream_t)stream>>>(
      bx, by, bz, rx, ry, rz, wx, wy, wz, N, S);
  return (int)cudaGetLastError();
}

#endif
