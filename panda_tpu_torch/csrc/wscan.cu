// Weighted bucket-reduction scan: run += B_s; wsum += run, in reverse.
//
// Replaces the TPU kernel panda_tpu/ops/point_pallas.py::weighted_scan.
// One thread per column (batch element x lane) with both accumulators in
// registers; a reverse loop over the S steps replaces the TPU's sequential
// grid axis.  Returns run = sum_s B_s and wsum = sum_s (s + 1) B_s.  The
// launcher takes a curve id, the curve's index in _ext.MSM_CURVES.
//
// Layouts (uint32 words, L = 8 for BN254 and 12 for the BLS curves): B
// coordinates (L, S, N), step-major so a warp's loads are coalesced;
// outputs (L, N).
//
// Bound on the H100: 32-bit multiply throughput (two complete adds per
// step).  Simple, correct first version: one column per thread.

#include "field.cuh"

namespace ptt {

template <class C>
PT_FN void wscan_col(const uint32_t* bx, const uint32_t* by,
                     const uint32_t* bz, uint32_t* rx, uint32_t* ry,
                     uint32_t* rz, uint32_t* wx, uint32_t* wy, uint32_t* wz,
                     int64_t col, int64_t N, int64_t S) {
  auto run = pt_identity<C>();
  auto wsum = pt_identity<C>();
  for (int64_t s = S - 1; s >= 0; --s) {
    run = pt_add<C>(run, load_pt<C::Fp::N>(bx, by, bz, s * N + col, S * N));
    wsum = pt_add<C>(wsum, run);
  }
  store_pt(rx, ry, rz, col, N, run);
  store_pt(wx, wy, wz, col, N, wsum);
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 128;

template <class C>
__global__ void __launch_bounds__(kThreads)
    wscan_kernel(const uint32_t* bx, const uint32_t* by, const uint32_t* bz,
                 uint32_t* rx, uint32_t* ry, uint32_t* rz, uint32_t* wx,
                 uint32_t* wy, uint32_t* wz, int64_t N, int64_t S) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col < N)
    ptt::wscan_col<C>(bx, by, bz, rx, ry, rz, wx, wy, wz, col, N, S);
}

template <class C>
int wscan_launch(const uint32_t* bx, const uint32_t* by, const uint32_t* bz,
                 uint32_t* rx, uint32_t* ry, uint32_t* rz, uint32_t* wx,
                 uint32_t* wy, uint32_t* wz, int64_t N, int64_t S,
                 cudaStream_t stream) {
  wscan_kernel<C><<<PTT_LAUNCH_DIMS(N, kThreads), 0, stream>>>(
      bx, by, bz, rx, ry, rz, wx, wy, wz, N, S);
  return (int)cudaGetLastError();
}

extern "C" int ptt_weighted_scan(const uint32_t* bx, const uint32_t* by,
                                 const uint32_t* bz, uint32_t* rx,
                                 uint32_t* ry, uint32_t* rz, uint32_t* wx,
                                 uint32_t* wy, uint32_t* wz, int64_t N,
                                 int64_t S, int curve, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (curve) {
    case 0: return wscan_launch<ptt::Bn254>(bx, by, bz, rx, ry, rz, wx, wy,
                                            wz, N, S, s);
    case 1: return wscan_launch<ptt::Bls12_377>(bx, by, bz, rx, ry, rz, wx,
                                                wy, wz, N, S, s);
    case 2: return wscan_launch<ptt::Bls12_381>(bx, by, bz, rx, ry, rz, wx,
                                                wy, wz, N, S, s);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
