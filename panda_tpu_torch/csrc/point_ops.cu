// Elementwise complete point operations: add, mixed add, double.
//
// Replaces the TPU kernel panda_tpu/ops/point_pallas.py::_run behind
// padd / pmadd / pdbl.  One thread per element; every body comes from
// field.cuh.  Coordinates are limbs-first (8, n) uint32 words.
//
// Bound on the H100: 32-bit integer multiply-add throughput (12 Montgomery
// multiplies per add); the loads and stores are coalesced per word.
// This is the simple, correct first version: no shared memory, no batching
// of several elements per thread.

#include "field.cuh"

namespace ptt {

PT_FN void padd_elem(const uint32_t* px, const uint32_t* py,
                     const uint32_t* pz, const uint32_t* qx,
                     const uint32_t* qy, const uint32_t* qz, uint32_t* rx,
                     uint32_t* ry, uint32_t* rz, int64_t i, int64_t n) {
  const xyz r = pt_add(load_pt(px, py, pz, i, n), load_pt(qx, qy, qz, i, n));
  store_pt(rx, ry, rz, i, n, r);
}

PT_FN void pmadd_elem(const uint32_t* px, const uint32_t* py,
                      const uint32_t* pz, const uint32_t* qx,
                      const uint32_t* qy, uint32_t* rx, uint32_t* ry,
                      uint32_t* rz, int64_t i, int64_t n) {
  const xyz r = pt_madd(load_pt(px, py, pz, i, n), load_fe(qx, i, n),
                        load_fe(qy, i, n));
  store_pt(rx, ry, rz, i, n, r);
}

PT_FN void pdbl_elem(const uint32_t* px, const uint32_t* py,
                     const uint32_t* pz, uint32_t* rx, uint32_t* ry,
                     uint32_t* rz, int64_t i, int64_t n) {
  store_pt(rx, ry, rz, i, n, pt_dbl(load_pt(px, py, pz, i, n)));
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    padd_kernel(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                const uint32_t* qx, const uint32_t* qy, const uint32_t* qz,
                uint32_t* rx, uint32_t* ry, uint32_t* rz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) ptt::padd_elem(px, py, pz, qx, qy, qz, rx, ry, rz, i, n);
}

__global__ void __launch_bounds__(kThreads)
    pmadd_kernel(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                 const uint32_t* qx, const uint32_t* qy, uint32_t* rx,
                 uint32_t* ry, uint32_t* rz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) ptt::pmadd_elem(px, py, pz, qx, qy, rx, ry, rz, i, n);
}

__global__ void __launch_bounds__(kThreads)
    pdbl_kernel(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                uint32_t* rx, uint32_t* ry, uint32_t* rz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) ptt::pdbl_elem(px, py, pz, rx, ry, rz, i, n);
}

extern "C" int ptt_padd(const uint32_t* px, const uint32_t* py,
                        const uint32_t* pz, const uint32_t* qx,
                        const uint32_t* qy, const uint32_t* qz, uint32_t* rx,
                        uint32_t* ry, uint32_t* rz, int64_t n, void* stream) {
  padd_kernel<<<PTT_LAUNCH_DIMS(n, kThreads), 0, (cudaStream_t)stream>>>(
      px, py, pz, qx, qy, qz, rx, ry, rz, n);
  return (int)cudaGetLastError();
}

extern "C" int ptt_pmadd(const uint32_t* px, const uint32_t* py,
                         const uint32_t* pz, const uint32_t* qx,
                         const uint32_t* qy, uint32_t* rx, uint32_t* ry,
                         uint32_t* rz, int64_t n, void* stream) {
  pmadd_kernel<<<PTT_LAUNCH_DIMS(n, kThreads), 0, (cudaStream_t)stream>>>(
      px, py, pz, qx, qy, rx, ry, rz, n);
  return (int)cudaGetLastError();
}

extern "C" int ptt_pdbl(const uint32_t* px, const uint32_t* py,
                        const uint32_t* pz, uint32_t* rx, uint32_t* ry,
                        uint32_t* rz, int64_t n, void* stream) {
  pdbl_kernel<<<PTT_LAUNCH_DIMS(n, kThreads), 0, (cudaStream_t)stream>>>(
      px, py, pz, rx, ry, rz, n);
  return (int)cudaGetLastError();
}

#endif
