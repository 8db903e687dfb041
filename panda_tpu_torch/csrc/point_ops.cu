// Elementwise complete point operations: add, mixed add, double.
//
// Replaces the TPU kernel panda_tpu/ops/point_pallas.py::_run behind
// padd / pmadd / pdbl.  One thread per element; every body comes from
// field.cuh.  Coordinates are limbs-first (L, n) uint32 words, L = 8 for
// BN254 and 12 for the BLS curves; each launcher takes a curve id, the
// curve's index in _ext.MSM_CURVES.
//
// Bound on the H100: 32-bit integer multiply-add throughput (12 Montgomery
// multiplies per add, 264 multiply-adds each at 8 words, 588 at 12); the
// loads and stores are coalesced per word.  This is the simple, correct
// first version: no shared memory, no batching of several elements per
// thread.

#include "field.cuh"

namespace ptt {

template <class C>
PT_FN void padd_elem(const uint32_t* px, const uint32_t* py,
                     const uint32_t* pz, const uint32_t* qx,
                     const uint32_t* qy, const uint32_t* qz, uint32_t* rx,
                     uint32_t* ry, uint32_t* rz, int64_t i, int64_t n) {
  constexpr int N = C::Fp::N;
  const auto r = pt_add<C>(load_pt<N>(px, py, pz, i, n),
                           load_pt<N>(qx, qy, qz, i, n));
  store_pt(rx, ry, rz, i, n, r);
}

template <class C>
PT_FN void pmadd_elem(const uint32_t* px, const uint32_t* py,
                      const uint32_t* pz, const uint32_t* qx,
                      const uint32_t* qy, uint32_t* rx, uint32_t* ry,
                      uint32_t* rz, int64_t i, int64_t n) {
  constexpr int N = C::Fp::N;
  const auto r = pt_madd<C>(load_pt<N>(px, py, pz, i, n),
                            load_fe<N>(qx, i, n), load_fe<N>(qy, i, n));
  store_pt(rx, ry, rz, i, n, r);
}

template <class C>
PT_FN void pdbl_elem(const uint32_t* px, const uint32_t* py,
                     const uint32_t* pz, uint32_t* rx, uint32_t* ry,
                     uint32_t* rz, int64_t i, int64_t n) {
  constexpr int N = C::Fp::N;
  store_pt(rx, ry, rz, i, n, pt_dbl<C>(load_pt<N>(px, py, pz, i, n)));
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 128;

template <class C>
__global__ void __launch_bounds__(kThreads)
    padd_kernel(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                const uint32_t* qx, const uint32_t* qy, const uint32_t* qz,
                uint32_t* rx, uint32_t* ry, uint32_t* rz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) ptt::padd_elem<C>(px, py, pz, qx, qy, qz, rx, ry, rz, i, n);
}

template <class C>
__global__ void __launch_bounds__(kThreads)
    pmadd_kernel(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                 const uint32_t* qx, const uint32_t* qy, uint32_t* rx,
                 uint32_t* ry, uint32_t* rz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) ptt::pmadd_elem<C>(px, py, pz, qx, qy, rx, ry, rz, i, n);
}

template <class C>
__global__ void __launch_bounds__(kThreads)
    pdbl_kernel(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                uint32_t* rx, uint32_t* ry, uint32_t* rz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) ptt::pdbl_elem<C>(px, py, pz, rx, ry, rz, i, n);
}

template <class C>
int padd_launch(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                const uint32_t* qx, const uint32_t* qy, const uint32_t* qz,
                uint32_t* rx, uint32_t* ry, uint32_t* rz, int64_t n,
                cudaStream_t stream) {
  padd_kernel<C><<<PTT_LAUNCH_DIMS(n, kThreads), 0, stream>>>(
      px, py, pz, qx, qy, qz, rx, ry, rz, n);
  return (int)cudaGetLastError();
}

template <class C>
int pmadd_launch(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                 const uint32_t* qx, const uint32_t* qy, uint32_t* rx,
                 uint32_t* ry, uint32_t* rz, int64_t n, cudaStream_t stream) {
  pmadd_kernel<C><<<PTT_LAUNCH_DIMS(n, kThreads), 0, stream>>>(
      px, py, pz, qx, qy, rx, ry, rz, n);
  return (int)cudaGetLastError();
}

template <class C>
int pdbl_launch(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                uint32_t* rx, uint32_t* ry, uint32_t* rz, int64_t n,
                cudaStream_t stream) {
  pdbl_kernel<C><<<PTT_LAUNCH_DIMS(n, kThreads), 0, stream>>>(
      px, py, pz, rx, ry, rz, n);
  return (int)cudaGetLastError();
}

extern "C" int ptt_padd(const uint32_t* px, const uint32_t* py,
                        const uint32_t* pz, const uint32_t* qx,
                        const uint32_t* qy, const uint32_t* qz, uint32_t* rx,
                        uint32_t* ry, uint32_t* rz, int64_t n, int curve,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (curve) {
    case 0: return padd_launch<ptt::Bn254>(px, py, pz, qx, qy, qz, rx, ry, rz,
                                           n, s);
    case 1: return padd_launch<ptt::Bls12_377>(px, py, pz, qx, qy, qz, rx, ry,
                                               rz, n, s);
    case 2: return padd_launch<ptt::Bls12_381>(px, py, pz, qx, qy, qz, rx, ry,
                                               rz, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int ptt_pmadd(const uint32_t* px, const uint32_t* py,
                         const uint32_t* pz, const uint32_t* qx,
                         const uint32_t* qy, uint32_t* rx, uint32_t* ry,
                         uint32_t* rz, int64_t n, int curve, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (curve) {
    case 0: return pmadd_launch<ptt::Bn254>(px, py, pz, qx, qy, rx, ry, rz, n,
                                            s);
    case 1: return pmadd_launch<ptt::Bls12_377>(px, py, pz, qx, qy, rx, ry,
                                                rz, n, s);
    case 2: return pmadd_launch<ptt::Bls12_381>(px, py, pz, qx, qy, rx, ry,
                                                rz, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int ptt_pdbl(const uint32_t* px, const uint32_t* py,
                        const uint32_t* pz, uint32_t* rx, uint32_t* ry,
                        uint32_t* rz, int64_t n, int curve, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (curve) {
    case 0: return pdbl_launch<ptt::Bn254>(px, py, pz, rx, ry, rz, n, s);
    case 1: return pdbl_launch<ptt::Bls12_377>(px, py, pz, rx, ry, rz, n, s);
    case 2: return pdbl_launch<ptt::Bls12_381>(px, py, pz, rx, ry, rz, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
