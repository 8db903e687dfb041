// Elementwise Montgomery multiply over an NTT's scalar field (BN254 Fr,
// BLS12-377 Fr or BLS12-381 Fr), with an optional final conditional
// subtraction of p.
//
// Replaces the TPU kernel panda_tpu/ops/point_pallas.py::fmul.  On the NTT
// path it multiplies each four-step level's DFT output (< 2p) by the
// inter-level twiddle table (canonical, < p), builds the T1 tables of the
// four-step and radix-2 engines, and makes the stagewise engine's twiddle
// products and its inverse's n^-1 scale.  One thread per element: a CIOS
// product from field.cuh (output < 2p for a, b < 2p; for BLS12-381 Fr, a
// canon field, a < p and any b < 2^256 give < p) and, with canonical_out,
// one cond_sub_p to [0, p).  Words are limbs-first (8, n), so a warp reads
// 32 consecutive words of each limb.
//
// Bound on the H100: memory traffic (96 bytes per element: two operands in,
// one result out) against 264 32-bit multiply-adds per element; at 2^20
// elements the bytes take ~30 us and the multiply-adds ~17 us at the H100
// SXM's peak rates (data sheet and Hopper white paper, 700 W limit), so the
// kernel is bound by bytes.  Simple, correct first version.

#include "field.cuh"

namespace ptt {

template <class F>
PT_FN void fmul_elem(const uint32_t* a, const uint32_t* b, uint32_t* out,
                     int64_t i, int64_t n, int canonical_out) {
  fe r = mont_mul<F>(load_fe(a, i, n), load_fe(b, i, n));
  if (canonical_out) r = cond_sub_p<F>(r);
  store_fe(out, i, n, r);
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 128;

template <class F>
__global__ void __launch_bounds__(kThreads)
    fmul_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out,
                int64_t n, int canonical_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) ptt::fmul_elem<F>(a, b, out, i, n, canonical_out);
}

template <class F>
int fmul_launch(const uint32_t* a, const uint32_t* b, uint32_t* out,
                int64_t n, int canonical_out, cudaStream_t stream) {
  fmul_kernel<F><<<PTT_LAUNCH_DIMS(n, kThreads), 0, stream>>>(
      a, b, out, n, canonical_out);
  return (int)cudaGetLastError();
}

extern "C" int ptt_fmul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                        int64_t n, int canonical_out, int field,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return fmul_launch<ptt::Fr254>(a, b, out, n, canonical_out, s);
    case 1: return fmul_launch<ptt::Fr377>(a, b, out, n, canonical_out, s);
    case 2: return fmul_launch<ptt::Fr381>(a, b, out, n, canonical_out, s);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
