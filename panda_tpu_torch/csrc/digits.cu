// Scalar preparation for the MSM: out of Montgomery form, canonical, then the
// W-window signed-digit recode.
//
// Replaces the TPU kernel panda_tpu/ops/digits_pallas.py::signed_digits.
// Built for the scalar fields of the three curves (Fr254, Fr377, Fr381; the
// launcher's field id is its index in _ext.MSM_FIELDS), all 8 words.
// One thread per scalar: a CIOS multiply by the plain integer 1 (any input
// below 2^256 comes out <= r, BLS12-381's r included), one conditional
// subtraction of r, then the recode.  W and the top window's headroom come
// from the caller (msm.signed_window_count(fr.bits, c)).  Outputs mags (W, n) in [0, 2^(c-1)] and negs (W, n) in {0, 1},
// equal to panda_tpu/ops/msm.py::extract_signed_digits.
//
// Bound on the H100: memory traffic (32 bytes in, 5 W bytes out per scalar)
// next to one Montgomery multiply.  Simple, correct first version: the
// scalar's words sit in a local array indexed per window.

#include "field.cuh"

namespace ptt {

template <class F>
PT_FN void digits_elem(const uint32_t* scalars, uint32_t* mags, uint8_t* negs,
                       int64_t j, int64_t n, int c, int W) {
  constexpr int N = F::N;
  fe_t<N> one = fe_zero<N>();
  one.w[0] = 1;
  const fe_t<N> s =
      cond_sub_p<F>(mont_mul<F>(load_fe<N>(scalars, j, n), one));
  const uint32_t mask = (1u << c) - 1u;
  const uint32_t half = 1u << (c - 1);
  const uint32_t full = 1u << c;
  uint32_t carry = 0;
  for (int w = 0; w < W; ++w) {
    const int lo = w * c;
    const int i = lo >> 5, sh = lo & 31;
    uint32_t d = 0;
    if (i < N) {
      d = s.w[i] >> sh;
      if (sh + c > 32 && i + 1 < N) d |= s.w[i + 1] << (32 - sh);
    }
    const uint32_t e = (d & mask) + carry;
    const bool neg = e > half;
    mags[(int64_t)w * n + j] = neg ? full - e : e;
    negs[(int64_t)w * n + j] = neg ? 1 : 0;
    carry = neg ? 1u : 0u;
  }
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 128;

template <class F>
__global__ void __launch_bounds__(kThreads)
    digits_kernel(const uint32_t* scalars, uint32_t* mags, uint8_t* negs,
                  int64_t n, int c, int W) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) ptt::digits_elem<F>(scalars, mags, negs, j, n, c, W);
}

template <class F>
int digits_launch(const uint32_t* scalars, uint32_t* mags, uint8_t* negs,
                  int64_t n, int c, int W, cudaStream_t stream) {
  digits_kernel<F><<<PTT_LAUNCH_DIMS(n, kThreads), 0, stream>>>(
      scalars, mags, negs, n, c, W);
  return (int)cudaGetLastError();
}

extern "C" int ptt_signed_digits(const uint32_t* scalars, uint32_t* mags,
                                 uint8_t* negs, int64_t n, int c, int W,
                                 int field, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return digits_launch<ptt::Fr254>(scalars, mags, negs, n, c, W, s);
    case 1: return digits_launch<ptt::Fr377>(scalars, mags, negs, n, c, W, s);
    case 2: return digits_launch<ptt::Fr381>(scalars, mags, negs, n, c, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
