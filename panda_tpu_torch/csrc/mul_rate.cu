// The rate of field.cuh's Montgomery multiplies on the card: a measurement
// kernel, on no path of the system (tools/mul_rate.py runs it).
//
// Each thread runs `iters` dependent steps of x_i = mul(x_i, y) on ILP = 2
// independent chains, from values made from its index (below 2^252, so
// below the 8-word fields' p), with mont_mul (wide = 0) or mont_mul_wide
// (wide = 1), and stores the chains' final words, so the two variants'
// outputs must be equal word for word.  Bound on the H100: 32-bit
// multiply-adds, 264 a product (CIOS over 8 words), 16.7 T/s.

#include "field.cuh"

namespace ptt {

constexpr int kMulRateIlp = 2;

template <class F, int Wide>
PT_FN void mul_rate_thread(uint32_t* out, uint32_t tid, int64_t n,
                           int iters) {
  fe x[kMulRateIlp], y;
#pragma unroll
  for (int j = 0; j < 8; ++j) y.w[j] = (tid * 2654435761u + j) & 0x0fffffffu;
#pragma unroll
  for (int i = 0; i < kMulRateIlp; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[i].w[j] = (tid + 77u * i + 13u * j) & 0x0fffffffu;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < kMulRateIlp; ++i)
      x[i] = Wide ? mont_mul_wide<F>(x[i], y) : mont_mul<F>(x[i], y);
#pragma unroll
  for (int i = 0; i < kMulRateIlp; ++i) store_fe(out + 8 * i * n, tid, n, x[i]);
}

}  // namespace ptt

#if defined(__CUDACC__)

template <class F, int Wide>
__global__ void mul_rate_kernel(uint32_t* out, int64_t n, int iters) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  ptt::mul_rate_thread<F, Wide>(out, tid, n, iters);
}

template <class F>
int mul_rate_launch(uint32_t* out, int blocks, int threads, int iters,
                    int wide, cudaStream_t s) {
  const int64_t n = (int64_t)blocks * threads;
  if (wide)
    mul_rate_kernel<F, 1><<<blocks, threads, 0, s>>>(out, n, iters);
  else
    mul_rate_kernel<F, 0><<<blocks, threads, 0, s>>>(out, n, iters);
  return (int)cudaGetLastError();
}

// out: (2, 8, blocks * threads) words, the chains' final values.
extern "C" int ptt_mul_rate(uint32_t* out, int blocks, int threads,
                            int iters, int field, int wide, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return mul_rate_launch<ptt::Fr254>(out, blocks, threads, iters,
                                               wide, s);
    case 1: return mul_rate_launch<ptt::Fr377>(out, blocks, threads, iters,
                                               wide, s);
    case 2: return mul_rate_launch<ptt::Fr381>(out, blocks, threads, iters,
                                               wide, s);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
