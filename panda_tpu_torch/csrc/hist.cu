// Per-window histogram of the MSM's bucket digits.
//
// Replaces the TPU kernel panda_tpu/ops/hist_pallas.py::hist_counts, which
// built one-hot int8 matrix products because the TPU has no atomics.
// Input (W, N) uint32 digits, output (W, D) int32 counts of b = 1..D; digit
// 0 and dead keys > D are ignored.  The counts are exact integers, so the
// result equals the TPU kernel's.  The caller zeroes `counts` first.
//
// Design for the H100: each block takes a slice of one window's digits and
// keeps that window's D bins in shared memory (16 KB at D = 4096, 128 KB at
// D = 32768), adds each digit there with one shared atomic, and at the end
// adds its nonzero bins to global memory, one atomic each.  Blocks a
// window: the blocks resident at once (ptt_hist_threads, from the
// occupancy calculator and the SMs) over W, so one wave fills the card,
// and at most N / D, so the flush stays below the digits' own atomics.
//
// Bound on the H100: bytes, the digits read once (64 MiB at 2^20, 16
// windows).  The per-digit add is a plain function, so the host runs a
// block's loop thread by thread (tests/test_torch_csrc.py).

#include "field.cuh"

#if !defined(__CUDACC__)
#include <vector>
#endif

namespace ptt {

// Digits [lo, hi) of a window's N that block g of G takes.
PT_HD void hist_slice(int64_t N, int64_t G, int64_t g, int64_t& lo,
                      int64_t& hi) {
  const int64_t per = (N + G - 1) / G;
  lo = g * per < N ? g * per : N;
  hi = lo + per < N ? lo + per : N;
}

// Digit d into bins[0, D): b = 1..D counts, 0 and dead keys do not.
PT_FN void hist_add(int32_t* bins, uint32_t d, int D) {
  if (d < 1u || d > (uint32_t)D) return;
#if defined(__CUDACC__)
  atomicAdd(&bins[d - 1u], 1);
#else
  bins[d - 1u] += 1;
#endif
}

#if !defined(__CUDACC__)
// Block `blk` of the kernel's W * G on the host: its T threads' loop over
// the slice, `unroll` digits a thread an iteration, then the flush.
inline void hist_block_host(const uint32_t* digits, int32_t* counts,
                            int64_t N, int D, int64_t G, int64_t blk, int T,
                            int unroll) {
  const int64_t w = blk / G;
  std::vector<int32_t> bins(D, 0);
  int64_t lo, hi;
  hist_slice(N, G, blk % G, lo, hi);
  const uint32_t* row = digits + w * N;
  for (int64_t base = lo; base < hi; base += (int64_t)unroll * T)
    for (int u = 0; u < unroll; ++u)
      for (int tid = 0; tid < T; ++tid) {
        const int64_t i = base + (int64_t)u * T + tid;
        hist_add(bins.data(), i < hi ? row[i] : 0u, D);
      }
  for (int i = 0; i < D; ++i) counts[w * D + i] += bins[i];
}
#endif

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;   // digits a thread loads before it bins them

__global__ void __launch_bounds__(kThreads)
    hist_kernel(const uint32_t* digits, int32_t* counts, int64_t N, int D,
                int64_t G) {
  extern __shared__ int32_t bins[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int64_t w = blockIdx.x / G;
  for (int i = tid; i < D; i += T) bins[i] = 0;
  __syncthreads();
  int64_t lo, hi;
  ptt::hist_slice(N, G, blockIdx.x % G, lo, hi);
  const uint32_t* row = digits + w * N;
  for (int64_t base = lo; base < hi; base += (int64_t)kUnroll * T) {
    uint32_t d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)u * T + tid;
      d[u] = i < hi ? __ldg(row + i) : 0u;      // 0 is not counted
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) ptt::hist_add(bins, d[u], D);
  }
  __syncthreads();
  for (int i = tid; i < D; i += T)
    if (bins[i]) atomicAdd(&counts[w * D + i], bins[i]);
}

// `resident`: ptt_hist_threads(D, ...) on this device, which also raised
// the kernel's shared-memory limit to D bins.
extern "C" int ptt_hist_counts(const uint32_t* digits, int32_t* counts,
                               int64_t W, int64_t N, int D, int resident,
                               void* stream) {
  if (W * N == 0) return 0;
  if (resident < kThreads) return (int)cudaErrorInvalidValue;
  int64_t G = resident / kThreads / W;
  if (G > N / D) G = N / D;
  if (G < 1) G = 1;
  hist_kernel<<<(unsigned)(W * G), kThreads, (size_t)D * sizeof(int32_t),
                (cudaStream_t)stream>>>(digits, counts, N, D, G);
  return (int)cudaGetLastError();
}

// Threads of one full wave of the kernel with D bins on the current
// device.
extern "C" int ptt_hist_threads(int D, int* threads) {
  return ptt_resident(hist_kernel, kThreads, (size_t)D * sizeof(int32_t),
                      threads);
}

#endif
