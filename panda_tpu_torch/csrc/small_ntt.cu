// Batched radix-2 NTT of length K = 2^log_k (2 <= K <= 256) along axis 1 of
// (8, K, nb) words, natural order in and out, over BN254 Fr or BLS12-377 Fr
// (a template parameter; the launcher takes a field id).
//
// Replaces the TPU kernel panda_tpu/ops/ntt_pallas.py::small_ntt_batch (the
// radix-2 engine's pass, PANDA_NTT_IMPL=pallas).  For each column c:
//
//   load:   v_j = x[j, c], brought to [0, p) first with reduce_in (any word
//           below 2^256 is a valid input), then times pre[j, c / batch] when
//           a pre-twiddle table (8, K, B) is given (nb = B * batch: the
//           four-step inter-level twiddle w^(j1 k2), fused at load); the
//           value goes to slot bitrev(j) of the column's shared-memory copy,
//           so the bit reversal costs no pass of its own and the table is
//           read in natural order;
//   stages: log_k decimation-in-time stages; stage s pairs slots j and
//           j + 2^s and multiplies the second by the stage twiddle
//           tw[2^s - 1 + t] (stage_twiddle_rows' (8, K) layout), t = j mod
//           2^s; stage 0's twiddle is 1 and is skipped;
//   store:  out[k, c] in natural order, times the scale (the inverse's
//           n^-1) when one is given, canonical with canonical_out.
//
// Every value stays in [0, 2p): mont_mul of values < 2p is < 2p and
// add_mod / sub_mod end with one conditional 2p, so the JAX kernel's lazy
// bounds and its closing multiply by ONE have no counterpart here.
//
// Design: a block holds a tile of TC columns (TC = min(32, 2048 / K)), all K
// elements of each in shared memory, laid out [word][j][column] (32 K TC
// bytes: 64 KB for K >= 64, so the launcher raises the dynamic shared
// memory limit).  Neighbouring threads take neighbouring columns, so the
// global loads and stores of each word are coalesced along nb and the
// shared-memory accesses of a warp fall in distinct banks (two-way at the
// first two stages when TC = 8).  256 threads loop over the tile's K TC
// loads, K TC / 2 butterflies per stage with __syncthreads() between stages,
// and K TC stores.
//
// Bound on the H100: the (log_k - 1) K / 2 twiddle products per column, plus
// K for the pre-twiddle and K for the scale when given, at 264 32-bit
// multiply-adds each (CIOS), against 64 bytes per element in and out plus
// the pre table: at K = 256, nb = 2^12 with a pre table, ~0.075 ms of
// multiply-adds against ~0.029 ms of bytes (16.7 T/s and 3.35 TB/s, H100
// SXM, 700 W), so operations bound it.  Simple, correct first version.

#include "field.cuh"

namespace ptt {

PT_FN int bitrev(int j, int log_k) {
#if defined(__CUDACC__)
  return (int)(__brev((unsigned)j) >> (32 - log_k));
#else
  int r = 0;
  for (int b = 0; b < log_k; ++b) r |= ((j >> b) & 1) << (log_k - 1 - b);
  return r;
#endif
}

// Element j of column c, ready for the stages: reduced (reduce_in) and
// times the pre-twiddle of (j, c / batch) when pre is given.  x is (8, K,
// nb), pre (8, K, pre_cols).
template <class F>
PT_FN fe small_ntt_load(const uint32_t* x, const uint32_t* pre, int64_t nb,
                        int K, int j, int64_t c, int64_t pre_cols,
                        int64_t batch, int reduce_in) {
  fe v = load_fe(x + (int64_t)j * nb, c, (int64_t)K * nb);
  if (reduce_in) v = reduce_wide<F>(v);
  if (pre)
    v = mont_mul<F>(v, load_fe(pre + (int64_t)j * pre_cols, c / batch,
                               (int64_t)K * pre_cols));
  return v;
}

// Butterfly p (0 <= p < K / 2) of stage s on one column whose slot j has
// word w at col[w wstride + j jstride]; tw is the (8, K) stage twiddle rows.
template <class F>
PT_FN void small_ntt_butterfly(uint32_t* col, int64_t wstride, int jstride,
                               const uint32_t* tw, int K, int s, int p) {
  const int m = 1 << s;
  const int t = p & (m - 1);
  const int j = ((p >> s) << (s + 1)) + t;
  const fe u = load_fe(col + j * jstride, 0, wstride);
  fe v = load_fe(col + (j + m) * jstride, 0, wstride);
  if (s) v = mont_mul<F>(v, load_fe(tw + (m - 1 + t), 0, K));
  store_fe(col + j * jstride, 0, wstride, add_mod<F>(u, v));
  store_fe(col + (j + m) * jstride, 0, wstride, sub_mod<F>(u, v));
}

// Output k of column c: times the scale (8 words) when given, canonical with
// canonical_out.
template <class F>
PT_FN void small_ntt_store(uint32_t* out, int64_t nb, int K, int k,
                           int64_t c, fe v, const uint32_t* scale,
                           int canonical_out) {
  if (scale) v = mont_mul<F>(v, load_fe(scale, 0, 1));
  if (canonical_out) v = cond_sub_p<F>(v);
  store_fe(out + (int64_t)k * nb, c, (int64_t)K * nb, v);
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 256;
constexpr int kTileElems = 2048;   // K * TC: 64 KB of shared memory

template <class F>
__global__ void __launch_bounds__(kThreads)
    small_ntt_kernel(const uint32_t* x, const uint32_t* tw,
                     const uint32_t* pre, const uint32_t* scale,
                     uint32_t* out, int64_t nb, int log_k, int log_tc,
                     int64_t pre_cols, int64_t batch, int reduce_in,
                     int canonical_out) {
  extern __shared__ uint32_t tile[];   // [w][j][tc]: word w of slot j
  const int K = 1 << log_k, TC = 1 << log_tc;
  const int64_t c0 = (int64_t)blockIdx.x * TC;
  const int64_t wstride = (int64_t)K * TC;
  for (int e = threadIdx.x; e < K * TC; e += blockDim.x) {
    const int tc = e & (TC - 1), j = e >> log_tc;
    const int64_t c = c0 + tc;
    const ptt::fe v = c < nb ? ptt::small_ntt_load<F>(x, pre, nb, K, j, c,
                                                      pre_cols, batch,
                                                      reduce_in)
                             : ptt::fe_zero();
    ptt::store_fe(tile + ptt::bitrev(j, log_k) * TC, tc, wstride, v);
  }
  __syncthreads();
  for (int s = 0; s < log_k; ++s) {
    for (int q = threadIdx.x; q < (K / 2) * TC; q += blockDim.x)
      ptt::small_ntt_butterfly<F>(tile + (q & (TC - 1)), wstride, TC, tw, K,
                                  s, q >> log_tc);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < K * TC; e += blockDim.x) {
    const int tc = e & (TC - 1), k = e >> log_tc;
    const int64_t c = c0 + tc;
    if (c < nb)
      ptt::small_ntt_store<F>(out, nb, K, k, c,
                              ptt::load_fe(tile + k * TC, tc, wstride),
                              scale, canonical_out);
  }
}

template <class F>
int small_ntt_launch(const uint32_t* x, const uint32_t* tw,
                     const uint32_t* pre, const uint32_t* scale,
                     uint32_t* out, int64_t nb, int log_k, int64_t pre_cols,
                     int reduce_in, int canonical_out, cudaStream_t stream) {
  if (log_k < 1 || log_k > 8) return (int)cudaErrorInvalidValue;
  int log_tc = 5;
  while ((1 << (log_k + log_tc)) > kTileElems) --log_tc;
  const size_t smem = (size_t)8 * sizeof(uint32_t) << (log_k + log_tc);
  const cudaError_t e = cudaFuncSetAttribute(
      small_ntt_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (nb + (1 << log_tc) - 1) >> log_tc;
  const int64_t batch = pre ? nb / pre_cols : 1;
  small_ntt_kernel<F><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, tw, pre, scale, out, nb, log_k, log_tc, pre_cols, batch, reduce_in,
      canonical_out);
  return (int)cudaGetLastError();
}

extern "C" int ptt_small_ntt(const uint32_t* x, const uint32_t* tw,
                             const uint32_t* pre, const uint32_t* scale,
                             uint32_t* out, int64_t nb, int log_k,
                             int64_t pre_cols, int reduce_in,
                             int canonical_out, int field, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0:
      return small_ntt_launch<ptt::Fr254>(x, tw, pre, scale, out, nb, log_k,
                                          pre_cols, reduce_in, canonical_out,
                                          s);
    case 1:
      return small_ntt_launch<ptt::Fr377>(x, tw, pre, scale, out, nb, log_k,
                                          pre_cols, reduce_in, canonical_out,
                                          s);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
