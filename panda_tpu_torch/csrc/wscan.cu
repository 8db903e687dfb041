// The weighted bucket reduction sum_{d=1..D} d B_d of each window, on the
// device: one launch a level, two levels for the MSM's tables.
//
// Replaces the TPU kernel panda_tpu/ops/point_pallas.py::weighted_scan and
// the lane combine around it (panda_tpu/ops/reduce.py::weighted_window_sum,
// whose suffix scans and doublings ran as ~35 point-op launches in the
// port).  The launcher takes a curve id, the curve's index in
// _ext.MSM_CURVES.
//
// The algebra.  A level takes, for each of W windows, E elements x_e and
// (above level 0) E plain terms p_e, and stands for
//     sum_e p_e + sum_e (e + base) x_e,
// with base = 1 at level 0 (x = the buckets, e = d - 1, no p) and 0 above.
// Thread r of block b owns segment i = b T + r, the elements
// e = i seg + j (j < seg, e < E; the rest count as the identity), and
// scans them in reverse: run_r = sum_j x_e, acc_r = sum_j (j + base) x_e
// + sum_j p_e.
// Then sum_r (bT + r) seg run_r splits into bT seg sum_r run_r and
// seg sum_r r run_r = seg sum_{r >= 1} S_r with S_r = sum_{r' >= r} run_r'.
// The block computes S by a Hillis-Steele suffix scan in shared memory
// (log2 T rounds), adds v_r = acc_r + [r >= 1] seg S_r (log2 seg doublings)
// by a tree, and writes
//     P_b = sum_r v_r,   X_b = (T seg) S_0,
// so the level equals sum_b P_b + sum_b b X_b: the next level's p and x
// (base 0).  A level with one block a window writes P_b alone, the window
// sum.  ops/reduce.py picks seg and T (powers of two) so that level 0 runs
// at least 2^16 threads where the tables allow it and level 1 is the last.
//
// Layouts (uint32 words, L = 8 for BN254 and 12 for the BLS curves): x, p
// (L, W, E); P, X (L, W, NB) with NB = ceil(ceil(E / seg) / T) blocks a
// window.
//
// Bound on the H100: 32-bit multiply throughput, two complete adds a
// bucket (12 CIOS multiplies each).  The combine adds about log2 T adds and
// log2 seg doublings a segment; level 0's threads each run 2 seg adds
// before it.  The per-thread bodies are plain functions, so the host runs
// a block phase by phase (tests/test_torch_csrc.py).

#include "field.cuh"

#if !defined(__CUDACC__)
#include <vector>
#endif

namespace ptt {

// Segment i of window w: (run, acc) as above, as suffix sums: with
// S_j = sum_{j' >= j} x_e, acc = sum_{k >= 1 - base} S_k + sum_j p_e.  A
// step's two adds (acc += S_{j+1} and S_j = S_{j+1} + x_j) are independent,
// so they can overlap; the first element present sets run without an add.
template <class C>
PT_FN void wscan_segment(cpts x, cpts p, int64_t W, int64_t E, int64_t w,
                         int64_t i, int seg, int base, xyz_t<C::Fp::N>& run,
                         xyz_t<C::Fp::N>& acc) {
  constexpr int N = C::Fp::N;
  run = pt_identity<C>();
  acc = pt_identity<C>();
  bool have_run = false;
  for (int j = seg - 1; j >= 0; --j) {
    const int64_t e = i * seg + j;
    if (e >= E) continue;
    const int64_t at = w * E + e;
    const xyz_t<N> xe = load_pt<N>(x.x, x.y, x.z, at, W * E);
    if (p.x) acc = pt_add<C>(acc, load_pt<N>(p.x, p.y, p.z, at, W * E));
    if (have_run) {
      acc = pt_add<C>(acc, run);
      run = pt_add<C>(run, xe);
    } else {
      run = xe;
      have_run = true;
    }
  }
  if (base) acc = pt_add<C>(acc, run);
}

// One suffix-scan round over T points in shared memory (word-major, stride
// T): out[r] = in[r] + in[r + k], or in[r] past the end.
template <class C>
PT_FN void wscan_suffix_step(const uint32_t* in, uint32_t* out, int r, int k,
                             int T) {
  constexpr int N = C::Fp::N;
  const int64_t s = (int64_t)N * T;
  xyz_t<N> v = load_pt<N>(in, in + s, in + 2 * s, r, T);
  if (r + k < T)
    v = pt_add<C>(v, load_pt<N>(in, in + s, in + 2 * s, r + k, T));
  store_pt(out, out + s, out + 2 * s, r, T, v);
}

// v_r = acc_r + [r >= 1] 2^log_seg S_r.
template <class C>
PT_FN xyz_t<C::Fp::N> wscan_term(const xyz_t<C::Fp::N>& acc,
                                 xyz_t<C::Fp::N> S, int r, int log_seg) {
  if (r == 0) return acc;
  for (int i = 0; i < log_seg; ++i) S = pt_dbl<C>(S);
  return pt_add<C>(acc, S);
}

// One tree round: buf[r] += buf[r + s] for r < s.
template <class C>
PT_FN void wscan_tree_step(uint32_t* buf, int r, int s, int T) {
  constexpr int N = C::Fp::N;
  const int64_t st = (int64_t)N * T;
  const xyz_t<N> a = load_pt<N>(buf, buf + st, buf + 2 * st, r, T);
  const xyz_t<N> b = load_pt<N>(buf, buf + st, buf + 2 * st, r + s, T);
  store_pt(buf, buf + st, buf + 2 * st, r, T, pt_add<C>(a, b));
}

// Thread 0's stores: P_b = buf[0]; X_b = 2^log_scale S_0 unless X is null.
template <class C>
PT_FN void wscan_block_out(const uint32_t* buf, xyz_t<C::Fp::N> S0, mpts P,
                           mpts X, int64_t at, int64_t stride, int T,
                           int log_scale) {
  constexpr int N = C::Fp::N;
  const int64_t st = (int64_t)N * T;
  store_pt(P.x, P.y, P.z, at, stride,
           load_pt<N>(buf, buf + st, buf + 2 * st, 0, T));
  if (X.x) {
    for (int i = 0; i < log_scale; ++i) S0 = pt_dbl<C>(S0);
    store_pt(X.x, X.y, X.z, at, stride, S0);
  }
}

// Shared-memory words of a block: two buffers of T points.
PT_HD constexpr int64_t wscan_smem_words(int T, int n_words) {
  return (int64_t)2 * 3 * n_words * T;
}

PT_HD int wscan_log2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

#if !defined(__CUDACC__)
// The kernel's blocks one after another on the host, phase by phase: each
// phase runs for every thread of the block before the next one starts (a
// __syncthreads on the card).
template <class C>
void wscan_level_host(cpts x, cpts p, mpts P, mpts X, int64_t W, int64_t E,
                      int64_t NB, int seg, int T, int base) {
  constexpr int N = C::Fp::N;
  const int log_seg = wscan_log2(seg), log_t = wscan_log2(T);
  std::vector<uint32_t> sh(wscan_smem_words(T, N));
  std::vector<xyz_t<N>> acc(T), S(T);
  for (int64_t blk = 0; blk < W * NB; ++blk) {
    const int64_t w = blk / NB, b = blk % NB;
    uint32_t* sh0 = sh.data();
    const int bw = 3 * N * T;
    for (int r = 0; r < T; ++r) {
      xyz_t<N> run;
      wscan_segment<C>(x, p, W, E, w, b * T + r, seg, base, run, acc[r]);
      store_pt(sh0, sh0 + N * T, sh0 + 2 * N * T, r, T, run);
    }
    int cur = 0;
    for (int k = 1; k < T; k <<= 1) {
      for (int r = 0; r < T; ++r)
        wscan_suffix_step<C>(sh0 + cur * bw, sh0 + (cur ^ 1) * bw, r, k, T);
      cur ^= 1;
    }
    const uint32_t* sb = sh0 + cur * bw;
    uint32_t* tb = sh0 + (cur ^ 1) * bw;
    for (int r = 0; r < T; ++r) {
      S[r] = load_pt<N>(sb, sb + N * T, sb + 2 * N * T, r, T);
      store_pt(tb, tb + N * T, tb + 2 * N * T, r, T,
               wscan_term<C>(acc[r], S[r], r, log_seg));
    }
    for (int s = T / 2; s > 0; s >>= 1)
      for (int r = 0; r < s; ++r) wscan_tree_step<C>(tb, r, s, T);
    wscan_block_out<C>(tb, S[0], P, X, w * NB + b, W * NB, T,
                       log_seg + log_t);
  }
}
#endif

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 128;   // the most threads a block (T <= kThreads)

// Blocks of kThreads an SM the kernel is built for: 2, at most 255
// registers a thread, for every curve.  A BN254 build for 4 blocks (128
// registers) spills 334 bytes a thread and measured slower, as did 3
// (tools/occupancy_sweep.py builds and times other values).
#ifndef PTT_WSCAN_BLOCKS
#define PTT_WSCAN_BLOCKS 2
#endif

// Coordinates of at least this many words overlap the scaling of S_0 with
// the block's tree (below).  On an H100 it saves the 12-word BLS curves
// 4-13% and would cost BN254 2-4% (tools/occupancy_sweep.py times both).
#ifndef PTT_WSCAN_OVERLAP_WORDS
#define PTT_WSCAN_OVERLAP_WORDS 12
#endif

// Named barrier 1 over the block's first `count` threads (a multiple of 32).
__device__ __forceinline__ void bar_lower(int count) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(count) : "memory");
}

template <class C>
__global__ void __launch_bounds__(kThreads, PTT_WSCAN_BLOCKS)
    wscan_kernel(ptt::cpts x, ptt::cpts p, ptt::mpts P, ptt::mpts X,
                 int64_t W, int64_t E, int64_t NB, int seg, int log_seg,
                 int base, int log_scale) {
  constexpr int N = C::Fp::N;
  extern __shared__ uint32_t sh[];
  const int T = blockDim.x, r = threadIdx.x;
  const int64_t w = blockIdx.x / NB, b = blockIdx.x % NB;
  const int bw = 3 * N * T;            // a buffer's words
  ptt::xyz_t<N> run, acc;
  ptt::wscan_segment<C>(x, p, W, E, w, b * T + r, seg, base, run, acc);
  ptt::store_pt(sh, sh + N * T, sh + 2 * N * T, r, T, run);
  __syncthreads();
  int cur = 0;
  for (int k = 1; k < T; k <<= 1) {
    ptt::wscan_suffix_step<C>(sh + cur * bw, sh + (cur ^ 1) * bw, r, k, T);
    cur ^= 1;
    __syncthreads();
  }
  const uint32_t* sb = sh + cur * bw;
  const ptt::xyz_t<N> S =
      ptt::load_pt<N>(sb, sb + N * T, sb + 2 * N * T, r, T);
  uint32_t* tb = sh + (cur ^ 1) * bw;
  ptt::store_pt(tb, tb + N * T, tb + 2 * N * T, r, T,
                ptt::wscan_term<C>(acc, S, r, log_seg));
  __syncthreads();
  const int64_t at = w * NB + b, stride = W * NB;
  if (N >= PTT_WSCAN_OVERLAP_WORDS && X.x && T >= 64) {
    // The tree runs on the first T / 2 threads (named barrier 1) while the
    // last thread, idle in the tree, scales S_0 into X_b.
    if (r == T - 1) {
      ptt::xyz_t<N> s0 = ptt::load_pt<N>(sb, sb + N * T, sb + 2 * N * T, 0, T);
      for (int i = 0; i < log_scale; ++i) s0 = ptt::pt_dbl<C>(s0);
      ptt::store_pt(X.x, X.y, X.z, at, stride, s0);
    }
    if (r >= T / 2) return;
    for (int s = T / 2; s > 0; s >>= 1) {
      if (r < s) ptt::wscan_tree_step<C>(tb, r, s, T);
      bar_lower(T / 2);
    }
    if (r == 0)
      ptt::store_pt(P.x, P.y, P.z, at, stride,
                    ptt::load_pt<N>(tb, tb + N * T, tb + 2 * N * T, 0, T));
    return;
  }
  for (int s = T / 2; s > 0; s >>= 1) {
    if (r < s) ptt::wscan_tree_step<C>(tb, r, s, T);
    __syncthreads();
  }
  if (r == 0)
    ptt::wscan_block_out<C>(tb, S, P, X, at, stride, T, log_scale);
}

template <class C>
constexpr size_t kWscanSmem =
    (size_t)ptt::wscan_smem_words(kThreads, C::Fp::N) * sizeof(uint32_t);

template <class C>
int wscan_launch(ptt::cpts x, ptt::cpts p, ptt::mpts P, ptt::mpts X,
                 int64_t W, int64_t E, int64_t NB, int seg, int T,
                 int base, cudaStream_t stream) {
  const int log_seg = ptt::wscan_log2(seg), log_t = ptt::wscan_log2(T);
  if (seg != 1 << log_seg || T != 1 << log_t || T > kThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)ptt::wscan_smem_words(T, C::Fp::N) * sizeof(uint32_t);
  const cudaError_t e = cudaFuncSetAttribute(
      wscan_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWscanSmem<C>);
  if (e != cudaSuccess) return (int)e;
  wscan_kernel<C><<<(unsigned)(W * NB), T, smem, stream>>>(
      x, p, P, X, W, E, NB, seg, log_seg, base, log_seg + log_t);
  return (int)cudaGetLastError();
}

// One level; p and X may be null (level 0 has no p, the last level no X).
extern "C" int ptt_wscan_level(const uint32_t* xx, const uint32_t* xy,
                               const uint32_t* xz, const uint32_t* px,
                               const uint32_t* py, const uint32_t* pz,
                               uint32_t* Px, uint32_t* Py, uint32_t* Pz,
                               uint32_t* Xx, uint32_t* Xy, uint32_t* Xz,
                               int64_t W, int64_t E, int64_t NB, int seg,
                               int T, int base, int curve, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const ptt::cpts x{xx, xy, xz}, p{px, py, pz};
  const ptt::mpts P{Px, Py, Pz}, X{Xx, Xy, Xz};
  switch (curve) {
    case 0: return wscan_launch<ptt::Bn254>(x, p, P, X, W, E, NB, seg, T,
                                            base, s);
    case 1: return wscan_launch<ptt::Bls12_377>(x, p, P, X, W, E, NB, seg, T,
                                                base, s);
    case 2: return wscan_launch<ptt::Bls12_381>(x, p, P, X, W, E, NB, seg, T,
                                                base, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Threads of one full wave of the curve's kernel, in blocks of kThreads, on
// the current device.
extern "C" int ptt_wscan_threads(int curve, int* threads) {
  switch (curve) {
    case 0: return ptt_resident(wscan_kernel<ptt::Bn254>, kThreads,
                                kWscanSmem<ptt::Bn254>, threads);
    case 1: return ptt_resident(wscan_kernel<ptt::Bls12_377>, kThreads,
                                kWscanSmem<ptt::Bls12_377>, threads);
    case 2: return ptt_resident(wscan_kernel<ptt::Bls12_381>, kThreads,
                                kWscanSmem<ptt::Bls12_381>, threads);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
