// MSM phase A: sorted-run bucket accumulation with complete mixed adds.
//
// Replaces the TPU kernel panda_tpu/ops/phase_a_pallas.py::phase_a_scan_tiles.
// Same function, GPU-natural form:
//   * one thread per (window w, lane q); the accumulator stays in registers
//     and a loop over the lane's S sorted entries replaces the TPU's
//     sequential grid axis;
//   * the thread gathers its base point bases[idx] itself (the TPU version
//     read a pre-gathered, word-packed tile stream) and negates y in-kernel
//     for a negative digit;
//   * at each step it writes the key of the run that ended there (the dead
//     key where none did) and, only where one did, that run's sum; at the
//     end it writes the lane's tail (key, point).
//
// Layouts (int32 tensors holding uint32 words), P = W * S * m entries:
//   keys, sidx     (W, S, m)  sorted digit, and point index | sign << 31,
//                             step-major so a warp's loads are coalesced
//   px, py         (L, n)     affine bases, Montgomery, canonical
//   ekeys          (W, S, m)  emitted run keys (dead = D + 1)
//   ex, ey, ez     (L, P)     emitted run sums, written where ekeys != dead
//                             and left as they were elsewhere
//   tkeys          (W, m)     lane tail keys
//   tx, ty, tz     (L, W*m)   lane tail sums
// with L = 8 words a coordinate for BN254 and 12 for the BLS curves; the
// launcher takes a curve id, the curve's index in _ext.MSM_CURVES.
//
// Bound on the H100: 32-bit multiply throughput, 11 CIOS multiplies a mixed
// add (264 multiply-adds each at 8 words, 588 at 12).  A thread's S mixed
// adds depend on each other, so the card is kept busy by threads in flight,
// not by ILP: the launch is sized (ops/msm.py, _PHASE_A_THREADS) to >= 2^16
// threads.  For BN254, __launch_bounds__(128, 4) caps a thread at 128
// registers so 4 blocks (16 warps) fit on each of the 132 SMs, one wave.  A
// 12-word lane holds a 36-word accumulator and two 24-word affine points
// (this step's and the next), 84 words before the mixed add's temporaries,
// which cannot fit 128 registers: the BLS instantiations take
// __launch_bounds__(128, 2), up to 255 registers, 2 blocks an SM, so 2^16
// threads take two waves.  Step s + 1's key, index and base point are
// loaded before step s's mixed add, so the random gather (64 bytes a point
// at 8 words, 96 at 12) overlaps the arithmetic.  A run ends about once in
// every n / D steps (16 at 2^16, 32 at 2^20), and its sum (96 or 144 bytes)
// is stored only then.

#include "field.cuh"

namespace ptt {

constexpr uint32_t kInitKey = 0xFFFFFFFFu;

template <class C>
PT_FN void phase_a_lane(const uint32_t* keys, const uint32_t* sidx,
                        const uint32_t* px, const uint32_t* py, int64_t n,
                        uint32_t* ekeys, uint32_t* ex, uint32_t* ey,
                        uint32_t* ez, uint32_t* tkeys, uint32_t* tx,
                        uint32_t* ty, uint32_t* tz, int64_t lane, int64_t m,
                        int64_t S, int64_t lanes_total, uint32_t dead) {
  using F = typename C::Fp;
  constexpr int N = F::N;
  const int64_t w = lane / m, q = lane % m;
  const int64_t P = lanes_total * S;
  const xyz_t<N> ident = pt_identity<C>();
  xyz_t<N> acc = ident;
  uint32_t akey = kInitKey;
  int64_t pos = w * S * m + q;
  uint32_t k = keys[pos], raw = sidx[pos];
  fe_t<N> qx = load_fe<N>(px, raw & 0x7FFFFFFFu, n);
  fe_t<N> qy = load_fe<N>(py, raw & 0x7FFFFFFFu, n);
  for (int64_t s = 0; s < S; ++s) {
    // step s + 1's loads (step s's again at the last step), ahead of the add
    const int64_t npos = s + 1 < S ? pos + m : pos;
    const uint32_t nk = keys[npos], nraw = sidx[npos];
    const fe_t<N> nx = load_fe<N>(px, nraw & 0x7FFFFFFFu, n);
    const fe_t<N> ny = load_fe<N>(py, nraw & 0x7FFFFFFFu, n);
    if (raw >> 31) qy = sub_mod<F>(fe_zero<N>(), qy);
    const bool same = k == akey;
    const bool emit = !same && akey != kInitKey;
    ekeys[pos] = emit ? akey : dead;
    if (emit) store_pt(ex, ey, ez, pos, P, acc);
    acc = pt_madd<C>(pt_select(same, acc, ident), qx, qy);
    akey = k;
    pos = npos;
    k = nk;
    raw = nraw;
    qx = nx;
    qy = ny;
  }
  tkeys[lane] = akey;
  store_pt(tx, ty, tz, lane, lanes_total, acc);
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 128;

// Blocks of kThreads an SM that each instantiation is built for: 4 (at most
// 128 registers a thread) for 8-word coordinates, 2 (at most 255) for 12.
template <class C>
constexpr int kPhaseABlocks = C::Fp::N == 8 ? 4 : 2;

template <class C>
__global__ void __launch_bounds__(kThreads, kPhaseABlocks<C>)
    phase_a_kernel(const uint32_t* keys, const uint32_t* sidx,
                   const uint32_t* px, const uint32_t* py, int64_t n,
                   uint32_t* ekeys, uint32_t* ex, uint32_t* ey, uint32_t* ez,
                   uint32_t* tkeys, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                   int64_t m, int64_t S, int64_t lanes_total, uint32_t dead) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < lanes_total)
    ptt::phase_a_lane<C>(keys, sidx, px, py, n, ekeys, ex, ey, ez, tkeys, tx,
                         ty, tz, lane, m, S, lanes_total, dead);
}

template <class C>
int phase_a_launch(const uint32_t* keys, const uint32_t* sidx,
                   const uint32_t* px, const uint32_t* py, int64_t n,
                   uint32_t* ekeys, uint32_t* ex, uint32_t* ey, uint32_t* ez,
                   uint32_t* tkeys, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                   int64_t W, int64_t m, int64_t S, int dead,
                   cudaStream_t stream) {
  const int64_t lanes_total = W * m;
  phase_a_kernel<C><<<PTT_LAUNCH_DIMS(lanes_total, kThreads), 0, stream>>>(
      keys, sidx, px, py, n, ekeys, ex, ey, ez, tkeys, tx, ty, tz, m, S,
      lanes_total, (uint32_t)dead);
  return (int)cudaGetLastError();
}

extern "C" int ptt_phase_a(const uint32_t* keys, const uint32_t* sidx,
                           const uint32_t* px, const uint32_t* py, int64_t n,
                           uint32_t* ekeys, uint32_t* ex, uint32_t* ey,
                           uint32_t* ez, uint32_t* tkeys, uint32_t* tx,
                           uint32_t* ty, uint32_t* tz, int64_t W, int64_t m,
                           int64_t S, int dead, int curve, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (curve) {
    case 0: return phase_a_launch<ptt::Bn254>(keys, sidx, px, py, n, ekeys,
                                              ex, ey, ez, tkeys, tx, ty, tz,
                                              W, m, S, dead, s);
    case 1: return phase_a_launch<ptt::Bls12_377>(keys, sidx, px, py, n,
                                                  ekeys, ex, ey, ez, tkeys,
                                                  tx, ty, tz, W, m, S, dead,
                                                  s);
    case 2: return phase_a_launch<ptt::Bls12_381>(keys, sidx, px, py, n,
                                                  ekeys, ex, ey, ez, tkeys,
                                                  tx, ty, tz, W, m, S, dead,
                                                  s);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
