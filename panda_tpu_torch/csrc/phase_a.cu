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
//   px, py         (8, n)     affine bases, Montgomery, canonical
//   ekeys          (W, S, m)  emitted run keys (dead = D + 1)
//   ex, ey, ez     (8, P)     emitted run sums, written where ekeys != dead
//                             and left as they were elsewhere
//   tkeys          (W, m)     lane tail keys
//   tx, ty, tz     (8, W*m)   lane tail sums
//
// Bound on the H100: 32-bit multiply throughput, 11 CIOS multiplies a mixed
// add (264 multiply-adds each).  A thread's S mixed adds depend on each
// other, so the card is kept busy by threads in flight, not by ILP: the
// launch is sized (ops/msm.py, _PHASE_A_THREADS) to >= 2^16 threads, and
// __launch_bounds__(128, 4) caps a thread at 128 registers so 4 blocks (16
// warps) fit on each of the 132 SMs.  Step s + 1's key, index and base point
// are loaded before step s's mixed add, so the random 64-byte gather
// overlaps the arithmetic.  A run ends about once in every n / D steps (16
// at 2^16, 32 at 2^20), and its 96-byte sum is stored only then.

#include "field.cuh"

namespace ptt {

constexpr uint32_t kInitKey = 0xFFFFFFFFu;

PT_FN void phase_a_lane(const uint32_t* keys, const uint32_t* sidx,
                        const uint32_t* px, const uint32_t* py, int64_t n,
                        uint32_t* ekeys, uint32_t* ex, uint32_t* ey,
                        uint32_t* ez, uint32_t* tkeys, uint32_t* tx,
                        uint32_t* ty, uint32_t* tz, int64_t lane, int64_t m,
                        int64_t S, int64_t lanes_total, uint32_t dead) {
  const int64_t w = lane / m, q = lane % m;
  const int64_t P = lanes_total * S;
  const xyz ident = pt_identity();
  xyz acc = ident;
  uint32_t akey = kInitKey;
  int64_t pos = w * S * m + q;
  uint32_t k = keys[pos], raw = sidx[pos];
  fe qx = load_fe(px, raw & 0x7FFFFFFFu, n);
  fe qy = load_fe(py, raw & 0x7FFFFFFFu, n);
  for (int64_t s = 0; s < S; ++s) {
    // step s + 1's loads (step s's again at the last step), ahead of the add
    const int64_t npos = s + 1 < S ? pos + m : pos;
    const uint32_t nk = keys[npos], nraw = sidx[npos];
    const fe nx = load_fe(px, nraw & 0x7FFFFFFFu, n);
    const fe ny = load_fe(py, nraw & 0x7FFFFFFFu, n);
    if (raw >> 31) qy = sub_mod<Fp254>(fe_zero(), qy);
    const bool same = k == akey;
    const bool emit = !same && akey != kInitKey;
    ekeys[pos] = emit ? akey : dead;
    if (emit) store_pt(ex, ey, ez, pos, P, acc);
    acc = pt_madd(pt_select(same, acc, ident), qx, qy);
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

__global__ void __launch_bounds__(kThreads, 4)
    phase_a_kernel(const uint32_t* keys, const uint32_t* sidx,
                   const uint32_t* px, const uint32_t* py, int64_t n,
                   uint32_t* ekeys, uint32_t* ex, uint32_t* ey, uint32_t* ez,
                   uint32_t* tkeys, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                   int64_t m, int64_t S, int64_t lanes_total, uint32_t dead) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < lanes_total)
    ptt::phase_a_lane(keys, sidx, px, py, n, ekeys, ex, ey, ez, tkeys, tx, ty,
                      tz, lane, m, S, lanes_total, dead);
}

extern "C" int ptt_phase_a(const uint32_t* keys, const uint32_t* sidx,
                           const uint32_t* px, const uint32_t* py, int64_t n,
                           uint32_t* ekeys, uint32_t* ex, uint32_t* ey,
                           uint32_t* ez, uint32_t* tkeys, uint32_t* tx,
                           uint32_t* ty, uint32_t* tz, int64_t W, int64_t m,
                           int64_t S, int dead, void* stream) {
  const int64_t lanes_total = W * m;
  phase_a_kernel<<<PTT_LAUNCH_DIMS(lanes_total, kThreads), 0,
                   (cudaStream_t)stream>>>(keys, sidx, px, py, n, ekeys, ex,
                                           ey, ez, tkeys, tx, ty, tz, m, S,
                                           lanes_total, (uint32_t)dead);
  return (int)cudaGetLastError();
}

#endif
