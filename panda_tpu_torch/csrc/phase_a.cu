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
//   * at each step it emits (key, accumulated run) when the key changes
//     (dead key and the identity otherwise), and at the end it writes the
//     lane's tail (key, point).
//
// Layouts (int32 tensors holding uint32 words), P = W * S * m entries:
//   keys, sidx     (W, S, m)  sorted digit, and point index | sign << 31,
//                             step-major so a warp's loads are coalesced
//   px, py         (8, n)     affine bases, Montgomery, canonical
//   ekeys          (W, S, m)  emitted run keys (dead = D + 1)
//   ex, ey, ez     (8, P)     emitted run sums
//   tkeys          (W, m)     lane tail keys
//   tx, ty, tz     (8, W*m)   lane tail sums
//
// Bound on the H100: the random gather of 64-byte base points and 32-bit
// multiply throughput of the mixed add.  Simple, correct first version: the
// emissions are written at every step (identity when nothing ends there).

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
  for (int64_t s = 0; s < S; ++s) {
    const int64_t pos = (w * S + s) * m + q;
    const uint32_t k = keys[pos];
    const uint32_t raw = sidx[pos];
    const int64_t idx = raw & 0x7FFFFFFFu;
    const fe qx = load_fe(px, idx, n);
    fe qy = load_fe(py, idx, n);
    if (raw >> 31) qy = sub_mod<Fp254>(fe_zero(), qy);
    const bool same = k == akey;
    const bool emit = !same && akey != kInitKey;
    ekeys[pos] = emit ? akey : dead;
    store_pt(ex, ey, ez, pos, P, pt_select(emit, acc, ident));
    acc = pt_madd(pt_select(same, acc, ident), qx, qy);
    akey = k;
  }
  tkeys[lane] = akey;
  store_pt(tx, ty, tz, lane, lanes_total, acc);
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
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
