// MSM phase A: sorted-run bucket accumulation with complete mixed adds.
//
// Replaces the TPU kernel panda_tpu/ops/phase_a_pallas.py::phase_a_scan_tiles.
// Same function, GPU-natural form:
//   * one thread per (window w, lane q); the accumulator stays in registers
//     and a loop over the lane's S sorted entries replaces the TPU's
//     sequential grid axis;
//   * the thread gathers its base points itself (the TPU version read a
//     pre-gathered, word-packed tile stream) through a ring in shared
//     memory, and negates y for a negative digit;
//   * at each step it writes the key of the run that ended there (the dead
//     key where none did) and, only where one did, that run's sum; at the
//     end it writes the lane's tail (key, point).
//
// Layouts (int32 tensors holding uint32 words), P = W * S * m entries:
//   keys, sidx     (W, S, m)  sorted digit, and point index | sign << 31,
//                             step-major so a warp's loads are coalesced
//   pts            (n, 2L)    point-major affine bases, Montgomery,
//                             canonical: x's L words then y's, 64 bytes a
//                             point for BN254 and 96 for the BLS curves
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
// not by ILP; the launch is one wave (ops/msm.py sizes the lanes from the
// blocks an SM below).
//
// Design for Hopper:
//   * The gather.  A point-major row is 4 (BN254) or 6 (BLS) 16-byte
//     chunks from 2 or 3 sectors, where the word-major (L, n) tables cost a
//     32-byte sector a word (16 or 24 sectors a point).  Hopper's TMA
//     cannot gather arbitrary rows, so each thread copies its own rows with
//     cp.async.cg, PTT_PHASE_A_RING steps ahead (4; 2 and 8 measured no
//     faster, tools/occupancy_sweep.py), into its slots of a ring in
//     shared memory; the copies neither hold registers nor wait on the
//     thread until cp.async.wait_group asks for the step it adds now.  A
//     slot holds the point as L / 2 chunks, chunk c of thread t at 16-byte
//     index (slot * L/2 + c) * T + t, so a warp's copies and reads of one
//     chunk cover 512 contiguous bytes (no bank conflict); the step's key
//     and raw index sit beside it.
//   * Residency.  Without a prefetched point in registers the 12-word lane
//     fits 3 blocks of 128 an SM (at most 168 registers), BN254 keeps 4
//     (128 registers); each block's ring is ring * 128 * (2L * 4 + 8)
//     bytes (36 KB for BN254, 52 KB for BLS at ring 4).  The launcher
//     reports the threads resident at once (ptt_phase_a_threads), from
//     which ops/msm.py sizes the lanes.
//   * The host form.  The lane loop is a plain function over a copy policy:
//     cp.async on the card, and on the host (tests/test_torch_csrc.py) a
//     copy that is deferred until the wait releases its group, so a slot
//     read before its wait sees stale words there too.
//
// A run ends about once in every n / D steps (16 at 2^16, 32 at 2^20), and
// its sum (96 or 144 bytes) is stored only then.

#include "field.cuh"

namespace ptt {

constexpr uint32_t kInitKey = 0xFFFFFFFFu;

// Steps of copies in flight ahead of the step being added.
#ifndef PTT_PHASE_A_RING
#define PTT_PHASE_A_RING 4
#endif
constexpr int kPhaseARing = PTT_PHASE_A_RING;

// Word index of 16-byte chunk c of thread t's slot in a ring of T threads,
// `chunks` chunks a point.
PT_FN int64_t ring_chunk(int slot, int c, int t, int T, int chunks) {
  return ((int64_t)(slot * chunks + c) * T + t) * 4;
}

// Word index of thread t's key in slot `slot` of the key ring (its raw
// index is the next word).
PT_FN int64_t ring_key(int slot, int t, int T) {
  return ((int64_t)slot * T + t) * 2;
}

// Shared-memory words of a block's rings.
PT_HD constexpr int64_t phase_a_ring_words(int ring, int T, int n_words) {
  return (int64_t)ring * T * (2 * n_words + 2);
}


// Step s's copies into its slot: the point's 2L / 4 chunks, its key and raw
// index.
template <int N, class Copy>
PT_FN void phase_a_fetch(const uint32_t* pts, uint32_t* ring, uint32_t* kring,
                         int slot, int t, int T, uint32_t k, uint32_t raw,
                         Copy& cp) {
  constexpr int CH = N / 2;
  const uint32_t* row = pts + (int64_t)(raw & 0x7FFFFFFFu) * (2 * N);
#pragma unroll
  for (int c = 0; c < CH; ++c)
    cp.copy16(ring + ring_chunk(slot, c, t, T, CH), row + 4 * c);
  kring[ring_key(slot, t, T)] = k;
  kring[ring_key(slot, t, T) + 1] = raw;
}

// Lane `lane` (thread t of a block of T) over its S steps, R steps of
// copies ahead.
template <int R, class C, class Copy>
PT_FN void phase_a_lane(const uint32_t* keys, const uint32_t* sidx,
                        const uint32_t* pts, uint32_t* ekeys, uint32_t* ex,
                        uint32_t* ey, uint32_t* ez, uint32_t* tkeys,
                        uint32_t* tx, uint32_t* ty, uint32_t* tz, int64_t lane,
                        int64_t m, int64_t S, int64_t lanes_total,
                        uint32_t dead, uint32_t* ring, uint32_t* kring, int t,
                        int T, Copy& cp) {
  using F = typename C::Fp;
  constexpr int N = F::N, CH = N / 2;
  const int64_t w = lane / m, q = lane % m;
  const int64_t P = lanes_total * S;
  const int64_t pos0 = w * S * m + q;
  for (int j = 0; j < R; ++j) {
    if (j < S)
      phase_a_fetch<N>(pts, ring, kring, j, t, T, keys[pos0 + j * m],
                       sidx[pos0 + j * m], cp);
    cp.commit();
  }
  const xyz_t<N> ident = pt_identity<C>();
  xyz_t<N> acc = ident;
  uint32_t akey = kInitKey;
  int slot = 0;
  for (int64_t s = 0; s < S; ++s) {
    // step s + R's key and index, loaded ahead of this step's add
    const bool more = s + R < S;
    const int64_t npos = pos0 + (s + R) * m;
    const uint32_t nk = more ? keys[npos] : 0u;
    const uint32_t nraw = more ? sidx[npos] : 0u;
    cp.template wait<R - 1>();
    const uint32_t k = kring[ring_key(slot, t, T)];
    const uint32_t raw = kring[ring_key(slot, t, T) + 1];
    fe_t<N> qx, qy;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const uint32_t* src = ring + ring_chunk(slot, c, t, T, CH);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * c + i;
        if (j < N)
          qx.w[j] = src[i];
        else
          qy.w[j - N] = src[i];
      }
    }
    if (raw >> 31) qy = sub_mod<F>(fe_zero<N>(), qy);
    const int64_t pos = pos0 + s * m;
    const bool same = k == akey;
    const bool emit = !same && akey != kInitKey;
    ekeys[pos] = emit ? akey : dead;
    if (emit) store_pt(ex, ey, ez, pos, P, acc);
    acc = pt_madd<C>(pt_select(same, acc, ident), qx, qy);
    akey = k;
    // the slot is read: refill it with step s + R
    if (more) phase_a_fetch<N>(pts, ring, kring, slot, t, T, nk, nraw, cp);
    cp.commit();
    slot = slot + 1 == R ? 0 : slot + 1;
  }
  tkeys[lane] = akey;
  store_pt(tx, ty, tz, lane, lanes_total, acc);
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 128;

// Blocks of kThreads an SM that each instantiation is built for: 4 (at most
// 128 registers a thread) for 8-word coordinates, 3 (at most 168) for 12 (a
// BLS build for 2, 255 registers, measured slower: tools/occupancy_sweep.py
// builds and times other values).
#ifndef PTT_PHASE_A_BLOCKS_8
#define PTT_PHASE_A_BLOCKS_8 4
#endif
#ifndef PTT_PHASE_A_BLOCKS_12
#define PTT_PHASE_A_BLOCKS_12 3
#endif
template <class C>
constexpr int kPhaseABlocks =
    C::Fp::N == 8 ? PTT_PHASE_A_BLOCKS_8 : PTT_PHASE_A_BLOCKS_12;

template <class C>
__global__ void __launch_bounds__(kThreads, kPhaseABlocks<C>)
    phase_a_kernel(const uint32_t* keys, const uint32_t* sidx,
                   const uint32_t* pts, uint32_t* ekeys, uint32_t* ex,
                   uint32_t* ey, uint32_t* ez, uint32_t* tkeys, uint32_t* tx,
                   uint32_t* ty, uint32_t* tz, int64_t m, int64_t S,
                   int64_t lanes_total, uint32_t dead) {
  constexpr int R = ptt::kPhaseARing;
  extern __shared__ __align__(16) uint32_t ring[];
  const int t = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + t;
  uint32_t* kring = ring + (int64_t)R * blockDim.x * 2 * C::Fp::N;
  ptt::RingCopy cp;
  if (lane < lanes_total)
    ptt::phase_a_lane<R, C>(keys, sidx, pts, ekeys, ex, ey, ez, tkeys, tx,
                            ty, tz, lane, m, S, lanes_total, dead, ring,
                            kring, t, blockDim.x, cp);
}

template <class C>
constexpr size_t kPhaseASmem =
    (size_t)ptt::phase_a_ring_words(ptt::kPhaseARing, kThreads, C::Fp::N) *
    sizeof(uint32_t);

template <class C>
int phase_a_launch(const uint32_t* keys, const uint32_t* sidx,
                   const uint32_t* pts, uint32_t* ekeys, uint32_t* ex,
                   uint32_t* ey, uint32_t* ez, uint32_t* tkeys, uint32_t* tx,
                   uint32_t* ty, uint32_t* tz, int64_t W, int64_t m,
                   int64_t S, int dead, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(pts) % 16) return (int)cudaErrorInvalidValue;
  const size_t smem = kPhaseASmem<C>;
  const cudaError_t e = cudaFuncSetAttribute(
      phase_a_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t lanes_total = W * m;
  phase_a_kernel<C><<<PTT_LAUNCH_DIMS(lanes_total, kThreads), smem, stream>>>(
      keys, sidx, pts, ekeys, ex, ey, ez, tkeys, tx, ty, tz, m, S,
      lanes_total, (uint32_t)dead);
  return (int)cudaGetLastError();
}

extern "C" int ptt_phase_a(const uint32_t* keys, const uint32_t* sidx,
                           const uint32_t* pts, uint32_t* ekeys, uint32_t* ex,
                           uint32_t* ey, uint32_t* ez, uint32_t* tkeys,
                           uint32_t* tx, uint32_t* ty, uint32_t* tz,
                           int64_t W, int64_t m, int64_t S, int dead,
                           int curve, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (curve) {
    case 0: return phase_a_launch<ptt::Bn254>(keys, sidx, pts, ekeys, ex, ey,
                                              ez, tkeys, tx, ty, tz, W, m, S,
                                              dead, s);
    case 1: return phase_a_launch<ptt::Bls12_377>(keys, sidx, pts, ekeys, ex,
                                                  ey, ez, tkeys, tx, ty, tz,
                                                  W, m, S, dead, s);
    case 2: return phase_a_launch<ptt::Bls12_381>(keys, sidx, pts, ekeys, ex,
                                                  ey, ez, tkeys, tx, ty, tz,
                                                  W, m, S, dead, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Threads of one full wave of the curve's kernel on the current device.
extern "C" int ptt_phase_a_threads(int curve, int* threads) {
  switch (curve) {
    case 0: return ptt_resident(phase_a_kernel<ptt::Bn254>, kThreads,
                                kPhaseASmem<ptt::Bn254>, threads);
    case 1: return ptt_resident(phase_a_kernel<ptt::Bls12_377>, kThreads,
                                kPhaseASmem<ptt::Bls12_377>, threads);
    case 2: return ptt_resident(phase_a_kernel<ptt::Bls12_381>, kThreads,
                                kPhaseASmem<ptt::Bls12_381>, threads);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
