// Elementwise complete point operations: add, mixed add, k doublings.
//
// Replaces the TPU kernel panda_tpu/ops/point_pallas.py::_run behind
// padd / pmadd / pdbl.  Coordinates are limbs-first (L, n) uint32 words,
// L = 8 for BN254 and 12 for the BLS curves, so each word row is read and
// written coalesced across a warp; each launcher takes a curve id, the
// curve's index in _ext.MSM_CURVES.
//
// Bound on the H100: 32-bit integer multiply-adds.  An element reads 6
// (padd), 5 (pmadd) or 3 (pdbl) coordinates, writes 3, and multiplies 12,
// 11 or 8 k times, 264 multiply-adds a product at 8 words and 588 at 12:
// padd over (8, 2^19) moves 151 MB (0.045 ms at 3.35 TB/s) and needs 1.66 G
// multiply-adds (0.099 ms at 16.7 T/s).  So the design spends on issue:
//   * every product is field.cuh's mont_mul_wide (WideProduct: each word
//     product's lo and hi halves in one IMAD.WIDE.U32.X, ~230 instructions
//     against mont_mul's ~600, the same words);
//   * one wave: the launch takes the threads that the occupancy calculator
//     reports for the build (ptt_point_ops_threads, at most one wave) and
//     each thread walks the elements with a grid stride;
//   * launch bounds of kPointThreads threads and the blocks an SM below,
//     chosen with tools/occupancy_sweep.py point_ops (which builds and
//     times the others; two interleaved elements a thread and mont_mul
//     products both lost on every op, curve and shape: PERF.md);
//   * pdbl loads a point once, doubles it k times in registers and stores
//     it once (the device Horner's c doublings a window in one launch).
// No shared memory, TMA or tensor cores: no element is read twice and no
// thread reads another's words, so staging a tile buys nothing, and each
// product is of two variable operands used by one element only, with no
// matrix for the tensor cores to multiply.

#include "field.cuh"

// Blocks an SM that the launch bounds ask for: padd and pdbl
// (PTT_POINT_BLOCKS_8 / _12) and pmadd (PTT_PMADD_BLOCKS_8 / _12) of the
// 8- and 12-word curves.  On the H100 (the sweep's table in PERF.md):
// 8 words, padd and pdbl at 4 (128 registers, no spill) lead at 2^20 points'
// tables, where 5 spills and 3 (the compiler's own 146) trails; pmadd at 4
// spills 32 bytes and with no bound takes 128 registers and none; 12 words
// at 2 (the compiler's own, 166-250, no spill) lead, where 3 (168) spills
// up to 216 bytes.  Only 5 blocks fit the 2^16 tables (81920 elements) in
// one round of the wave, up to 15% faster there with spills.
#ifndef PTT_POINT_BLOCKS_8
#define PTT_POINT_BLOCKS_8 4
#endif
#ifndef PTT_POINT_BLOCKS_12
#define PTT_POINT_BLOCKS_12 2
#endif
#ifndef PTT_PMADD_BLOCKS_8
#define PTT_PMADD_BLOCKS_8 1
#endif
#ifndef PTT_PMADD_BLOCKS_12
#define PTT_PMADD_BLOCKS_12 2
#endif

namespace ptt {

constexpr int kPointThreads = 128;

// Each op: load(i) reads element i's inputs, run computes its point,
// store(i, r) writes it.
template <class C>
struct PaddOp {
  static constexpr int N = C::Fp::N;
  struct In {
    xyz_t<N> p, q;
  };
  cpts p, q;
  mpts r;
  int64_t n;
  PT_FN In load(int64_t i) const {
    return {load_pt<N>(p.x, p.y, p.z, i, n),
            load_pt<N>(q.x, q.y, q.z, i, n)};
  }
  PT_FN xyz_t<N> run(const In& a) const {
    return pt_add<C, WideProduct>(a.p, a.q);
  }
  PT_FN void store(int64_t i, const xyz_t<N>& v) const {
    store_pt(r.x, r.y, r.z, i, n, v);
  }
};

template <class C>
struct PmaddOp {
  static constexpr int N = C::Fp::N;
  struct In {
    xyz_t<N> p;
    fe_t<N> qx, qy;
  };
  cpts p;
  const uint32_t *qx, *qy;
  mpts r;
  int64_t n;
  PT_FN In load(int64_t i) const {
    return {load_pt<N>(p.x, p.y, p.z, i, n), load_fe<N>(qx, i, n),
            load_fe<N>(qy, i, n)};
  }
  PT_FN xyz_t<N> run(const In& a) const {
    return pt_madd<C, WideProduct>(a.p, a.qx, a.qy);
  }
  PT_FN void store(int64_t i, const xyz_t<N>& v) const {
    store_pt(r.x, r.y, r.z, i, n, v);
  }
};

template <class C>
struct PdblOp {
  static constexpr int N = C::Fp::N;
  using In = xyz_t<N>;
  cpts p;
  mpts r;
  int64_t n;
  int k;  // doublings, >= 1
  PT_FN In load(int64_t i) const { return load_pt<N>(p.x, p.y, p.z, i, n); }
  PT_FN xyz_t<N> run(In v) const {
    for (int j = 0; j < k; ++j) v = pt_dbl<C, WideProduct>(v);
    return v;
  }
  PT_FN void store(int64_t i, const xyz_t<N>& v) const {
    store_pt(r.x, r.y, r.z, i, n, v);
  }
};

// Thread t of `threads` over op.n elements: elements t, t + threads, ...
template <class Op>
PT_FN void point_thread(const Op& op, int64_t t, int64_t threads) {
  for (int64_t i = t; i < op.n; i += threads) op.store(i, op.run(op.load(i)));
}

// Blocks of a launch over n elements with `resident` threads a wave: the
// blocks that n needs at one element a thread, at most one wave, at least 1.
PT_HD int64_t point_blocks(int64_t n, int resident) {
  const int64_t wave = resident / kPointThreads;
  const int64_t need = (n + kPointThreads - 1) / kPointThreads;
  const int64_t b = need < wave ? need : wave;
  return b > 1 ? b : 1;
}

}  // namespace ptt

#if defined(__CUDACC__)

template <class C>
constexpr int kPointBlocks =
    C::Fp::N == 8 ? PTT_POINT_BLOCKS_8 : PTT_POINT_BLOCKS_12;
template <class C>
constexpr int kPmaddBlocks =
    C::Fp::N == 8 ? PTT_PMADD_BLOCKS_8 : PTT_PMADD_BLOCKS_12;

template <class Op>
__device__ __forceinline__ void point_grid(const Op& op) {
  ptt::point_thread(op, (int64_t)blockIdx.x * blockDim.x + threadIdx.x,
                    (int64_t)gridDim.x * blockDim.x);
}

template <class C>
__global__ void __launch_bounds__(ptt::kPointThreads, kPointBlocks<C>)
    padd_kernel(ptt::PaddOp<C> op) {
  point_grid(op);
}

template <class C>
__global__ void __launch_bounds__(ptt::kPointThreads, kPmaddBlocks<C>)
    pmadd_kernel(ptt::PmaddOp<C> op) {
  point_grid(op);
}

template <class C>
__global__ void __launch_bounds__(ptt::kPointThreads, kPointBlocks<C>)
    pdbl_kernel(ptt::PdblOp<C> op) {
  point_grid(op);
}

// The three launchers of curve C, and the threads of one wave of each.
template <class C>
struct PointOps {
  static int padd(const ptt::PaddOp<C>& op, int resident, cudaStream_t s) {
    padd_kernel<C><<<(unsigned)ptt::point_blocks(op.n, resident),
                     ptt::kPointThreads, 0, s>>>(op);
    return (int)cudaGetLastError();
  }
  static int pmadd(const ptt::PmaddOp<C>& op, int resident,
                   cudaStream_t s) {
    pmadd_kernel<C><<<(unsigned)ptt::point_blocks(op.n, resident),
                      ptt::kPointThreads, 0, s>>>(op);
    return (int)cudaGetLastError();
  }
  static int pdbl(const ptt::PdblOp<C>& op, int resident, cudaStream_t s) {
    pdbl_kernel<C><<<(unsigned)ptt::point_blocks(op.n, resident),
                     ptt::kPointThreads, 0, s>>>(op);
    return (int)cudaGetLastError();
  }
  static int threads(int op, int* out) {
    if (op == 0) return ptt_resident(padd_kernel<C>, ptt::kPointThreads, 0,
                                     out);
    if (op == 1) return ptt_resident(pmadd_kernel<C>, ptt::kPointThreads, 0,
                                     out);
    return ptt_resident(pdbl_kernel<C>, ptt::kPointThreads, 0, out);
  }
};

// `resident`: ptt_point_ops_threads(3 op + curve) on this device, op 0 for
// padd, 1 pmadd, 2 pdbl.
extern "C" int ptt_padd(const uint32_t* px, const uint32_t* py,
                        const uint32_t* pz, const uint32_t* qx,
                        const uint32_t* qy, const uint32_t* qz, uint32_t* rx,
                        uint32_t* ry, uint32_t* rz, int64_t n, int curve,
                        int resident, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const ptt::cpts p{px, py, pz}, q{qx, qy, qz};
  const ptt::mpts r{rx, ry, rz};
  switch (curve) {
    case 0: return PointOps<ptt::Bn254>::padd({p, q, r, n}, resident, s);
    case 1: return PointOps<ptt::Bls12_377>::padd({p, q, r, n}, resident, s);
    case 2: return PointOps<ptt::Bls12_381>::padd({p, q, r, n}, resident, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int ptt_pmadd(const uint32_t* px, const uint32_t* py,
                         const uint32_t* pz, const uint32_t* qx,
                         const uint32_t* qy, uint32_t* rx, uint32_t* ry,
                         uint32_t* rz, int64_t n, int curve, int resident,
                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const ptt::cpts p{px, py, pz};
  const ptt::mpts r{rx, ry, rz};
  switch (curve) {
    case 0: return PointOps<ptt::Bn254>::pmadd({p, qx, qy, r, n}, resident,
                                               s);
    case 1: return PointOps<ptt::Bls12_377>::pmadd({p, qx, qy, r, n},
                                                   resident, s);
    case 2: return PointOps<ptt::Bls12_381>::pmadd({p, qx, qy, r, n},
                                                   resident, s);
  }
  return (int)cudaErrorInvalidValue;
}

// k >= 1 doublings of each point.
extern "C" int ptt_pdbl(const uint32_t* px, const uint32_t* py,
                        const uint32_t* pz, uint32_t* rx, uint32_t* ry,
                        uint32_t* rz, int64_t n, int k, int curve,
                        int resident, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const ptt::cpts p{px, py, pz};
  const ptt::mpts r{rx, ry, rz};
  switch (curve) {
    case 0: return PointOps<ptt::Bn254>::pdbl({p, r, n, k}, resident, s);
    case 1: return PointOps<ptt::Bls12_377>::pdbl({p, r, n, k}, resident, s);
    case 2: return PointOps<ptt::Bls12_381>::pdbl({p, r, n, k}, resident, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Threads of one full wave of op (kid / 3) for curve (kid % 3), in blocks of
// kPointThreads, on the current device.
extern "C" int ptt_point_ops_threads(int kid, int* threads) {
  if (kid < 0 || kid >= 9) return (int)cudaErrorInvalidValue;
  switch (kid % 3) {
    case 0: return PointOps<ptt::Bn254>::threads(kid / 3, threads);
    case 1: return PointOps<ptt::Bls12_377>::threads(kid / 3, threads);
    case 2: return PointOps<ptt::Bls12_381>::threads(kid / 3, threads);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
