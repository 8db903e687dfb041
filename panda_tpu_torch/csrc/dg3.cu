// Per-column table lookup: out[g, i, c] = tab[g, idx[g, i, c], c] on int32
// (G, R, 128) tensors.
//
// Replaces the TPU kernel dg3 of tools/profile_gather4.py (a probe of
// Mosaic's in-kernel take_along_axis: block (1, R, 128), grid (G,)).  It is
// on no path of the system; the port's gather probe
// (panda_tpu_torch/tools/profile_gather4.py) runs it.
//
// Bound on the H100: the bytes, 3 x 4 bytes a lookup (table, index and
// output each once), 50.3 MB for the probe's 2^22 lookups a launch: 0.0150
// ms at 3.35 TB/s (H100 SXM, 700 W).  The lookups themselves are shared-
// memory reads, far below that.
//
// Design for Hopper: a streaming kernel whose unit of work is a slice of
// about PTT_DG3_SLICE_WORDS lookups.
//   * Slices sized by work, not by R.  At small R a slice holds several
//     whole g (8 at R = 8 with the default 8192 words); at large R a
//     column tile of tc columns of one g (32 at R = 256), at least
//     PTT_DG3_MIN_COLS = 16, so that a row is 64 bytes, a whole DRAM
//     access (at R = 1024 rows of 8 columns, half of one, ran 1.36x
//     slower: tools/occupancy_sweep.py).
//   * A persistent grid.  The launcher takes the threads resident at once
//     (ptt_dg3_threads, from the occupancy calculator at this R's shared
//     memory) and launches the fewest blocks that still give every block
//     the same number of slices, so no block runs a partial last wave.
//   * A cp.async ring.  Each block walks its slices with a grid stride;
//     PTT_DG3_RING stages deep (or one stage, where two do not fit the
//     shared memory: R = 1024's 128 KB slices), each stage holds a slice's
//     table and index words, copied with 16-byte cp.async.cg, so the next
//     slice's copies are in flight while the current one is looked up.
//   * 16-byte accesses.  A thread copies, looks up and stores 4 adjacent
//     columns: its table and index copies, its index read from the stage
//     and its output store are one 16-byte access each.  Its 4 table reads
//     are 4-byte shared-memory reads at random rows (lanes 8 apart share a
//     bank: 4-way conflicts, ~4 shared wavefronts for 32 lookups, far
//     below the bytes' time).
//   * An index outside [0, R) reads nothing and gives 0 (take_along_axis
//     leaves it undefined).
// The per-thread bodies (dg3_fetch, dg3_lookup) are plain functions, so the
// host runs a block's phases thread by thread with a cp.async whose copies
// land only when a wait releases them (tests/test_torch_csrc.py).

#include "field.cuh"

#ifndef PTT_DG3_SLICE_WORDS
#define PTT_DG3_SLICE_WORDS 8192
#endif
#ifndef PTT_DG3_MIN_COLS
#define PTT_DG3_MIN_COLS 16
#endif
#ifndef PTT_DG3_RING
#define PTT_DG3_RING 2
#endif

namespace ptt {

constexpr int kDg3Cols = 128;    // columns of a (G, R, 128) tensor
constexpr int kDg3MinCols = PTT_DG3_MIN_COLS;   // the narrowest tile
constexpr int kDg3Threads = 256;
constexpr int kDg3SliceWords = PTT_DG3_SLICE_WORDS;
constexpr int kDg3Ring = PTT_DG3_RING;

// How a launch cuts (G, R, 128) into slices: gs whole g of tc columns
// (gs > 1 only when tc = 128), tiles column tiles a g; ring stages of a
// slice's table and index words, kDg3Ring or, where those do not fit in
// smem_max bytes of shared memory, 1.
struct dg3_geom {
  int tc, gs;
  int64_t tiles, slices;
  int stage_words;   // words of one array (table or index) in a stage
  int ring;
};

PT_HD dg3_geom dg3_geometry(int64_t G, int R, int slice_words,
                            int64_t smem_max) {
  dg3_geom g;
  g.tc = kDg3Cols;
  g.gs = 1;
  if ((int64_t)R * kDg3Cols <= slice_words) {
    g.gs = slice_words / (R * kDg3Cols);
    if (g.gs > G) g.gs = (int)G;
  } else {
    while (g.tc > kDg3MinCols && (int64_t)R * g.tc > slice_words) g.tc >>= 1;
  }
  g.tiles = kDg3Cols / g.tc;
  g.slices = (G + g.gs - 1) / g.gs * g.tiles;
  g.stage_words = g.gs * R * g.tc;
  g.ring = (int64_t)kDg3Ring * 2 * g.stage_words * 4 <= smem_max ? kDg3Ring
                                                                 : 1;
  return g;
}

// Dynamic shared memory of a launch: the ring's stages, table then index.
PT_HD int64_t dg3_smem(const dg3_geom& geo) {
  return (int64_t)geo.ring * 2 * geo.stage_words * 4;
}

// Slice s: its first g, its g count and its first column.
struct dg3_slice {
  int64_t g0;
  int ng, c0;
};

PT_HD dg3_slice dg3_slice_at(const dg3_geom& geo, int64_t G, int64_t s) {
  dg3_slice sl;
  sl.g0 = s / geo.tiles * geo.gs;
  sl.ng = G - sl.g0 < geo.gs ? (int)(G - sl.g0) : geo.gs;
  sl.c0 = (int)(s % geo.tiles) * geo.tc;
  return sl;
}

// Word offset in the (G, R, 128) tensors of 4-column vector v of a slice
// (v counts along the tile's columns, then its rows, then its g).
PT_HD int64_t dg3_offset(const dg3_geom& geo, const dg3_slice& sl, int R,
                         int v) {
  const int vr = geo.tc / 4;
  const int cv = v % vr, rest = v / vr;
  const int i = rest % R, gg = rest / R;
  return ((sl.g0 + gg) * R + i) * kDg3Cols + sl.c0 + 4 * cv;
}

// Thread t of T: its copies of slice sl's table and index words into one
// ring stage (tab_st, idx_st: stage_words words each, the slice's vectors
// in order).
template <class Copy>
PT_FN void dg3_fetch(const int32_t* tab, const int32_t* idx,
                     uint32_t* tab_st, uint32_t* idx_st, const dg3_geom& geo,
                     const dg3_slice& sl, int R, int t, int T, Copy& cp) {
  const int nv = sl.ng * R * geo.tc / 4;
  for (int v = t; v < nv; v += T) {
    const int64_t at = dg3_offset(geo, sl, R, v);
    cp.copy16(tab_st + 4 * v, (const uint32_t*)tab + at);
    cp.copy16(idx_st + 4 * v, (const uint32_t*)idx + at);
  }
}

// Thread t of T: the lookups of its vectors of slice sl from a landed
// stage, each stored as 4 adjacent columns of out.
PT_FN void dg3_lookup(const uint32_t* tab_st, const uint32_t* idx_st,
                      int32_t* out, const dg3_geom& geo, const dg3_slice& sl,
                      int R, int t, int T) {
  const int nv = sl.ng * R * geo.tc / 4, vr = geo.tc / 4;
  for (int v = t; v < nv; v += T) {
    const int cv = v % vr, gg = v / vr / R;
    const uint32_t* row0 = tab_st + (int64_t)gg * R * geo.tc + 4 * cv;
    int32_t r[4];
#if defined(__CUDACC__)
    const int4 k4 = *reinterpret_cast<const int4*>(idx_st + 4 * v);
    const int k[4] = {k4.x, k4.y, k4.z, k4.w};
#else
    const int32_t* k = reinterpret_cast<const int32_t*>(idx_st + 4 * v);
#endif
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = (unsigned)k[j] < (unsigned)R
                 ? (int32_t)row0[(int64_t)k[j] * geo.tc + j] : 0;
    int32_t* dst = out + dg3_offset(geo, sl, R, v);
#if defined(__CUDACC__)
    *reinterpret_cast<int4*>(dst) = make_int4(r[0], r[1], r[2], r[3]);
#else
    for (int j = 0; j < 4; ++j) dst[j] = r[j];
#endif
  }
}

#if !defined(__CUDACC__)
// Block b of `blocks` on the host with a ring of Ring stages: its
// prologue, then each slice's copies, wait and lookups, every phase thread
// by thread (each thread with its own cp.async), as the kernel runs them
// between barriers.  The ring starts as 0xA5 filler.
template <int Ring>
void dg3_block_host(const int32_t* tab, const int32_t* idx, int32_t* out,
                    int64_t G, int R, const dg3_geom& geo, int64_t b,
                    int64_t blocks, int T) {
  std::vector<uint32_t> ring((size_t)Ring * 2 * geo.stage_words,
                             0xA5A5A5A5u);
  std::vector<RingCopy> cps(T);
  auto stage = [&](int slot) {
    return ring.data() + 2 * slot * (int64_t)geo.stage_words;
  };
  auto fetch = [&](int64_t s, int slot) {
    for (int t = 0; t < T; ++t) {
      if (s < geo.slices)
        dg3_fetch(tab, idx, stage(slot), stage(slot) + geo.stage_words, geo,
                  dg3_slice_at(geo, G, s), R, t, T, cps[t]);
      cps[t].commit();
    }
  };
  for (int p = 0; p < Ring - 1; ++p) fetch(b + p * blocks, p);
  int slot = 0;
  for (int64_t s = b; s < geo.slices; s += blocks) {
    fetch(s + (Ring - 1) * blocks, (slot + Ring - 1) % Ring);
    for (int t = 0; t < T; ++t) cps[t].wait<Ring - 1>();
    for (int t = 0; t < T; ++t)
      dg3_lookup(stage(slot), stage(slot) + geo.stage_words, out, geo,
                 dg3_slice_at(geo, G, s), R, t, T);
    slot = slot + 1 == Ring ? 0 : slot + 1;
  }
}
#endif

}  // namespace ptt

#if defined(__CUDACC__)

template <int Ring>
__global__ void __launch_bounds__(ptt::kDg3Threads)
    dg3_kernel(const int32_t* tab, const int32_t* idx, int32_t* out,
               int64_t G, int R, ptt::dg3_geom geo) {
  extern __shared__ __align__(16) uint32_t ring[];
  const int t = threadIdx.x, T = blockDim.x;
  const int64_t step = gridDim.x;
  auto stage = [&](int slot) {
    return ring + 2 * slot * (int64_t)geo.stage_words;
  };
  ptt::RingCopy cp;
  for (int p = 0; p < Ring - 1; ++p) {
    const int64_t s = blockIdx.x + p * step;
    if (s < geo.slices)
      ptt::dg3_fetch(tab, idx, stage(p), stage(p) + geo.stage_words, geo,
                     ptt::dg3_slice_at(geo, G, s), R, t, T, cp);
    cp.commit();
  }
  int slot = 0;
  for (int64_t s = blockIdx.x; s < geo.slices; s += step) {
    // the stage refilled here was read in the previous iteration, before
    // its closing barrier
    const int64_t sn = s + (Ring - 1) * step;
    const int nslot = (slot + Ring - 1) % Ring;
    if (sn < geo.slices)
      ptt::dg3_fetch(tab, idx, stage(nslot), stage(nslot) + geo.stage_words,
                     geo, ptt::dg3_slice_at(geo, G, sn), R, t, T, cp);
    cp.commit();
    cp.wait<Ring - 1>();
    __syncthreads();
    ptt::dg3_lookup(stage(slot), stage(slot) + geo.stage_words, out, geo,
                    ptt::dg3_slice_at(geo, G, s), R, t, T);
    __syncthreads();
    slot = slot + 1 == Ring ? 0 : slot + 1;
  }
}

// The launch's geometry on the current device (its shared memory a block).
static cudaError_t dg3_plan(int64_t G, int R, ptt::dg3_geom* geo) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *geo = ptt::dg3_geometry(G, R, ptt::kDg3SliceWords, smem_max);
  return e;
}

// `resident`: ptt_dg3_threads(R, ...) on this device.  The tensors must be
// 16-byte aligned.
extern "C" int ptt_dg3(const int32_t* tab, const int32_t* idx, int32_t* out,
                       int64_t G, int R, int resident, void* stream) {
  if (R < 1 || G < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(tab) | reinterpret_cast<uintptr_t>(idx) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  ptt::dg3_geom geo;
  cudaError_t e = dg3_plan(G, R, &geo);
  if (e != cudaSuccess) return (int)e;
  const auto kernel = geo.ring == 1 ? dg3_kernel<1>
                                    : dg3_kernel<ptt::kDg3Ring>;
  const size_t smem = (size_t)ptt::dg3_smem(geo);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks =
      ptt::even_blocks(geo.slices, resident, ptt::kDg3Threads);
  kernel<<<(unsigned)blocks, ptt::kDg3Threads, smem,
           (cudaStream_t)stream>>>(tab, idx, out, G, R, geo);
  return (int)cudaGetLastError();
}

// Threads of one full wave of the kernel at depth R (its ring and shared
// memory at a G of whole slices) on the current device.
extern "C" int ptt_dg3_threads(int R, int* threads) {
  ptt::dg3_geom geo;
  const cudaError_t e = dg3_plan(1 << 30, R, &geo);
  if (e != cudaSuccess) return (int)e;
  return ptt_resident(geo.ring == 1 ? dg3_kernel<1>
                                    : dg3_kernel<ptt::kDg3Ring>,
                      ptt::kDg3Threads, (size_t)ptt::dg3_smem(geo), threads);
}

// The launch's geometry for logging: {columns a slice, g a slice, slices,
// blocks, threads a block, ring stages}.
extern "C" int ptt_dg3_geometry(int64_t G, int R, int resident,
                                int64_t* out6) {
  ptt::dg3_geom geo;
  const cudaError_t e = dg3_plan(G, R, &geo);
  out6[0] = geo.tc;
  out6[1] = geo.gs;
  out6[2] = geo.slices;
  out6[3] = ptt::even_blocks(geo.slices, resident, ptt::kDg3Threads);
  out6[4] = ptt::kDg3Threads;
  out6[5] = geo.ring;
  return (int)e;
}

#endif
