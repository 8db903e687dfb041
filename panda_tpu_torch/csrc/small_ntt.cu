// Batched radix-2 NTT of length K = 2^log_k (2 <= K <= 256) along axis 1 of
// (8, K, nb) words, natural order in and out, over BN254 Fr, BLS12-377 Fr or
// BLS12-381 Fr (a template parameter; the launcher takes a field id).
//
// Replaces the TPU kernel panda_tpu/ops/ntt_pallas.py::small_ntt_batch (the
// radix-2 engine's pass, PANDA_NTT_IMPL=pallas).  For each column c:
//
//   load:   v_j = x(j, c), brought to [0, p) first with reduce_in (any word
//           below 2^256 is a valid input), then times pre[j, c / batch] when
//           a pre-twiddle table (8, K, B) is given (nb = B * batch: the
//           four-step inter-level twiddle w^(j1 k2), fused at load); the
//           value goes to slot bitrev(j), so the bit reversal costs no pass
//           of its own and the table is read in natural order;
//   stages: log_k decimation-in-time stages; stage s pairs slots j and
//           j + 2^s and multiplies the second by the stage twiddle
//           tw[2^s - 1 + t] (stage_twiddle_rows' (8, K) layout), t = j mod
//           2^s; stage 0's twiddle is 1 and is skipped;
//   store:  out[k, c] in natural order, times the scale (the inverse's
//           n^-1) when one is given, canonical with canonical_out.
//
// The input layout: x(j, c) is word (c / run) K run + j run + c mod run of
// each word plane.  run = nb is the natural (8, K, nb) layout; run = batch
// reads a four-step level's inner output (8, B, A, batch) where it lies
// (element (j1, k2, b) at (k2 A + j1) batch + b), so the recursion makes no
// transpose between passes (ops/ntt_pallas.py).
//
// Every value stays in [0, 2p): mont_mul of values < 2p is < 2p and
// add_mod / sub_mod end with one conditional 2p.  For BLS12-381 Fr (a canon
// field, field.cuh) every value stays in [0, p): the input below p (or
// reduced at load), the tables canonical.
//
// Bound on the H100: the (log_k - 1) K / 2 twiddle products per column,
// plus K for the pre-twiddle and K for the scale when given, at 264 32-bit
// multiply-adds each (CIOS), against 64 bytes per element in and out plus
// the pre table: at K = 256, nb = 2^12 with a pre table ~0.075 ms of
// multiply-adds against ~0.029 ms of bytes (16.7 T/s and 3.35 TB/s, H100
// SXM, 700 W), so operations bound it.
//
// Design for Hopper:
//   * The product.  Every multiply is field.cuh's mont_mul_wide, mont_mul's
//     product bit for bit with each word product's halves adjacent in one
//     carry chain, which ptxas issues as one IMAD.WIDE.U32.X: about 230
//     instructions a product where mont_mul's separate lo and hi chains
//     take about 600 (tools/mul_rate.py measures both on the card).
//   * Butterflies in registers.  A thread owns r = PTT_SMALL_NTT_R (8)
//     elements of one column and runs log2 r stages on them between
//     shared-memory exchanges: round d takes stages [d q, d q + q'), q =
//     log2 r, the last round the residue q' of an odd log_k; in a round
//     the thread holds r / 2^q' groups of 2^q' slots (the slots' bits
//     [d q, d q + q') are the member, the others its group's), so every
//     butterfly of the round is in its registers, r / 2 independent CIOS
//     multiplies a stage.  A pass makes ceil(log_k / q) rounds, each
//     behind one barrier (3 at K = 256).  The first round reads the staged
//     tile, the others the previous round's slots, the last stores from
//     registers.  The default r = 8 at launch bounds 256 x 2 (128
//     registers) beat r = 4 at 256 x 4 at K = 256 and tied at K = 64 and
//     128 (tools/occupancy_sweep.py).
//   * Shared memory.  A tile of TC = T r / K columns (8 at K = 256, 32 at
//     K = 64, T = PTT_SMALL_NTT_THREADS threads) holds each element as two
//     16-byte halves, a column's element at column slot tc ^ swz(row) and
//     the halves swapped on bit 2 of that slot: eight consecutive columns
//     of one row, or eight consecutive rows' bit reversals of one column
//     (the top level's column-major load), fall in eight distinct 16-byte
//     bank groups, so every 16-byte access of a quarter warp is
//     conflict-free.  The stage twiddles (K values) sit in shared memory
//     for the block, and the tile's pre-twiddle column beside them when all
//     its columns share one.
//   * Loads.  A block loads its tile in the order of the input's own
//     contiguous runs (TC runs of K words of a column at run = 1, rows of
//     TC columns otherwise), one word plane a load, so the loads stay
//     coalesced in both layouts; the stores are rows of TC columns.
//   * Whole waves.  The launcher takes the threads resident at once
//     (ptt_small_ntt_threads, the occupancy calculator at the pass's shared
//     memory and the build's registers) and launches the fewest blocks
//     that give every block the same number of tiles, each looping over
//     its tiles.
// The per-thread bodies (small_ntt_stage_tw, small_ntt_load,
// small_ntt_round) are plain functions: the host runs a block's phases
// thread by thread (tests/test_torch_csrc.py).

#include "field.cuh"

#ifndef PTT_SMALL_NTT_R
#define PTT_SMALL_NTT_R 8
#endif
#ifndef PTT_SMALL_NTT_THREADS
#define PTT_SMALL_NTT_THREADS 256
#endif
#ifndef PTT_SMALL_NTT_BLOCKS
#define PTT_SMALL_NTT_BLOCKS 2
#endif

namespace ptt {

constexpr int kNttR = PTT_SMALL_NTT_R;   // elements a thread owns
constexpr int kNttThreads = PTT_SMALL_NTT_THREADS;

PT_FN int bitrev(int j, int log_k) {
#if defined(__CUDACC__)
  return (int)(__brev((unsigned)j) >> (32 - log_k));
#else
  int r = 0;
  for (int b = 0; b < log_k; ++b) r |= ((j >> b) & 1) << (log_k - 1 - b);
  return r;
#endif
}

// The elements a thread owns in a pass of 2^log_k: the build's r, or 2 for
// a K below it.
PT_HD int small_ntt_r(int log_k) {
  return (1 << log_k) >= kNttR ? kNttR : 2;
}

// A pass's arguments.  x, pre, out are (8, ...) word planes; x(j, c) is
// word (c / run) K run + j run + c mod run of a plane (run = nb: natural).
struct small_ntt_args {
  const uint32_t *x, *tw, *pre, *scale;
  uint32_t* out;
  int64_t nb, run, pre_cols, batch;   // batch = nb / pre_cols
  int log_k, reduce_in, canonical_out;
};

// A pass's geometry for r elements a thread and blocks of T threads.
struct small_ntt_geom {
  int q;          // log2 r: the stages of a full round
  int rounds;     // ceil(log_k / q)
  int tc;         // columns a tile: T r / K
  int64_t tiles;  // ceil(nb / tc)
};

PT_HD small_ntt_geom small_ntt_geometry(int log_k, int64_t nb, int r, int T) {
  small_ntt_geom g;
  g.q = 0;
  while ((1 << g.q) < r) ++g.q;
  if (g.q > log_k) g.q = log_k;
  g.rounds = (log_k + g.q - 1) / g.q;
  g.tc = (T * r) >> log_k;
  g.tiles = (nb + g.tc - 1) / g.tc;
  return g;
}

// Words of a block's shared memory: the tile (K TC = T r elements), the
// stage twiddles and the pre-twiddle column (K elements each).
PT_HD int64_t small_ntt_smem_words(int log_k, int r, int T) {
  return ((int64_t)T * r + 2 * (1 << log_k)) * 8;
}

// Word offset of half hf (words 4 hf .. 4 hf + 3) of element (row, tc) in a
// tile of TC columns: the column slot is tc ^ swz(row) and the halves swap
// on its bit 2, so eight consecutive columns of a row and eight rows whose
// bit reversals are consecutive reach eight distinct 16-byte bank groups.
PT_HD int small_ntt_swz(int row) { return (row ^ (row >> 3) ^ (row >> 6)) & 7; }

PT_HD int small_ntt_at(int row, int tc, int TC, int hf) {
  const int sc = tc ^ (small_ntt_swz(row) & (TC - 1));
  return 4 * (2 * (row * TC + sc) + (hf ^ ((sc >> 2) & 1)));
}

// Two 16-byte halves at word offsets a0, a1 of shared memory.
PT_FN fe smem_get(const uint32_t* s, int a0, int a1) {
  fe v;
#if defined(__CUDACC__)
  const uint4 lo = *reinterpret_cast<const uint4*>(s + a0);
  const uint4 hi = *reinterpret_cast<const uint4*>(s + a1);
  v.w[0] = lo.x, v.w[1] = lo.y, v.w[2] = lo.z, v.w[3] = lo.w;
  v.w[4] = hi.x, v.w[5] = hi.y, v.w[6] = hi.z, v.w[7] = hi.w;
#else
  for (int i = 0; i < 4; ++i) v.w[i] = s[a0 + i], v.w[4 + i] = s[a1 + i];
#endif
  return v;
}

PT_FN void smem_put(uint32_t* s, int a0, int a1, const fe& v) {
#if defined(__CUDACC__)
  *reinterpret_cast<uint4*>(s + a0) = make_uint4(v.w[0], v.w[1], v.w[2],
                                                 v.w[3]);
  *reinterpret_cast<uint4*>(s + a1) = make_uint4(v.w[4], v.w[5], v.w[6],
                                                 v.w[7]);
#else
  for (int i = 0; i < 4; ++i) s[a0 + i] = v.w[i], s[a1 + i] = v.w[4 + i];
#endif
}

// Does every column of the tile at c0 share one pre-twiddle column?
PT_HD bool small_ntt_pre_col(const small_ntt_args& a, const small_ntt_geom& g,
                             int64_t c0) {
  const int64_t last = (c0 + g.tc < a.nb ? c0 + g.tc : a.nb) - 1;
  return a.pre && c0 / a.batch == last / a.batch;
}

// Thread t of T: the stage twiddles (8, K) into shared memory, element k
// at words 8k .. 8k + 7.
PT_FN void small_ntt_stage_tw(const small_ntt_args& a, uint32_t* tws, int t,
                              int T) {
  const int K = 1 << a.log_k;
  for (int k = t; k < K; k += T)
    smem_put(tws, 8 * k, 8 * k + 4, load_fe(a.tw, k, K));
}

// Thread t of T: its RR elements of the tile at column c0, read in the
// order of the input's contiguous runs (a run of min(run, TC) columns of
// one row, then the rows, then the next run), each to the tile at slot
// bitrev(j); columns past nb are zeros.  With pre_col, also the tile's
// pre-twiddle column (K elements).
template <int RR>
PT_FN void small_ntt_load(const small_ntt_args& a, const small_ntt_geom& g,
                          uint32_t* tile, uint32_t* pres, int64_t c0,
                          bool pre_col, int t, int T) {
  const int K = 1 << a.log_k, TC = g.tc;
  const int64_t plane = (int64_t)K * a.nb;
  const int tcr = a.run < TC ? (int)a.run : TC;
  fe v[RR];
  int row[RR], col[RR];
#pragma unroll
  for (int m = 0; m < RR; ++m) {
    const int e = t + T * m;
    const int bb = e % tcr, j = e / tcr % K;
    col[m] = e / tcr / K * tcr + bb;
    row[m] = bitrev(j, a.log_k);
    const int64_t c = c0 + col[m];
    v[m] = col[m] < TC && c < a.nb
               ? load_fe(a.x + c / a.run * K * a.run + j * a.run + c % a.run,
                         0, plane)
               : fe_zero();
  }
#pragma unroll
  for (int m = 0; m < RR; ++m)
    if (col[m] < TC)
      smem_put(tile, small_ntt_at(row[m], col[m], TC, 0),
               small_ntt_at(row[m], col[m], TC, 1), v[m]);
  if (pre_col)
    for (int j = t; j < K; j += T)
      smem_put(pres, 8 * j, 8 * j + 4,
               load_fe(a.pre + (int64_t)j * a.pre_cols, c0 / a.batch,
                       (int64_t)K * a.pre_cols));
}

// Thread t's part of round rd of the tile at column c0 (thread t owns
// column tc = t mod TC and group h = t / TC of it): read its RR slots from
// the tile (round 0: reduce and pre-twiddle them), run the round's stages
// in registers, then write the slots back, or (the last round) store them
// as outputs k = slot, scaled and canonical as asked.
template <class F, int RR>
PT_FN void small_ntt_round(const small_ntt_args& a, const small_ntt_geom& g,
                           uint32_t* tile, const uint32_t* tws,
                           const uint32_t* pres, int64_t c0, bool pre_col,
                           int rd, int t) {
  constexpr int Q = RR == 2 ? 1 : RR == 4 ? 2 : RR == 8 ? 3 : 4;
  const int K = 1 << a.log_k, TC = g.tc;
  const int h = t / TC, tc = t % TC;
  const int64_t c = c0 + tc;
  const int s0 = rd * Q;
  const int qq = a.log_k - s0 < Q ? a.log_k - s0 : Q;
  int slot[RR];
  fe v[RR];
#pragma unroll
  for (int m = 0; m < RR; ++m) {
    const int o = h * (RR >> qq) + (m >> qq);
    const int member = m & ((1 << qq) - 1);
    slot[m] = ((o >> s0) << (s0 + qq)) | (member << s0) |
              (o & ((1 << s0) - 1));
    v[m] = smem_get(tile, small_ntt_at(slot[m], tc, TC, 0),
                    small_ntt_at(slot[m], tc, TC, 1));
  }
  if (rd == 0) {
#pragma unroll
    for (int m = 0; m < RR; ++m) {
      if (a.reduce_in) v[m] = reduce_wide<F>(v[m]);
      if (a.pre) {
        const int j = bitrev(slot[m], a.log_k);
        const fe p = pre_col ? smem_get(pres, 8 * j, 8 * j + 4)
                     : c < a.nb ? load_fe(a.pre + (int64_t)j * a.pre_cols,
                                          c / a.batch,
                                          (int64_t)K * a.pre_cols)
                                : fe_zero();
        v[m] = mont_mul_wide<F>(v[m], p);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    if (u >= qq) break;
    const int s = s0 + u;
#pragma unroll
    for (int m = 0; m < RR; ++m) {
      if ((m >> u) & 1) continue;
      const int mp = m | (1 << u);
      fe y = v[mp];
      if (s) {
        const int k = (1 << s) - 1 + (slot[m] & ((1 << s) - 1));
        y = mont_mul_wide<F>(y, smem_get(tws, 8 * k, 8 * k + 4));
      }
      const fe x = v[m];
      v[m] = add_mod<F>(x, y);
      v[mp] = sub_mod<F>(x, y);
    }
  }
  if (rd + 1 < g.rounds) {
#pragma unroll
    for (int m = 0; m < RR; ++m)
      smem_put(tile, small_ntt_at(slot[m], tc, TC, 0),
               small_ntt_at(slot[m], tc, TC, 1), v[m]);
    return;
  }
  if (c >= a.nb) return;
  const fe sc = a.scale ? load_fe(a.scale, 0, 1) : fe_zero();
#pragma unroll
  for (int m = 0; m < RR; ++m) {
    fe o = v[m];
    if (a.scale) o = mont_mul_wide<F>(o, sc);
    if (a.canonical_out) o = cond_sub_p<F>(o);
    store_fe(a.out + (int64_t)slot[m] * a.nb, c, (int64_t)K * a.nb, o);
  }
}

#if !defined(__CUDACC__)
// Block b of `blocks` on the host: the twiddles, then each of its tiles'
// load and rounds, every phase thread by thread, as the kernel runs them
// between barriers.  The tile starts as 0xA5 filler.
template <class F, int RR>
void small_ntt_block_host(const small_ntt_args& a, int64_t b, int64_t blocks,
                          int T) {
  const small_ntt_geom g = small_ntt_geometry(a.log_k, a.nb, RR, T);
  const int K = 1 << a.log_k;
  std::vector<uint32_t> sm(small_ntt_smem_words(a.log_k, RR, T),
                           0xA5A5A5A5u);
  uint32_t* tile = sm.data();
  uint32_t* tws = tile + (int64_t)K * g.tc * 8;
  uint32_t* pres = tws + K * 8;
  for (int t = 0; t < T; ++t) small_ntt_stage_tw(a, tws, t, T);
  for (int64_t tl = b; tl < g.tiles; tl += blocks) {
    const int64_t c0 = tl * g.tc;
    const bool pre_col = small_ntt_pre_col(a, g, c0);
    for (int t = 0; t < T; ++t)
      small_ntt_load<RR>(a, g, tile, pres, c0, pre_col, t, T);
    for (int rd = 0; rd < g.rounds; ++rd)
      for (int t = 0; t < T; ++t)
        small_ntt_round<F, RR>(a, g, tile, tws, pres, c0, pre_col, rd, t);
  }
}
#endif

}  // namespace ptt

#if defined(__CUDACC__)

template <class F, int RR>
__global__ void __launch_bounds__(ptt::kNttThreads, PTT_SMALL_NTT_BLOCKS)
    small_ntt_kernel(ptt::small_ntt_args a, ptt::small_ntt_geom g) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int K = 1 << a.log_k, t = threadIdx.x, T = blockDim.x;
  uint32_t* tile = sm;
  uint32_t* tws = tile + (int64_t)K * g.tc * 8;
  uint32_t* pres = tws + K * 8;
  ptt::small_ntt_stage_tw(a, tws, t, T);
  for (int64_t tl = blockIdx.x; tl < g.tiles; tl += gridDim.x) {
    const int64_t c0 = tl * g.tc;
    const bool pre_col = ptt::small_ntt_pre_col(a, g, c0);
    ptt::small_ntt_load<RR>(a, g, tile, pres, c0, pre_col, t, T);
    __syncthreads();
    for (int rd = 0; rd < g.rounds; ++rd) {
      ptt::small_ntt_round<F, RR>(a, g, tile, tws, pres, c0, pre_col, rd,
                                  t);
      __syncthreads();   // the last one frees the tile for the next load
    }
  }
}

template <class F, int RR>
int small_ntt_run(const ptt::small_ntt_args& a, int resident,
                  cudaStream_t stream) {
  const ptt::small_ntt_geom g =
      ptt::small_ntt_geometry(a.log_k, a.nb, RR, ptt::kNttThreads);
  const size_t smem = (size_t)ptt::small_ntt_smem_words(a.log_k, RR,
                                                        ptt::kNttThreads) *
                      sizeof(uint32_t);
  const cudaError_t e = cudaFuncSetAttribute(
      small_ntt_kernel<F, RR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = ptt::even_blocks(g.tiles, resident, ptt::kNttThreads);
  small_ntt_kernel<F, RR><<<(unsigned)blocks, ptt::kNttThreads, smem,
                            stream>>>(a, g);
  return (int)cudaGetLastError();
}

template <class F, int RR>
int small_ntt_resident(int log_k, int* threads) {
  return ptt_resident(small_ntt_kernel<F, RR>, ptt::kNttThreads,
                      (size_t)ptt::small_ntt_smem_words(log_k, RR,
                                                        ptt::kNttThreads) *
                          sizeof(uint32_t),
                      threads);
}

// The pass for field F, with the build's r or (K below it) 2.
template <class F>
struct SmallNttField {
  static int run(const ptt::small_ntt_args& a, int resident,
                 cudaStream_t s) {
    return ptt::small_ntt_r(a.log_k) == ptt::kNttR
               ? small_ntt_run<F, ptt::kNttR>(a, resident, s)
               : small_ntt_run<F, 2>(a, resident, s);
  }
  static int threads(int log_k, int* out) {
    return ptt::small_ntt_r(log_k) == ptt::kNttR
               ? small_ntt_resident<F, ptt::kNttR>(log_k, out)
               : small_ntt_resident<F, 2>(log_k, out);
  }
};

// `resident`: ptt_small_ntt_threads(16 field + log_k, ...) on this device.
// run = nb reads x in the natural (8, K, nb) layout.
extern "C" int ptt_small_ntt(const uint32_t* x, const uint32_t* tw,
                             const uint32_t* pre, const uint32_t* scale,
                             uint32_t* out, int64_t nb, int log_k,
                             int64_t run, int64_t pre_cols, int reduce_in,
                             int canonical_out, int field, int resident,
                             void* stream) {
  if (log_k < 1 || log_k > 8 || run < 1 || nb % run)
    return (int)cudaErrorInvalidValue;
  const ptt::small_ntt_args a{x, tw, pre, scale, out, nb, run, pre_cols,
                              pre ? nb / pre_cols : 1, log_k, reduce_in,
                              canonical_out};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return SmallNttField<ptt::Fr254>::run(a, resident, s);
    case 1: return SmallNttField<ptt::Fr377>::run(a, resident, s);
    case 2: return SmallNttField<ptt::Fr381>::run(a, resident, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Threads of one full wave of the field's pass of 2^log_k on the current
// device; kid = 16 field + log_k.
extern "C" int ptt_small_ntt_threads(int kid, int* threads) {
  const int field = kid >> 4, log_k = kid & 15;
  if (log_k < 1 || log_k > 8) return (int)cudaErrorInvalidValue;
  switch (field) {
    case 0: return SmallNttField<ptt::Fr254>::threads(log_k, threads);
    case 1: return SmallNttField<ptt::Fr377>::threads(log_k, threads);
    case 2: return SmallNttField<ptt::Fr381>::threads(log_k, threads);
  }
  return (int)cudaErrorInvalidValue;
}

// A launch's geometry for logging: {r, rounds, columns a tile, tiles,
// blocks, threads a block}.
extern "C" int ptt_small_ntt_geometry(int log_k, int64_t nb, int resident,
                                      int64_t* out6) {
  const int r = ptt::small_ntt_r(log_k);
  const ptt::small_ntt_geom g =
      ptt::small_ntt_geometry(log_k, nb, r, ptt::kNttThreads);
  out6[0] = r;
  out6[1] = g.rounds;
  out6[2] = g.tc;
  out6[3] = g.tiles;
  out6[4] = ptt::even_blocks(g.tiles, resident, ptt::kNttThreads);
  out6[5] = ptt::kNttThreads;
  return 0;
}

#endif
