// Batched length-K NTT (K = 2^0..2^5) along axis 1 of (8, K, nb) words, as
// one product of the batch's bytes against a constant byte matrix on the
// int8 tensor cores, then a regroup and one Montgomery reduction.  The field
// (BN254 Fr, BLS12-377 Fr or BLS12-381 Fr) is a template parameter; the
// launcher takes its id.
//
// Replaces the TPU kernel panda_tpu/ops/ntt_fused.py::dft_apply_fused (an
// int8 digit-plane matmul on the MXU plus a regroup and a fold).  Every
// multiply in a length-K NTT is by a known constant, so the whole transform
// is one linear map over the inputs' digits.  Here the digits are the 32
// bytes d_{j,i} of each input word vector (no conversion: the wire bytes
// are the digits), and the matrix holds the bytes of the constants
//   C(j, k, i) = w^(j k) * scale * R * 2^(8 i) mod p,
// with the Montgomery radix R folded in.  Output k, byte position o:
//   acc_{k,o} = sum_{j,i} d_{j,i} * byte_o(C(j, k, i))   < K * 32 * 255^2,
// which fits int32 for K <= 32; V_k = sum_o acc_{k,o} 2^(8 o) < K*32*255*p
// (at most 9 words for the three fields), and REDC(V_k) = V_k / R =
// scale * sum_j w^(j k) x_j in the port's Montgomery form, in [0, 2p);
// canonical_out adds one cond_sub_p, which BLS12-381 Fr (a canon field,
// whose REDC output is < r + 2^17) always takes, so its outputs are < r.
// The JAX package's fold relies on its R = 2^270 >= 4096 p and cannot land
// under the port's R = 2^256; one REDC of the 9-word value replaces it.
//
// Layouts: x and out are (8, K, nb) words (word w of element j of column c
// at [(w K + j) nb + c]); the matrix is uint8 (K, 8, K, 32, 4) with
// [j, w, k, o, q] = byte o of C(j, k, 4 w + q).
//
// The product as a GEMM: rows (k, o) (M = 32 K), reduction (j, w, q)
// (32 K bytes), columns c (N = nb), as mma.sync.m16n8k32 u8 x u8 -> s32.
// One k32 step is one input element j (its 8 words, 32 bytes).  The layouts
// are the fragments as they stand: an A register holds 4 consecutive
// reduction bytes of one row, which is the packed matrix word
// mat[j, w, k, o, 0..3]; a B register holds 4 consecutive reduction bytes of
// one column, which is the input word x[(w K + j) nb + c].
//
// Bound on the H100: the (32 K)^2 nb byte multiply-adds at the tensor cores'
// int8 rate (1,979 TOP/s, H100 SXM data sheet, 700 W limit) take ~35 us at
// K = 32, nb = 2^15, above the ~20 us that its 64 MB of input and output
// take at 3.35 TB/s.  Design: a block of 8 warps owns KB = min(K, 8) outputs
// k and NC = 64 * 8 / KB columns; warp (kl, cg) owns output k0 + kl (two
// m16 tiles) and 64 columns (eight n8 tiles): 64 s32 accumulators a thread.
// The matrix rows of the block's k and the input words of its columns are
// staged in shared memory with cp.async, JC = min(K, 4) elements a stage,
// double buffered; rows are padded by 8 words so the fragment loads hit 32
// distinct banks.  The epilogue writes the fragments to shared memory and
// one thread per (k, column) regroups its 32 byte sums and reduces them
// (dft_tail).  Not yet done: wgmma with TMA, which the same layout feeds.

#include "field.cuh"

#if !defined(__CUDACC__)
#include <string.h>
#include <vector>
#endif


namespace ptt {

constexpr int kDftWarps = 8;       // warps a block
constexpr int kDftWarpCols = 64;   // columns a warp: eight n8 tiles
constexpr int kDftThreads = 32 * kDftWarps;

// A launch's tiling, from K and nb alone (the kernel and the host emulation
// both derive it).  Strides and sizes in 32-bit words; KB and NC are powers
// of two, and the index math shifts by their logarithms.
struct DftGeom {
  int K, KB, NC, JC, kgroups, stages;
  int a_stride, b_stride, e_stride, a_words, b_words;
  int log_achunks, log_nc;
  int64_t nb, tiles;
};

PT_HD int ilog2(int v) {
  int r = 0;
  while ((1 << (r + 1)) <= v) ++r;
  return r;
}

PT_HD DftGeom dft_geom(int K, int64_t nb) {
  DftGeom g;
  g.K = K;
  g.nb = nb;
  g.KB = K < kDftWarps ? K : kDftWarps;
  g.NC = kDftWarpCols * (kDftWarps / g.KB);
  g.log_achunks = ilog2(8 * g.KB);  // 16-byte chunks of a matrix row
  g.log_nc = ilog2(g.NC);
  g.JC = K < 4 ? K : 4;
  g.kgroups = K / g.KB;
  g.stages = K / g.JC;
  g.a_stride = 32 * g.KB + 8;       // a (j, w) row: KB outputs x 32 words
  g.b_stride = g.NC + 8;            // a (j, w) row: NC columns
  g.e_stride = g.NC + 4;            // an epilogue row (k, o): NC sums
  g.a_words = 8 * g.JC * g.a_stride;
  g.b_words = 8 * g.JC * g.b_stride;
  g.tiles = (nb + g.NC - 1) / g.NC;
  return g;
}

PT_HD int dft_smem_words(const DftGeom& g) {
  const int pipe = 2 * (g.a_words + g.b_words);
  const int epi = 32 * g.KB * g.e_stride;
  return pipe > epi ? pipe : epi;
}

// Copies of up to 4 (copy16) or 1 (copy4) words into shared memory, zero
// past ``words``: cp.async on the card (src-size zero-fills the rest), a
// plain copy on the host.
#if defined(__CUDACC__)
PT_FN void copy16(uint32_t* dst, const uint32_t* src, int words) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(4 * words));
}
PT_FN void copy4(uint32_t* dst, const uint32_t* src, int words) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(4 * words));
}
#else
inline void copy16(uint32_t* dst, const uint32_t* src, int words) {
  for (int i = 0; i < 4; ++i) dst[i] = i < words ? src[i] : 0u;
}
inline void copy4(uint32_t* dst, const uint32_t* src, int words) {
  *dst = words ? *src : 0u;
}
#endif

// Thread ``tid``'s share of stage s's copies: elements j = s JC + jj; the
// matrix rows mat[j, w, k0 .. k0 + KB) to As[(jj 8 + w) a_stride ..], and
// the input words x[(w K + j) nb + c] of the block's columns to
// Bs[(jj 8 + w) b_stride + c - c0], zero past nb.  ``vec4``: nb % 4 == 0
// and x 16-byte aligned, so the columns go in 4-word chunks.
PT_FN void dft_stage(const uint32_t* x, const uint32_t* mat, uint32_t* As,
                     uint32_t* Bs, const DftGeom& g, int k0, int64_t c0,
                     int s, int tid, int nthreads, bool vec4) {
  const int la = g.log_achunks;
  for (int i = tid; i < (8 * g.JC) << la; i += nthreads) {
    const int r = i >> la, ch = i & ((1 << la) - 1);   // r = jj * 8 + w
    const int64_t j = (int64_t)s * g.JC + (r >> 3);
    copy16(As + r * g.a_stride + 4 * ch,
           mat + ((j * 8 + (r & 7)) * g.K + k0) * 32 + 4 * ch, 4);
  }
  const int per = vec4 ? 4 : 1;
  const int lb = g.log_nc - (vec4 ? 2 : 0);        // chunks of a row
  for (int i = tid; i < (8 * g.JC) << lb; i += nthreads) {
    const int r = i >> lb, cl = per * (i & ((1 << lb) - 1));
    const int64_t j = (int64_t)s * g.JC + (r >> 3);
    const int64_t c = c0 + cl;
    const int64_t left = g.nb - c;
    const int words = left <= 0 ? 0 : left < per ? (int)left : per;
    const uint32_t* src = x + ((r & 7) * g.K + j) * g.nb + (words ? c : 0);
    if (vec4)
      copy16(Bs + r * g.b_stride + cl, src, words);
    else
      copy4(Bs + r * g.b_stride + cl, src, words);
  }
}

// Lane ``lane`` of warp (kl, cg): its A fragments of output k0 + kl (m16
// tiles o = 0..15, 16..31) and its B fragments of columns cg 64 + 8 nt
// (nt = 0..7) for element jj of the stage.  With gid = lane / 4 and
// t = lane % 4: A register 0 is row gid, reduction word t; 1 row gid + 8,
// word t; 2 row gid, word t + 4; 3 row gid + 8, word t + 4.  B register 0
// is word t of column gid, 1 word t + 4.
PT_FN void dft_frags(const uint32_t* As, const uint32_t* Bs,
                     const DftGeom& g, int jj, int kl, int cg, int lane,
                     uint32_t (&a)[2][4], uint32_t (&b)[8][2]) {
  const int gid = lane >> 2, t = lane & 3;
  const uint32_t* ar = As + (jj * 8 + t) * g.a_stride + kl * 32 + gid;
  const int a4 = 4 * g.a_stride;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    a[mt][0] = ar[16 * mt];
    a[mt][1] = ar[16 * mt + 8];
    a[mt][2] = ar[a4 + 16 * mt];
    a[mt][3] = ar[a4 + 16 * mt + 8];
  }
  const uint32_t* br =
      Bs + (jj * 8 + t) * g.b_stride + cg * kDftWarpCols + gid;
  const int b4 = 4 * g.b_stride;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    b[nt][0] = br[8 * nt];
    b[nt][1] = br[b4 + 8 * nt];
  }
}

// The accumulators of lane ``lane`` of warp (kl, cg) to the epilogue tile
// E[(kl 32 + o) e_stride + column]: register i of tile (mt, nt) is row
// o = 16 mt + gid + 8 (i / 2), column cg 64 + 8 nt + 2 t + i % 2.
PT_FN void dft_store_acc(uint32_t* E, const DftGeom& g, int kl, int cg,
                         int lane, const int32_t (&acc)[2][8][4]) {
  const int gid = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = kl * 32 + 16 * mt + gid + 8 * (i >> 1);
        const int col = cg * kDftWarpCols + 8 * nt + 2 * t + (i & 1);
        E[row * g.e_stride + col] = (uint32_t)acc[mt][nt][i];
      }
}

// One output: its 32 byte-position sums acc[o * stride] (each < 2^31)
// regrouped into the 9-word V, reduced, optionally made canonical (always
// for a canon field, whose values stay below p).
template <class F>
PT_FN fe dft_tail(const uint32_t* acc, int stride, int canonical_out) {
  uint32_t t[9];
  uint64_t carry = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint64_t s = carry + acc[(4 * w) * stride] +
                       ((uint64_t)acc[(4 * w + 1) * stride] << 8) +
                       ((uint64_t)acc[(4 * w + 2) * stride] << 16) +
                       ((uint64_t)acc[(4 * w + 3) * stride] << 24);
    t[w] = (uint32_t)s;
    carry = s >> 32;
  }
  t[8] = (uint32_t)carry;
  fe r = redc9<F>(t);
  if (F::canon || canonical_out) r = cond_sub_p<F>(r);
  return r;
}

// Output k0 + kl of the block's column cl, from the epilogue tile.
template <class F>
PT_FN void dft_out_elem(const uint32_t* E, uint32_t* out, const DftGeom& g,
                        int kl, int cl, int k0, int64_t c0,
                        int canonical_out) {
  const int64_t c = c0 + cl;
  if (c >= g.nb) return;
  const fe v = dft_tail<F>(E + kl * 32 * g.e_stride + cl, g.e_stride,
                           canonical_out);
  store_fe(out + (int64_t)(k0 + kl) * g.nb, c, (int64_t)g.K * g.nb, v);
}

#if !defined(__CUDACC__)
// mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 for one warp, element by
// element from the PTX ISA's fragment tables for m16n8k32 with .u8
// operands.  lane = 4 groupID + threadID_in_group; register r of a lane
// holds elements 4 r .. 4 r + 3, the lowest-numbered in the low byte.
//   A (16 x 32, row): a_i, i = 0..15: row groupID for i < 4 or 8 <= i < 12,
//     else groupID + 8; column threadID_in_group * 4 + (i & 3), + 16 for
//     i >= 8.
//   B (32 x 8, col): b_i, i = 0..7: row threadID_in_group * 4 + (i & 3),
//     + 16 for i >= 4; column groupID.
//   C, D (16 x 8, s32): c_i, i = 0..3: row groupID for i < 2, else
//     groupID + 8; column threadID_in_group * 2 + (i & 1).
inline void mma_u8_warp(const uint32_t (&a)[32][4], const uint32_t (&b)[32][2],
                        int32_t (&d)[32][4]) {
  uint32_t A[16][32], B[32][8];
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, t = lane & 3;
    for (int i = 0; i < 16; ++i) {
      const int row = (i < 4 || (i >= 8 && i < 12)) ? g : g + 8;
      const int col = t * 4 + (i & 3) + (i >= 8 ? 16 : 0);
      A[row][col] = (a[lane][i / 4] >> (8 * (i % 4))) & 255u;
    }
    for (int i = 0; i < 8; ++i) {
      const int row = t * 4 + (i & 3) + (i >= 4 ? 16 : 0);
      B[row][g] = (b[lane][i / 4] >> (8 * (i % 4))) & 255u;
    }
  }
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, t = lane & 3;
    for (int i = 0; i < 4; ++i) {
      const int row = i < 2 ? g : g + 8, col = t * 2 + (i & 1);
      uint32_t s = (uint32_t)d[lane][i];
      for (int k = 0; k < 32; ++k) s += A[row][k] * B[k][col];
      d[lane][i] = (int32_t)s;
    }
  }
}

// The kernel's block loop on the host, statement for statement: the same
// stage copies (every thread's share, in the same double-buffered order),
// fragment loads, products (mma_u8_warp for each warp), accumulator stores
// and epilogue.
template <class F>
void dft_host(const uint32_t* x, const uint32_t* mat, uint32_t* out,
              int64_t nb, int K, int canonical_out) {
  const DftGeom g = dft_geom(K, nb);
  const bool vec4 = nb % 4 == 0;
  std::vector<uint32_t> smem(dft_smem_words(g));
  std::vector<int32_t> accs(kDftWarps * 32 * 2 * 8 * 4);
  typedef int32_t Acc[32][2][8][4];
  Acc* acc = reinterpret_cast<Acc*>(accs.data());
  for (int64_t blk = 0; blk < g.tiles * g.kgroups; ++blk) {
    const int k0 = (int)(blk % g.kgroups) * g.KB;
    const int64_t c0 = blk / g.kgroups * g.NC;
    memset(accs.data(), 0, accs.size() * sizeof(int32_t));
    uint32_t* buf[2] = {smem.data(), smem.data() + g.a_words + g.b_words};
    for (int tid = 0; tid < kDftThreads; ++tid)
      dft_stage(x, mat, buf[0], buf[0] + g.a_words, g, k0, c0, 0, tid,
                kDftThreads, vec4);
    for (int s = 0; s < g.stages; ++s) {
      if (s + 1 < g.stages)
        for (int tid = 0; tid < kDftThreads; ++tid)
          dft_stage(x, mat, buf[(s + 1) & 1], buf[(s + 1) & 1] + g.a_words,
                    g, k0, c0, s + 1, tid, kDftThreads, vec4);
      const uint32_t* As = buf[s & 1];
      for (int warp = 0; warp < kDftWarps; ++warp)
        for (int jj = 0; jj < g.JC; ++jj) {
          uint32_t a[32][2][4], b[32][8][2];
          for (int lane = 0; lane < 32; ++lane)
            dft_frags(As, As + g.a_words, g, jj, warp % g.KB, warp / g.KB,
                      lane, a[lane], b[lane]);
          for (int mt = 0; mt < 2; ++mt)
            for (int nt = 0; nt < 8; ++nt) {
              uint32_t fa[32][4], fb[32][2];
              int32_t d[32][4];
              for (int lane = 0; lane < 32; ++lane) {
                for (int r = 0; r < 4; ++r) {
                  fa[lane][r] = a[lane][mt][r];
                  d[lane][r] = acc[warp][lane][mt][nt][r];
                }
                for (int r = 0; r < 2; ++r) fb[lane][r] = b[lane][nt][r];
              }
              mma_u8_warp(fa, fb, d);
              for (int lane = 0; lane < 32; ++lane)
                for (int r = 0; r < 4; ++r)
                  acc[warp][lane][mt][nt][r] = d[lane][r];
            }
        }
    }
    for (int warp = 0; warp < kDftWarps; ++warp)
      for (int lane = 0; lane < 32; ++lane)
        dft_store_acc(smem.data(), g, warp % g.KB, warp / g.KB, lane,
                      acc[warp][lane]);
    for (int tid = 0; tid < kDftThreads; ++tid)
      for (int p = tid; p < g.KB * g.NC; p += kDftThreads)
        dft_out_elem<F>(smem.data(), out, g, p >> g.log_nc, p & (g.NC - 1),
                        k0, c0, canonical_out);
  }
}
#endif

}  // namespace ptt

#if defined(__CUDACC__)

namespace ptt {

PT_FN void mma_u8(int32_t (&d)[4], const uint32_t (&a)[4],
                  const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

PT_FN void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
PT_FN void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace ptt

template <class F>
__global__ void __launch_bounds__(ptt::kDftThreads, 2)
    dft_kernel(const uint32_t* x, const uint32_t* mat, uint32_t* out,
               int64_t nb, int K, int canonical_out, int vec4) {
  extern __shared__ __align__(16) uint32_t smem[];
  const ptt::DftGeom g = ptt::dft_geom(K, nb);
  const int k0 = (int)(blockIdx.x % g.kgroups) * g.KB;
  const int64_t c0 = (int64_t)(blockIdx.x / g.kgroups) * g.NC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kl = warp % g.KB, cg = warp / g.KB;
  int32_t acc[2][8][4] = {};
  const int bufw = g.a_words + g.b_words;       // a stage buffer's words
  ptt::dft_stage(x, mat, smem, smem + g.a_words, g, k0, c0, 0, threadIdx.x,
                 blockDim.x, vec4);
  ptt::cp_async_commit();
  for (int s = 0; s < g.stages; ++s) {
    if (s + 1 < g.stages) {
      uint32_t* nxt = smem + ((s + 1) & 1) * bufw;
      ptt::dft_stage(x, mat, nxt, nxt + g.a_words, g, k0, c0, s + 1,
                     threadIdx.x, blockDim.x, vec4);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* As = smem + (s & 1) * bufw;
    for (int jj = 0; jj < g.JC; ++jj) {
      uint32_t a[2][4], b[8][2];
      ptt::dft_frags(As, As + g.a_words, g, jj, kl, cg, lane, a, b);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) ptt::mma_u8(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }
  ptt::dft_store_acc(smem, g, kl, cg, lane, acc);
  __syncthreads();
  for (int p = threadIdx.x; p < g.KB * g.NC; p += blockDim.x)
    ptt::dft_out_elem<F>(smem, out, g, p >> g.log_nc, p & (g.NC - 1), k0,
                         c0, canonical_out);
}

template <class F>
int dft_launch(const uint32_t* x, const uint8_t* mat, uint32_t* out,
               int64_t nb, int K, int canonical_out, cudaStream_t stream) {
  if (K < 1 || K > 32 || (K & (K - 1))) return (int)cudaErrorInvalidValue;
  const ptt::DftGeom g = ptt::dft_geom(K, nb);
  const size_t smem = (size_t)ptt::dft_smem_words(g) * sizeof(uint32_t);
  const cudaError_t e = cudaFuncSetAttribute(
      dft_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec4 = nb % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dft_kernel<F><<<(unsigned)(g.tiles * g.kgroups), ptt::kDftThreads, smem,
                  stream>>>(x, reinterpret_cast<const uint32_t*>(mat), out, nb,
                            K, canonical_out, vec4);
  return (int)cudaGetLastError();
}

extern "C" int ptt_dft(const uint32_t* x, const uint8_t* mat, uint32_t* out,
                       int64_t nb, int K, int canonical_out, int field,
                       void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return dft_launch<ptt::Fr254>(x, mat, out, nb, K, canonical_out, s);
    case 1: return dft_launch<ptt::Fr377>(x, mat, out, nb, K, canonical_out, s);
    case 2: return dft_launch<ptt::Fr381>(x, mat, out, nb, K, canonical_out, s);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
