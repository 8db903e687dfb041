// Batched length-K NTT (K = 2^0..2^5) along axis 1 of (8, K, nb) words, as
// one product of the batch's bytes against a constant byte matrix, then a
// regroup and one Montgomery reduction.  The field (BN254 Fr or BLS12-377 Fr)
// is a template parameter; the launcher takes its id.
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
// (at most 9 words for both fields), and REDC(V_k) = V_k / R =
// scale * sum_j w^(j k) x_j in the port's Montgomery form, in [0, 2p);
// canonical_out adds one cond_sub_p.
// The JAX package's fold relies on its R = 2^270 >= 4096 p and cannot land
// under the port's R = 2^256; one REDC of the 9-word value replaces it.
//
// Layouts: x and out are (8, K, nb) words (word w of element j of column c
// at [(w K + j) nb + c]); the matrix is uint8 (K, 8, K, 32, 4) with
// [j, w, k, o, q] = byte o of C(j, k, 4 w + q), so the four bytes a 32-bit
// input word meets for output byte o are one packed word: one __dp4a each.
//
// Bound on the H100: as an int8 matrix product, the (32 K)^2 nb multiply-adds
// at the tensor cores' int8 rate (1,979 TOP/s, H100 SXM data sheet, 700 W
// limit) would take ~35 us at K = 32, nb = 2^15, above the ~20 us that its
// 64 MB of input and output take at 3.35 TB/s.  This first kernel uses
// __dp4a on the CUDA cores (4 byte multiply-adds per lane instruction), so
// it runs well above that bound; a tensor-core (mma/wgmma u8) version
// consumes the same matrix layout.  Design: a block stages a
// tile of 32 columns (K * 32 bytes each) in shared memory; each thread owns
// one (k, column) and its 32 int32 accumulators; a warp shares k, so its
// matrix reads are uniform (one 16-byte load serves the warp).

#include "field.cuh"

namespace ptt {

#if defined(__CUDACC__)
PT_FN uint32_t dp4a_u8(uint32_t a, uint32_t b, uint32_t c) {
  return __dp4a(a, b, c);
}
PT_FN void load4(const uint32_t* p, uint32_t (&v)[4]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
#else
inline uint32_t dp4a_u8(uint32_t a, uint32_t b, uint32_t c) {
  for (int q = 0; q < 4; ++q)
    c += ((a >> (8 * q)) & 255u) * ((b >> (8 * q)) & 255u);
  return c;
}
inline void load4(const uint32_t* p, uint32_t (&v)[4]) {
  for (int q = 0; q < 4; ++q) v[q] = p[q];
}
#endif

// Output k of one column.  xs: the column's word 0 of element 0, word w of
// element j at xs[(w K + j) xstride]; mat: the packed matrix words.
template <class F>
PT_FN fe dft_elem(const uint32_t* xs, int64_t xstride, const uint32_t* mat,
                  int K, int k, int canonical_out) {
  uint32_t acc[32];
#pragma unroll
  for (int o = 0; o < 32; ++o) acc[o] = 0;
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const uint32_t xw = xs[((int64_t)w * K + j) * xstride];
      const uint32_t* m = mat + (((int64_t)j * 8 + w) * K + k) * 32;
#pragma unroll
      for (int o4 = 0; o4 < 8; ++o4) {
        uint32_t v[4];
        load4(m + 4 * o4, v);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[4 * o4 + q] = dp4a_u8(xw, v[q], acc[4 * o4 + q]);
      }
    }
  }
  // Regroup the byte-position sums into the 9-word V (each acc < 2^26).
  uint32_t t[9];
  uint64_t carry = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint64_t s = carry + acc[4 * w] + ((uint64_t)acc[4 * w + 1] << 8) +
                       ((uint64_t)acc[4 * w + 2] << 16) +
                       ((uint64_t)acc[4 * w + 3] << 24);
    t[w] = (uint32_t)s;
    carry = s >> 32;
  }
  t[8] = (uint32_t)carry;
  fe r = redc9<F>(t);
  if (canonical_out) r = cond_sub_p<F>(r);
  return r;
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kCols = 32;      // columns per block: one warp's width
constexpr int kMaxRows = 8;    // outputs k per block (blockDim.y)

template <class F>
__global__ void __launch_bounds__(kCols * kMaxRows)
    dft_kernel(const uint32_t* x, const uint32_t* mat, uint32_t* out,
               int64_t nb, int K, int kgroups, int canonical_out) {
  extern __shared__ uint32_t tile[];   // (8 K) rows x kCols columns
  const int64_t c0 = (int64_t)(blockIdx.x / kgroups) * kCols;
  const int k = (blockIdx.x % kgroups) * blockDim.y + threadIdx.y;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  for (int r = tid; r < 8 * K * kCols; r += kCols * blockDim.y) {
    const int64_t c = c0 + r % kCols;
    tile[r] = c < nb ? x[(int64_t)(r / kCols) * nb + c] : 0u;
  }
  __syncthreads();
  const int64_t c = c0 + threadIdx.x;
  const ptt::fe v =
      ptt::dft_elem<F>(tile + threadIdx.x, kCols, mat, K, k, canonical_out);
  if (c < nb) ptt::store_fe(out + (int64_t)k * nb, c, (int64_t)K * nb, v);
}

template <class F>
int dft_launch(const uint32_t* x, const uint8_t* mat, uint32_t* out,
               int64_t nb, int K, int canonical_out, cudaStream_t stream) {
  const int rows = K < kMaxRows ? K : kMaxRows;
  const int kgroups = K / rows;
  const int64_t blocks = (nb + kCols - 1) / kCols * kgroups;
  const size_t smem = (size_t)8 * K * kCols * sizeof(uint32_t);
  dft_kernel<F><<<(unsigned)blocks, dim3(kCols, rows), smem, stream>>>(
      x, reinterpret_cast<const uint32_t*>(mat), out, nb, K, kgroups,
      canonical_out);
  return (int)cudaGetLastError();
}

extern "C" int ptt_dft(const uint32_t* x, const uint8_t* mat, uint32_t* out,
                       int64_t nb, int K, int canonical_out, int field,
                       void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return dft_launch<ptt::Fr254>(x, mat, out, nb, K, canonical_out, s);
    case 1: return dft_launch<ptt::Fr377>(x, mat, out, nb, K, canonical_out, s);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
