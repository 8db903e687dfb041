// Field and point library for the port's CUDA kernels: the base and scalar
// fields of BN254, BLS12-377 and BLS12-381, and the three curves.
//
// Replaces the TPU kernels' in-kernel library panda_tpu/ops/kernel_field.py
// (LF, _mul, _add, _sub, _mul_small, _select, _madd, _padd, _pdbl).
//
// Representation (the port's own, see panda_tpu_torch/fields/mont.py):
//   * an element is N little-endian 32-bit words, fe_t<N>, with Montgomery
//     radix R = 2^(32 N), the wire radix: N = 8 (R = 2^256) for BN254's
//     fields and the BLS scalar fields, N = 12 (R = 2^384) for the BLS base
//     fields; every stored value in [0, 2p);
//   * tensors are limbs-first: word l of element i lives at ptr[l*stride + i],
//     so neighbouring threads read neighbouring addresses per word.
//
// Montgomery multiply: CIOS over N x 32-bit words with PTX carry chains
// (add.cc / addc / mad.lo.cc / madc.hi.cc), the design of the CUDA reference
// library.  With inputs < 2p and 4p < R the output is < 2p with no final
// subtraction; add and sub end with one conditional -2p / +2p.  4p < R holds
// for every field here but BLS12-381 Fr (4r > 2^256), which only the digit
// recode uses, through a product with the plain 1 (exact for any a < R).
// The point formulas are the complete Renes-Costello-Batina algorithms 7-9
// for a = 0, templated on a curve's traits (its Fp and b3 = 3b: 9 for BN254,
// 3 for BLS12-377, 12 for BLS12-381), in the same op order as
// panda_tpu_torch/curves/point.py, so kernel and plain version agree bit for
// bit.
//
// What bounds the kernels built on it: 32-bit integer multiply-add
// throughput (a CIOS multiply is 4 N^2 + N of them: 264 for 8 words, 588
// for 12; a mixed add is 11 multiplies).
//
// Compiled two ways: by nvcc for sm_90a (PTX carry chains), and by a host
// C++ compiler for the CPU tests, where each carry primitive is an exact
// emulation of its PTX instruction over one carry flag.

#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define PT_FN __device__ __forceinline__
#else
#define PT_FN inline
#endif

namespace ptt {

// ---------------------------------------------------------------------------
// Carry-chain primitives
// ---------------------------------------------------------------------------
// Assumption: each primitive is its own `asm volatile` statement, and a chain
// (add.cc, addc.cc, ..., addc) relies on the carry flag surviving from one
// statement to the next.  This holds because nvcc keeps volatile asm in
// program order and emits no .cc instruction of its own between them, and
// ptxas tracks CC as a register dependency (CGBN and other CUDA big-integer
// libraries rely on the same).  Nothing in the language guarantees it: if a
// toolchain ever breaks it, chip_smoke.py's kernel-against-plain checks fail.
// A rework of this library should move each full chain into one asm block.
#if defined(__CUDACC__)

PT_FN uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
PT_FN uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
PT_FN uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
PT_FN uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
PT_FN uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
PT_FN uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
PT_FN uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
PT_FN uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
PT_FN uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
PT_FN uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
PT_FN uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
PT_FN void atomic_inc(int32_t* p) { atomicAdd(p, 1); }

#else  // host emulation: one carry flag, PTX semantics

inline uint32_t& host_cf() {
  static uint32_t cf = 0;
  return cf;
}
inline uint32_t set_cf(uint64_t s) {
  host_cf() = (uint32_t)(s >> 32) & 1u;
  return (uint32_t)s;
}
inline uint32_t add_cc(uint32_t a, uint32_t b) {
  return set_cf((uint64_t)a + b);
}
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  return set_cf((uint64_t)a + b + host_cf());
}
inline uint32_t addc(uint32_t a, uint32_t b) {
  return (uint32_t)((uint64_t)a + b + host_cf());
}
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
  host_cf() = a < b;
  return a - b;
}
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)b + host_cf();
  host_cf() = (uint64_t)a < s;
  return (uint32_t)((uint64_t)a - s);
}
inline uint32_t subc(uint32_t a, uint32_t b) {
  return (uint32_t)((uint64_t)a - b - host_cf());
}
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set_cf((uint64_t)(uint32_t)((uint64_t)a * b) + c);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set_cf((uint64_t)(uint32_t)((uint64_t)a * b) + c + host_cf());
}
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set_cf((((uint64_t)a * b) >> 32) + c);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set_cf((((uint64_t)a * b) >> 32) + c + host_cf());
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return (uint32_t)((((uint64_t)a * b) >> 32) + c + host_cf());
}
inline void atomic_inc(int32_t* p) { *p += 1; }

#endif

// ---------------------------------------------------------------------------
// Field parameters (checked against panda_tpu_torch/fields/config.py by the
// tests).  N is the word count, R = 2^(32 N).
// ---------------------------------------------------------------------------
struct Fp254 {  // BN254 base field
  static constexpr int N = 8;
  static constexpr uint32_t ninv = 0xe4866389u;  // -p^-1 mod 2^32
  static PT_FN uint32_t p(int i) {
    const uint32_t v[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  static PT_FN uint32_t p2(int i) {  // 2p
    const uint32_t v[8] = {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
                           0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return v[i];
  }
  static PT_FN uint32_t one(int i) {  // R mod p: Montgomery 1
    const uint32_t v[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                           0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

struct Fr254 {  // BN254 scalar field
  static constexpr int N = 8;
  static constexpr uint32_t ninv = 0xefffffffu;
  static constexpr int wide_top = 2;  // 2^256 < 2^(wide_top + 1) p
  static PT_FN uint32_t p(int i) {
    const uint32_t v[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  static PT_FN uint32_t p2(int i) {  // 2p
    const uint32_t v[8] = {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
                           0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return v[i];
  }
  static PT_FN uint32_t one(int i) {  // R mod p: Montgomery 1
    const uint32_t v[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                           0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

// BLS12-377 scalar field (253 bits).  The same R = 2^256 and the same
// invariants as Fr254 hold: 4r < 2^256 (r < 2^253), so CIOS products of
// values < 2r stay < 2r and add/sub stay below 2^256; and the DFT's V <
// 2^10 255 r gives V + 2^32 r < 2^288, so redc9 fits 9 words.
struct Fr377 {
  static constexpr int N = 8;
  static constexpr uint32_t ninv = 0xffffffffu;
  static constexpr int wide_top = 3;  // 2^256 < 2^(wide_top + 1) p
  static PT_FN uint32_t p(int i) {
    const uint32_t v[8] = {0x00000001u, 0x0a118000u, 0xd0000001u, 0x59aa76feu,
                           0x5c37b001u, 0x60b44d1eu, 0x9a2ca556u, 0x12ab655eu};
    return v[i];
  }
  static PT_FN uint32_t p2(int i) {  // 2p
    const uint32_t v[8] = {0x00000002u, 0x14230000u, 0xa0000002u, 0xb354edfdu,
                           0xb86f6002u, 0xc1689a3cu, 0x34594aacu, 0x2556cabdu};
    return v[i];
  }
  static PT_FN uint32_t one(int i) {  // R mod p: Montgomery 1
    const uint32_t v[8] = {0xfffffff3u, 0x7d1c7fffu, 0x6ffffff2u, 0x7257f50fu,
                           0x512c0feeu, 0x16d81575u, 0x2bbb9a9du, 0x0d4bda32u};
    return v[i];
  }
};

// BLS12-381 scalar field (255 bits), for the digit recode only: 2r < 2^256
// but 4r > 2^256, so the [0, 2r) invariant of mont_mul, add_mod and sub_mod
// does not hold here.  digits.cu multiplies by the plain 1, which is exact
// for any a < R (output <= r), and then subtracts r once.
struct Fr381 {
  static constexpr int N = 8;
  static constexpr uint32_t ninv = 0xffffffffu;
  static PT_FN uint32_t p(int i) {
    const uint32_t v[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                           0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
    return v[i];
  }
  static PT_FN uint32_t p2(int i) {  // 2p
    const uint32_t v[8] = {0x00000002u, 0xfffffffeu, 0xfffcb7fdu, 0xa77b4805u,
                           0x1343b00au, 0x6673b010u, 0x533afa90u, 0xe7db4ea6u};
    return v[i];
  }
  static PT_FN uint32_t one(int i) {  // R mod p: Montgomery 1
    const uint32_t v[8] = {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                           0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
    return v[i];
  }
};

// BLS12-377 base field (377 bits), 12 words, R = 2^384: 4p < 2^380.
struct Fp377 {
  static constexpr int N = 12;
  static constexpr uint32_t ninv = 0xffffffffu;
  static PT_FN uint32_t p(int i) {
    const uint32_t v[12] = {0x00000001u, 0x8508c000u, 0x30000000u, 0x170b5d44u,
                            0xba094800u, 0x1ef3622fu, 0x00f5138fu, 0x1a22d9f3u,
                            0x6ca1493bu, 0xc63b05c0u, 0x17c510eau, 0x01ae3a46u};
    return v[i];
  }
  static PT_FN uint32_t p2(int i) {  // 2p
    const uint32_t v[12] = {0x00000002u, 0x0a118000u, 0x60000001u, 0x2e16ba88u,
                            0x74129000u, 0x3de6c45fu, 0x01ea271eu, 0x3445b3e6u,
                            0xd9429276u, 0x8c760b80u, 0x2f8a21d5u, 0x035c748cu};
    return v[i];
  }
  static PT_FN uint32_t one(int i) {  // R mod p: Montgomery 1
    const uint32_t v[12] = {0xffffff68u, 0x02cdffffu, 0x7fffffb1u, 0x51409f83u,
                            0x8a7d3ff2u, 0x9f7db3a9u, 0x6e7c6305u, 0x7b4e97b7u,
                            0x803c84e8u, 0x4cf495bfu, 0xe2fdf49au, 0x008d6661u};
    return v[i];
  }
};

// BLS12-381 base field (381 bits), 12 words, R = 2^384: 4p < 2^383.
struct Fp381 {
  static constexpr int N = 12;
  static constexpr uint32_t ninv = 0xfffcfffdu;
  static PT_FN uint32_t p(int i) {
    const uint32_t v[12] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                            0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                            0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
    return v[i];
  }
  static PT_FN uint32_t p2(int i) {  // 2p
    const uint32_t v[12] = {0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu,
                            0xed61ec48u, 0xce61a541u, 0xe70a257eu, 0xc8ee9709u,
                            0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u};
    return v[i];
  }
  static PT_FN uint32_t one(int i) {  // R mod p: Montgomery 1
    const uint32_t v[12] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
                            0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
                            0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
    return v[i];
  }
};

// Curve traits: the base field of the coordinates, the scalar field of the
// digit recode, and b3 = 3b for the complete formulas.
struct Bn254 {
  using Fp = Fp254;
  using Fr = Fr254;
  static constexpr int b3 = 9;
};
struct Bls12_377 {
  using Fp = Fp377;
  using Fr = Fr377;
  static constexpr int b3 = 3;
};
struct Bls12_381 {
  using Fp = Fp381;
  using Fr = Fr381;
  static constexpr int b3 = 12;
};

// The NTT launchers take a field id: 0 is Fr254, 1 is Fr377, in the order of
// panda_tpu_torch/ops/_ext.py's NTT_FIELDS.  The MSM launchers take a curve
// id (point_ops, wscan, phase_a: 0 Bn254, 1 Bls12_377, 2 Bls12_381, the
// order of _ext.MSM_CURVES) or a scalar-field id (digits: 0 Fr254, 1 Fr377,
// 2 Fr381, the order of _ext.MSM_FIELDS).

template <int N>
struct fe_t {
  uint32_t w[N];
};
using fe = fe_t<8>;

// ---------------------------------------------------------------------------
// Field arithmetic
// ---------------------------------------------------------------------------

// CIOS Montgomery product a b R^-1.  Output < 2p for a, b < 2p; for b = 1
// (plain integer) and any a < R the output is <= p.  For a >= 2p and any
// other b the (N + 1)-word accumulator can overflow (mid-loop t < a + p,
// which may pass R), so callers keep a < 2p.
template <class F>
PT_FN fe_t<F::N> mont_mul(const fe_t<F::N>& a, const fe_t<F::N>& b) {
  constexpr int N = F::N;
  uint32_t t[N + 1];
#pragma unroll
  for (int j = 0; j < N + 1; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = b.w[i];
    // t += a * b_i: low halves into words 0..N-1, high halves into 1..N.
    // t < 4p < R on entry, so t + a b_i < 2^32 R fits in N + 1 words.
    t[0] = mad_lo_cc(a.w[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(a.w[j], bi, t[j]);
    t[N] = addc(t[N], 0);
    t[1] = mad_hi_cc(a.w[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j)
      t[j + 1] = madc_hi_cc(a.w[j], bi, t[j + 1]);
    t[N] = madc_hi(a.w[N - 1], bi, t[N]);
    // t += m p with m = t_0 (-p^-1) mod 2^32, which clears word 0; shift.
    const uint32_t m = t[0] * F::ninv;
    t[0] = mad_lo_cc(m, F::p(0), t[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(m, F::p(j), t[j]);
    t[N] = addc(t[N], 0);
    t[1] = mad_hi_cc(m, F::p(0), t[1]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j)
      t[j + 1] = madc_hi_cc(m, F::p(j), t[j + 1]);
    t[N] = madc_hi(m, F::p(N - 1), t[N]);
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] = t[j + 1];
    t[N] = 0;
  }
  fe_t<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.w[j] = t[j];
  return r;
}

// Montgomery reduction (t + M p) / R of a 9-word t, with the unique M < R:
// the reduction half of each CIOS step, eight times.  Needs
// t + 2^32 p < 2^288 (then every step fits 9 words); the result is
// < t / R + p.  8-word NTT fields only.
template <class F>
PT_FN fe redc9(uint32_t (&t)[9]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t m = t[0] * F::ninv;
    t[0] = mad_lo_cc(m, F::p(0), t[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = madc_lo_cc(m, F::p(j), t[j]);
    t[8] = addc(t[8], 0);
    t[1] = mad_hi_cc(m, F::p(0), t[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j) t[j + 1] = madc_hi_cc(m, F::p(j), t[j + 1]);
    t[8] = madc_hi(m, F::p(7), t[8]);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  return r;
}

template <int N>
PT_FN fe_t<N> select(bool c, const fe_t<N>& a, const fe_t<N>& b) {
  fe_t<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

// (a + b) mod 2p for a, b < 2p: a + b < 4p < R, then subtract 2p unless
// that borrows.
template <class F>
PT_FN fe_t<F::N> add_mod(const fe_t<F::N>& a, const fe_t<F::N>& b) {
  constexpr int N = F::N;
  fe_t<N> s, d;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) s.w[j] = addc_cc(a.w[j], b.w[j]);
  s.w[N - 1] = addc(a.w[N - 1], b.w[N - 1]);
  d.w[0] = sub_cc(s.w[0], F::p2(0));
#pragma unroll
  for (int j = 1; j < N; ++j) d.w[j] = subc_cc(s.w[j], F::p2(j));
  const uint32_t borrow = subc(0, 0);  // all ones when s < 2p
  return select(borrow != 0, s, d);
}

// (a - b) mod 2p for a, b < 2p: add 2p back when a - b borrows.
template <class F>
PT_FN fe_t<F::N> sub_mod(const fe_t<F::N>& a, const fe_t<F::N>& b) {
  constexpr int N = F::N;
  fe_t<N> d, r;
  d.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d.w[j] = subc_cc(a.w[j], b.w[j]);
  const uint32_t mask = subc(0, 0);  // all ones when a < b
  r.w[0] = add_cc(d.w[0], F::p2(0) & mask);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) r.w[j] = addc_cc(d.w[j], F::p2(j) & mask);
  r.w[N - 1] = addc(d.w[N - 1], F::p2(N - 1) & mask);
  return r;
}

// v - p if v >= p else v (canonicalises a value <= 2p - 1).
template <class F>
PT_FN fe_t<F::N> cond_sub_p(const fe_t<F::N>& v) {
  constexpr int N = F::N;
  fe_t<N> d;
  d.w[0] = sub_cc(v.w[0], F::p(0));
#pragma unroll
  for (int j = 1; j < N; ++j) d.w[j] = subc_cc(v.w[j], F::p(j));
  const uint32_t borrow = subc(0, 0);
  return select(borrow != 0, v, d);
}

// Word i of p 2^j, for 0 <= j < 32.
template <class F>
PT_FN uint32_t p_shl(int i, int j) {
  return j == 0 ? F::p(i)
                : (F::p(i) << j) | (i ? F::p(i - 1) >> (32 - j) : 0u);
}

// Any value below 2^256 -> canonical [0, p): conditional subtractions of
// 2^j p for j = F::wide_top down to 0, as the plain mont.reduce_wire.
// 8-word NTT fields only.
template <class F>
PT_FN fe reduce_wide(const fe& a) {
  fe v = a;
#pragma unroll
  for (int j = F::wide_top; j >= 0; --j) {
    fe d;
    d.w[0] = sub_cc(v.w[0], p_shl<F>(0, j));
#pragma unroll
    for (int i = 1; i < 8; ++i) d.w[i] = subc_cc(v.w[i], p_shl<F>(i, j));
    const uint32_t borrow = subc(0, 0);  // all ones when v < 2^j p
    v = select(borrow != 0, v, d);
  }
  return v;
}

// Index of the highest set bit of V > 0.
template <int V>
struct top_bit {
  static constexpr int value = 1 + top_bit<(V >> 1)>::value;
};
template <>
struct top_bit<1> {
  static constexpr int value = 0;
};

// b3 a mod 2p by double-and-add over the bits of C::b3 from the top, the
// plain mont.mul_small16's order (b3 = 9: 2a, 4a, 8a, 8a + a; 3: 2a + a;
// 12: 2a + a, 6a, 12a).
template <class C>
PT_FN fe_t<C::Fp::N> mul_b3(const fe_t<C::Fp::N>& a) {
  using F = typename C::Fp;
  fe_t<F::N> t = a;
#pragma unroll
  for (int i = top_bit<C::b3>::value - 1; i >= 0; --i) {
    t = add_mod<F>(t, t);
    if ((C::b3 >> i) & 1) t = add_mod<F>(t, a);
  }
  return t;
}

template <int N = 8>
PT_FN fe_t<N> fe_zero() {
  fe_t<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.w[j] = 0;
  return r;
}

template <class F>
PT_FN fe_t<F::N> fe_one() {
  fe_t<F::N> r;
#pragma unroll
  for (int j = 0; j < F::N; ++j) r.w[j] = F::one(j);
  return r;
}

template <int N = 8>
PT_FN fe_t<N> load_fe(const uint32_t* p, int64_t i, int64_t stride) {
  fe_t<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.w[j] = p[j * stride + i];
  return r;
}

template <int N>
PT_FN void store_fe(uint32_t* p, int64_t i, int64_t stride,
                    const fe_t<N>& v) {
#pragma unroll
  for (int j = 0; j < N; ++j) p[j * stride + i] = v.w[j];
}

// ---------------------------------------------------------------------------
// Points: homogeneous projective (X : Y : Z), identity (0 : 1 : 0), over the
// base field of curve C (Bn254 by default)
// ---------------------------------------------------------------------------
template <int N>
struct xyz_t {
  fe_t<N> x, y, z;
};
using xyz = xyz_t<8>;

template <class C = Bn254>
PT_FN xyz_t<C::Fp::N> pt_identity() {
  constexpr int N = C::Fp::N;
  return {fe_zero<N>(), fe_one<typename C::Fp>(), fe_zero<N>()};
}

template <int N>
PT_FN xyz_t<N> pt_select(bool c, const xyz_t<N>& a, const xyz_t<N>& b) {
  return {select(c, a.x, b.x), select(c, a.y, b.y), select(c, a.z, b.z)};
}

template <int N = 8>
PT_FN xyz_t<N> load_pt(const uint32_t* x, const uint32_t* y,
                       const uint32_t* z, int64_t i, int64_t stride) {
  return {load_fe<N>(x, i, stride), load_fe<N>(y, i, stride),
          load_fe<N>(z, i, stride)};
}

template <int N>
PT_FN void store_pt(uint32_t* x, uint32_t* y, uint32_t* z, int64_t i,
                    int64_t stride, const xyz_t<N>& v) {
  store_fe(x, i, stride, v.x);
  store_fe(y, i, stride, v.y);
  store_fe(z, i, stride, v.z);
}

#define PTT_M(a, b) mont_mul<F>(a, b)
#define PTT_A(a, b) add_mod<F>(a, b)
#define PTT_S(a, b) sub_mod<F>(a, b)

// Complete addition (RCB Algorithm 7, a = 0): 12M + 2*b3.
template <class C = Bn254>
PT_FN xyz_t<C::Fp::N> pt_add(const xyz_t<C::Fp::N>& p,
                             const xyz_t<C::Fp::N>& q) {
  using F = typename C::Fp;
  using fe = fe_t<F::N>;
  fe t0 = PTT_M(p.x, q.x);
  fe t1 = PTT_M(p.y, q.y);
  fe t2 = PTT_M(p.z, q.z);
  fe t3 = PTT_S(PTT_M(PTT_A(p.x, p.y), PTT_A(q.x, q.y)), PTT_A(t0, t1));
  fe t4 = PTT_S(PTT_M(PTT_A(p.y, p.z), PTT_A(q.y, q.z)), PTT_A(t1, t2));
  fe t5 = PTT_S(PTT_M(PTT_A(p.x, p.z), PTT_A(q.x, q.z)), PTT_A(t0, t2));
  t0 = PTT_A(PTT_A(t0, t0), t0);
  t2 = mul_b3<C>(t2);
  fe z3 = PTT_A(t1, t2);
  t1 = PTT_S(t1, t2);
  t5 = mul_b3<C>(t5);
  xyz_t<F::N> r;
  r.x = PTT_S(PTT_M(t3, t1), PTT_M(t4, t5));
  r.y = PTT_A(PTT_M(t1, z3), PTT_M(t5, t0));
  r.z = PTT_A(PTT_M(z3, t4), PTT_M(t0, t3));
  return r;
}

// Complete mixed addition (RCB Algorithm 8, a = 0): 11M + 2*b3; q affine.
template <class C = Bn254>
PT_FN xyz_t<C::Fp::N> pt_madd(const xyz_t<C::Fp::N>& p,
                              const fe_t<C::Fp::N>& qx,
                              const fe_t<C::Fp::N>& qy) {
  using F = typename C::Fp;
  using fe = fe_t<F::N>;
  fe t0 = PTT_M(p.x, qx);
  fe t1 = PTT_M(p.y, qy);
  fe t3 = PTT_S(PTT_M(PTT_A(p.x, p.y), PTT_A(qx, qy)), PTT_A(t0, t1));
  fe t4 = PTT_A(PTT_M(qy, p.z), p.y);
  fe t5 = PTT_A(PTT_M(qx, p.z), p.x);
  t0 = PTT_A(PTT_A(t0, t0), t0);
  fe t2 = mul_b3<C>(p.z);
  fe z3 = PTT_A(t1, t2);
  t1 = PTT_S(t1, t2);
  t5 = mul_b3<C>(t5);
  xyz_t<F::N> r;
  r.x = PTT_S(PTT_M(t3, t1), PTT_M(t4, t5));
  r.y = PTT_A(PTT_M(t1, z3), PTT_M(t5, t0));
  r.z = PTT_A(PTT_M(z3, t4), PTT_M(t0, t3));
  return r;
}

// Complete doubling (RCB Algorithm 9, a = 0): 6M + 2S + 1*b3.
template <class C = Bn254>
PT_FN xyz_t<C::Fp::N> pt_dbl(const xyz_t<C::Fp::N>& p) {
  using F = typename C::Fp;
  using fe = fe_t<F::N>;
  fe t0 = PTT_M(p.y, p.y);
  fe z3 = PTT_A(PTT_A(t0, t0), PTT_A(t0, t0));
  z3 = PTT_A(z3, z3);
  fe t1 = PTT_M(p.y, p.z);
  fe t2 = mul_b3<C>(PTT_M(p.z, p.z));
  fe x3 = PTT_M(t2, z3);
  fe y3 = PTT_A(t0, t2);
  z3 = PTT_M(t1, z3);
  t1 = PTT_A(t2, t2);
  t2 = PTT_A(t1, t2);
  t0 = PTT_S(t0, t2);
  y3 = PTT_A(x3, PTT_M(t0, y3));
  t1 = PTT_M(p.x, p.y);
  x3 = PTT_M(t0, t1);
  x3 = PTT_A(x3, x3);
  return {x3, y3, z3};
}

#undef PTT_M
#undef PTT_A
#undef PTT_S

}  // namespace ptt

#if defined(__CUDACC__)
#include <cuda_runtime.h>
// Each kernel library exports the CUDA error string for its return codes.
extern "C" const char* ptt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
#define PTT_LAUNCH_DIMS(n, threads) \
  (unsigned)(((n) + (threads)-1) / (threads)), (threads)
#endif
