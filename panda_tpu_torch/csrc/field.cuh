// Field and point library for the port's CUDA kernels: BN254's two fields,
// BLS12-377's scalar field, and the BN254 curve.
//
// Replaces the TPU kernels' in-kernel library panda_tpu/ops/kernel_field.py
// (LF, _mul, _add, _sub, _mul_small, _select, _madd, _padd, _pdbl).
//
// Representation (the port's own, see panda_tpu_torch/fields/mont.py):
//   * an element is 8 little-endian 32-bit words, Montgomery radix
//     R = 2^256 (the wire radix), every stored value in [0, 2p);
//   * tensors are limbs-first: word l of element i lives at ptr[l*stride + i],
//     so neighbouring threads read neighbouring addresses per word.
//
// Montgomery multiply: CIOS over 8 x 32-bit words with PTX carry chains
// (add.cc / addc / mad.lo.cc / madc.hi.cc), the design of the CUDA reference
// library.  With inputs < 2p and 4p < R the output is < 2p with no final
// subtraction; add and sub end with one conditional -2p / +2p.  The point
// formulas are the complete Renes-Costello-Batina algorithms 7-9 for a = 0
// (b3 = 3b = 9), in the same op order as panda_tpu_torch/curves/point.py, so
// kernel and plain version agree bit for bit.
//
// What bounds the kernels built on it: 32-bit integer multiply-add
// throughput (a mixed add is 11 multiplies of 2 x 64 mad instructions).
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
// tests)
// ---------------------------------------------------------------------------
struct Fp254 {  // BN254 base field
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

// The NTT launchers take a field id: 0 is Fr254, 1 is Fr377, in the order of
// panda_tpu_torch/ops/_ext.py's NTT_FIELDS.

struct fe {
  uint32_t w[8];
};

// ---------------------------------------------------------------------------
// Field arithmetic
// ---------------------------------------------------------------------------

// CIOS Montgomery product a b R^-1.  Output < 2p for a, b < 2p; for b = 1
// (plain integer) and any a < R the output is <= p.  For a >= 2p and any
// other b the 9-word accumulator can overflow (mid-loop t < a + p, which may
// pass 2^256), so callers keep a < 2p.
template <class F>
PT_FN fe mont_mul(const fe& a, const fe& b) {
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t bi = b.w[i];
    // t += a * b_i: low halves into words 0..7, high halves into 1..8.
    // t < 4p < 2^256 on entry, so t + a b_i < 2^288 fits in 9 words.
    t[0] = mad_lo_cc(a.w[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = madc_lo_cc(a.w[j], bi, t[j]);
    t[8] = addc(t[8], 0);
    t[1] = mad_hi_cc(a.w[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j) t[j + 1] = madc_hi_cc(a.w[j], bi, t[j + 1]);
    t[8] = madc_hi(a.w[7], bi, t[8]);
    // t += m p with m = t_0 (-p^-1) mod 2^32, which clears word 0; shift.
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

// Montgomery reduction (t + M p) / R of a 9-word t, with the unique M < R:
// the reduction half of each CIOS step, eight times.  Needs
// t + 2^32 p < 2^288 (then every step fits 9 words); the result is
// < t / R + p.
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

PT_FN fe select(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

// (a + b) mod 2p for a, b < 2p: a + b < 4p < 2^256, then subtract 2p unless
// that borrows.
template <class F>
PT_FN fe add_mod(const fe& a, const fe& b) {
  fe s, d;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 7; ++j) s.w[j] = addc_cc(a.w[j], b.w[j]);
  s.w[7] = addc(a.w[7], b.w[7]);
  d.w[0] = sub_cc(s.w[0], F::p2(0));
#pragma unroll
  for (int j = 1; j < 8; ++j) d.w[j] = subc_cc(s.w[j], F::p2(j));
  const uint32_t borrow = subc(0, 0);  // all ones when s < 2p
  return select(borrow != 0, s, d);
}

// (a - b) mod 2p for a, b < 2p: add 2p back when a - b borrows.
template <class F>
PT_FN fe sub_mod(const fe& a, const fe& b) {
  fe d, r;
  d.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) d.w[j] = subc_cc(a.w[j], b.w[j]);
  const uint32_t mask = subc(0, 0);  // all ones when a < b
  r.w[0] = add_cc(d.w[0], F::p2(0) & mask);
#pragma unroll
  for (int j = 1; j < 7; ++j) r.w[j] = addc_cc(d.w[j], F::p2(j) & mask);
  r.w[7] = addc(d.w[7], F::p2(7) & mask);
  return r;
}

// v - p if v >= p else v (canonicalises a value <= 2p - 1).
template <class F>
PT_FN fe cond_sub_p(const fe& v) {
  fe d;
  d.w[0] = sub_cc(v.w[0], F::p(0));
#pragma unroll
  for (int j = 1; j < 8; ++j) d.w[j] = subc_cc(v.w[j], F::p(j));
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

// 9 a mod 2p by the chain 2a, 4a, 8a, 8a + a (the plain version's order).
template <class F>
PT_FN fe mul_b3(const fe& a) {
  fe t = add_mod<F>(a, a);
  t = add_mod<F>(t, t);
  t = add_mod<F>(t, t);
  return add_mod<F>(t, a);
}

PT_FN fe fe_zero() {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = 0;
  return r;
}

template <class F>
PT_FN fe fe_one() {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = F::one(j);
  return r;
}

PT_FN fe load_fe(const uint32_t* p, int64_t i, int64_t stride) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = p[j * stride + i];
  return r;
}

PT_FN void store_fe(uint32_t* p, int64_t i, int64_t stride, const fe& v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j * stride + i] = v.w[j];
}

// ---------------------------------------------------------------------------
// Points: homogeneous projective (X : Y : Z), identity (0 : 1 : 0), over the
// base field F (BN254's Fp by default; mul_b3 is BN254's 3b = 9)
// ---------------------------------------------------------------------------
struct xyz {
  fe x, y, z;
};

template <class F = Fp254>
PT_FN xyz pt_identity() { return {fe_zero(), fe_one<F>(), fe_zero()}; }

PT_FN xyz pt_select(bool c, const xyz& a, const xyz& b) {
  return {select(c, a.x, b.x), select(c, a.y, b.y), select(c, a.z, b.z)};
}

PT_FN xyz load_pt(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                  int64_t i, int64_t stride) {
  return {load_fe(x, i, stride), load_fe(y, i, stride), load_fe(z, i, stride)};
}

PT_FN void store_pt(uint32_t* x, uint32_t* y, uint32_t* z, int64_t i,
                    int64_t stride, const xyz& v) {
  store_fe(x, i, stride, v.x);
  store_fe(y, i, stride, v.y);
  store_fe(z, i, stride, v.z);
}

#define PTT_M(a, b) mont_mul<F>(a, b)
#define PTT_A(a, b) add_mod<F>(a, b)
#define PTT_S(a, b) sub_mod<F>(a, b)

// Complete addition (RCB Algorithm 7, a = 0): 12M + 2*b3.
template <class F = Fp254>
PT_FN xyz pt_add(const xyz& p, const xyz& q) {
  fe t0 = PTT_M(p.x, q.x);
  fe t1 = PTT_M(p.y, q.y);
  fe t2 = PTT_M(p.z, q.z);
  fe t3 = PTT_S(PTT_M(PTT_A(p.x, p.y), PTT_A(q.x, q.y)), PTT_A(t0, t1));
  fe t4 = PTT_S(PTT_M(PTT_A(p.y, p.z), PTT_A(q.y, q.z)), PTT_A(t1, t2));
  fe t5 = PTT_S(PTT_M(PTT_A(p.x, p.z), PTT_A(q.x, q.z)), PTT_A(t0, t2));
  t0 = PTT_A(PTT_A(t0, t0), t0);
  t2 = mul_b3<F>(t2);
  fe z3 = PTT_A(t1, t2);
  t1 = PTT_S(t1, t2);
  t5 = mul_b3<F>(t5);
  xyz r;
  r.x = PTT_S(PTT_M(t3, t1), PTT_M(t4, t5));
  r.y = PTT_A(PTT_M(t1, z3), PTT_M(t5, t0));
  r.z = PTT_A(PTT_M(z3, t4), PTT_M(t0, t3));
  return r;
}

// Complete mixed addition (RCB Algorithm 8, a = 0): 11M + 2*b3; q affine.
template <class F = Fp254>
PT_FN xyz pt_madd(const xyz& p, const fe& qx, const fe& qy) {
  fe t0 = PTT_M(p.x, qx);
  fe t1 = PTT_M(p.y, qy);
  fe t3 = PTT_S(PTT_M(PTT_A(p.x, p.y), PTT_A(qx, qy)), PTT_A(t0, t1));
  fe t4 = PTT_A(PTT_M(qy, p.z), p.y);
  fe t5 = PTT_A(PTT_M(qx, p.z), p.x);
  t0 = PTT_A(PTT_A(t0, t0), t0);
  fe t2 = mul_b3<F>(p.z);
  fe z3 = PTT_A(t1, t2);
  t1 = PTT_S(t1, t2);
  t5 = mul_b3<F>(t5);
  xyz r;
  r.x = PTT_S(PTT_M(t3, t1), PTT_M(t4, t5));
  r.y = PTT_A(PTT_M(t1, z3), PTT_M(t5, t0));
  r.z = PTT_A(PTT_M(z3, t4), PTT_M(t0, t3));
  return r;
}

// Complete doubling (RCB Algorithm 9, a = 0): 6M + 2S + 1*b3.
template <class F = Fp254>
PT_FN xyz pt_dbl(const xyz& p) {
  fe t0 = PTT_M(p.y, p.y);
  fe z3 = PTT_A(PTT_A(t0, t0), PTT_A(t0, t0));
  z3 = PTT_A(z3, z3);
  fe t1 = PTT_M(p.y, p.z);
  fe t2 = mul_b3<F>(PTT_M(p.z, p.z));
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
