// panda_host — native CPU reference pipeline and C ABI of panda_tpu_torch.
//
// The port's own copy of panda_tpu/native/panda_host.cpp: the same C
// symbols, host pipeline and worker protocol.  It differs only where the
// port needs it to: the engine target starts panda_tpu_torch's worker
// (panda_tpu_torch.interop.worker), the package root is the one the
// port's build compiles in (or the nearest ancestor directory of this
// shared object that holds the port), and these comments name the port.
//
// The analog of the reference's host debug path
// (src/cuda/core/unit/msm/msm_host.cuh and
// field_host.cuh, exposed through the C ABI of panda_interface.cu): a fast
// independent CPU implementation of the MSM and NTT wire contracts, used
// as the `msm_host` execution path and as a test oracle at sizes where the
// pure-Python oracle is too slow.
//
// Design notes (own design, not a translation):
//  * 64-bit limbs with __uint128_t products, CIOS Montgomery multiply;
//    all Montgomery constants (n0inv, R^2, mont(1)) derived at runtime
//    from the modulus alone.
//  * Points use homogeneous projective coordinates with the complete
//    Renes-Costello-Batina a=0 formulas — the same formulas as the CUDA
//    kernels' (csrc/field.cuh), so the two implementations cross-check
//    each other while the Python big-int oracle stays fully independent.
//  * Wire format: little-endian Montgomery-form bytes, 32 bytes per
//    element (48 for the BLS12-377 base field), x||y affine points,
//    x||y||z results — matching tests/test.rs:72-101 of the reference.
//
// Build: panda_tpu_torch/interop/native.py compiles it with g++ at first
// use (-O3 -fPIC -shared -std=c++17 -Wall)
// into build/panda_tpu_torch/, and leaves a copy named libpanda_host.so in
// build/panda_tpu_torch/native/ for native callers to link.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

using u64 = uint64_t;
using u128 = unsigned __int128;

static constexpr int MAXL = 6;

struct Field {
  int L = 0;
  u64 mod[MAXL] = {0};
  u64 r2[MAXL] = {0};    // R^2 mod p (Montgomery form of R)
  u64 one[MAXL] = {0};   // R mod p (Montgomery form of 1)
  u64 n0inv = 0;         // -p^-1 mod 2^64

  int bytes() const { return L * 8; }
};

typedef u64 Limbs[MAXL];

static void fzero(const Field &f, u64 *o) { for (int i = 0; i < f.L; i++) o[i] = 0; }
static void fcopy(const Field &f, u64 *o, const u64 *a) { for (int i = 0; i < f.L; i++) o[i] = a[i]; }
static bool fis_zero(const Field &f, const u64 *a) {
  u64 acc = 0; for (int i = 0; i < f.L; i++) acc |= a[i]; return acc == 0;
}
static int fcmp(const Field &f, const u64 *a, const u64 *b) {
  for (int i = f.L - 1; i >= 0; i--) {
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  }
  return 0;
}

// o = a + b (raw, returns carry)
static u64 raw_add(const Field &f, u64 *o, const u64 *a, const u64 *b) {
  u128 c = 0;
  for (int i = 0; i < f.L; i++) {
    c += (u128)a[i] + b[i];
    o[i] = (u64)c;
    c >>= 64;
  }
  return (u64)c;
}

// o = a - b (raw, returns borrow)
static u64 raw_sub(const Field &f, u64 *o, const u64 *a, const u64 *b) {
  u64 borrow = 0;
  for (int i = 0; i < f.L; i++) {
    u64 bi = b[i] + borrow;
    u64 nb = (bi < b[i]) || (a[i] < bi);
    o[i] = a[i] - bi;
    borrow = nb;
  }
  return borrow;
}

static void fadd(const Field &f, u64 *o, const u64 *a, const u64 *b) {
  u64 carry = raw_add(f, o, a, b);
  u64 t[MAXL];
  if (carry || fcmp(f, o, f.mod) >= 0) {
    raw_sub(f, t, o, f.mod);
    fcopy(f, o, t);
  }
}

static void fsub(const Field &f, u64 *o, const u64 *a, const u64 *b) {
  u64 t[MAXL];
  if (raw_sub(f, t, a, b)) raw_add(f, t, t, f.mod);
  fcopy(f, o, t);
}

static void fneg(const Field &f, u64 *o, const u64 *a) {
  if (fis_zero(f, a)) { fcopy(f, o, a); return; }
  raw_sub(f, o, f.mod, a);
}

// CIOS Montgomery multiplication: o = a * b * R^-1 mod p, canonical [0, p).
static void fmul(const Field &f, u64 *o, const u64 *a, const u64 *b) {
  u64 t[MAXL + 2] = {0};
  for (int i = 0; i < f.L; i++) {
    u128 c = 0;
    for (int j = 0; j < f.L; j++) {
      c += (u128)t[j] + (u128)a[i] * b[j];
      t[j] = (u64)c;
      c >>= 64;
    }
    c += t[f.L];
    t[f.L] = (u64)c;
    t[f.L + 1] = (u64)(c >> 64);

    u64 m = t[0] * f.n0inv;
    c = (u128)t[0] + (u128)m * f.mod[0];
    c >>= 64;
    for (int j = 1; j < f.L; j++) {
      c += (u128)t[j] + (u128)m * f.mod[j];
      t[j - 1] = (u64)c;
      c >>= 64;
    }
    c += t[f.L];
    t[f.L - 1] = (u64)c;
    t[f.L] = t[f.L + 1] + (u64)(c >> 64);
  }
  if (t[f.L] || fcmp(f, t, f.mod) >= 0) raw_sub(f, t, t, f.mod);
  fcopy(f, o, t);
}

static void fsqr(const Field &f, u64 *o, const u64 *a) { fmul(f, o, a, a); }

// exponent given as limbs (little-endian), Montgomery base and result.
static void fpow(const Field &f, u64 *o, const u64 *base, const u64 *e, int elimbs) {
  u64 acc[MAXL];
  fcopy(f, acc, f.one);
  int top = elimbs * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) top--;
  for (int b = top; b >= 0; b--) {
    fsqr(f, acc, acc);
    if ((e[b / 64] >> (b % 64)) & 1) fmul(f, acc, acc, base);
  }
  fcopy(f, o, acc);
}

static void finv(const Field &f, u64 *o, const u64 *a) {
  u64 pm2[MAXL];
  u64 two[MAXL] = {2};
  raw_sub(f, pm2, f.mod, two);
  fpow(f, o, a, pm2, f.L);
}

static void field_init(Field &f, int L, const u64 *mod) {
  f.L = L;
  for (int i = 0; i < L; i++) f.mod[i] = mod[i];
  // n0inv = -mod[0]^-1 mod 2^64 via Newton iteration.
  u64 inv = 1;
  for (int i = 0; i < 6; i++) inv *= 2 - f.mod[0] * inv;
  f.n0inv = ~inv + 1;  // negate
  // one = R mod p by repeated doubling of 1 (64 L doublings).
  u64 t[MAXL] = {1};
  for (int i = 0; i < 64 * L; i++) fadd(f, t, t, t);
  fcopy(f, f.one, t);
  // r2 = R^2 mod p: double another 64 L times.
  for (int i = 0; i < 64 * L; i++) fadd(f, t, t, t);
  fcopy(f, f.r2, t);
}

// ---------------------------------------------------------------------------
// Curves
// ---------------------------------------------------------------------------

struct Curve {
  std::string name;
  Field fp, fr;
  u64 b3[MAXL];          // Montgomery form of 3*b
  // NTT parameters for fr
  u64 generator = 0;     // multiplicative generator (plain int)
  int two_adicity = 0;
};

struct Pt { u64 x[MAXL], y[MAXL], z[MAXL]; };

static void pt_identity(const Curve &c, Pt &p) {
  fzero(c.fp, p.x);
  fcopy(c.fp, p.y, c.fp.one);
  fzero(c.fp, p.z);
}

// Complete projective addition, RCB 2015 Algorithm 7 (a = 0).
static void pt_add(const Curve &cv, Pt &o, const Pt &P, const Pt &Q) {
  const Field &f = cv.fp;
  u64 t0[MAXL], t1[MAXL], t2[MAXL], t3[MAXL], t4[MAXL], t5[MAXL];
  u64 x3[MAXL], y3[MAXL], z3[MAXL], s[MAXL], u[MAXL];

  fmul(f, t0, P.x, Q.x);
  fmul(f, t1, P.y, Q.y);
  fmul(f, t2, P.z, Q.z);
  fadd(f, s, P.x, P.y); fadd(f, u, Q.x, Q.y); fmul(f, t3, s, u);
  fadd(f, s, t0, t1);   fsub(f, t3, t3, s);             // X1Y2 + X2Y1
  fadd(f, s, P.y, P.z); fadd(f, u, Q.y, Q.z); fmul(f, t4, s, u);
  fadd(f, s, t1, t2);   fsub(f, t4, t4, s);             // Y1Z2 + Y2Z1
  fadd(f, s, P.x, P.z); fadd(f, u, Q.x, Q.z); fmul(f, t5, s, u);
  fadd(f, s, t0, t2);   fsub(f, t5, t5, s);             // X1Z2 + X2Z1
  fadd(f, s, t0, t0);   fadd(f, t0, s, t0);             // 3 X1X2
  fmul(f, t2, t2, cv.b3);                               // b3 Z1Z2
  fadd(f, z3, t1, t2);                                  // Y1Y2 + b3Z1Z2
  fsub(f, t1, t1, t2);                                  // Y1Y2 - b3Z1Z2
  fmul(f, t5, t5, cv.b3);                               // b3(X1Z2+X2Z1)
  fmul(f, s, t3, t1); fmul(f, u, t4, t5); fsub(f, x3, s, u);
  fmul(f, s, t1, z3); fmul(f, u, t5, t0); fadd(f, y3, s, u);
  fmul(f, s, z3, t4); fmul(f, u, t0, t3); fadd(f, z3, s, u);
  fcopy(f, o.x, x3); fcopy(f, o.y, y3); fcopy(f, o.z, z3);
}

// ---------------------------------------------------------------------------
// Curve registry
// ---------------------------------------------------------------------------

static Curve *get_curve(const char *name) {
  static Curve bn254, bls377, bls381;
  static bool init_done = false;
  if (!init_done) {
    {
      // BN254: y^2 = x^3 + 3 (paramter.cuh:272), b3 = 9
      static const u64 fp_mod[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                                    0xb85045b68181585dULL, 0x30644e72e131a029ULL};
      static const u64 fr_mod[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                                    0xb85045b68181585dULL, 0x30644e72e131a029ULL};
      bn254.name = "bn254";
      field_init(bn254.fp, 4, fp_mod);
      field_init(bn254.fr, 4, fr_mod);
      u64 nine[MAXL] = {9};
      fmul(bn254.fp, bn254.b3, nine, bn254.fp.r2);
      bn254.generator = 7;      // paramter.cuh:246
      bn254.two_adicity = 28;   // paramter.cuh:242
    }
    {
      // BLS12-377: y^2 = x^3 + 1, b3 = 3
      static const u64 fp_mod[6] = {0x8508c00000000001ULL, 0x170b5d4430000000ULL,
                                    0x1ef3622fba094800ULL, 0x1a22d9f300f5138fULL,
                                    0xc63b05c06ca1493bULL, 0x01ae3a4617c510eaULL};
      static const u64 fr_mod[4] = {0x0a11800000000001ULL, 0x59aa76fed0000001ULL,
                                    0x60b44d1e5c37b001ULL, 0x12ab655e9a2ca556ULL};
      bls377.name = "bls12_377";
      field_init(bls377.fp, 6, fp_mod);
      field_init(bls377.fr, 4, fr_mod);
      u64 three[MAXL] = {3};
      fmul(bls377.fp, bls377.b3, three, bls377.fp.r2);
      bls377.generator = 22;
      bls377.two_adicity = 47;
    }
    {
      // BLS12-381: y^2 = x^3 + 4, b3 = 12 (the reference carries the
      // enum value only — curve.cuh:8-12; parameters wired here)
      static const u64 fp_mod[6] = {0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL,
                                    0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL,
                                    0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
      static const u64 fr_mod[4] = {0xffffffff00000001ULL, 0x53bda402fffe5bfeULL,
                                    0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL};
      bls381.name = "bls12_381";
      field_init(bls381.fp, 6, fp_mod);
      field_init(bls381.fr, 4, fr_mod);
      u64 twelve[MAXL] = {12};
      fmul(bls381.fp, bls381.b3, twelve, bls381.fp.r2);
      bls381.generator = 7;
      bls381.two_adicity = 32;
    }
    init_done = true;
  }
  if (!strcmp(name, "bn254")) return &bn254;
  if (!strcmp(name, "bls12_377")) return &bls377;
  if (!strcmp(name, "bls12_381")) return &bls381;
  return nullptr;
}

// ---------------------------------------------------------------------------
// Byte IO (LE wire format)
// ---------------------------------------------------------------------------

static void read_limbs(const Field &f, const unsigned char *p, u64 *o) {
  for (int i = 0; i < f.L; i++) {
    u64 v = 0;
    for (int b = 0; b < 8; b++) v |= (u64)p[i * 8 + b] << (8 * b);
    o[i] = v;
  }
}

static void write_limbs(const Field &f, unsigned char *p, const u64 *a) {
  for (int i = 0; i < f.L; i++)
    for (int b = 0; b < 8; b++) p[i * 8 + b] = (unsigned char)(a[i] >> (8 * b));
}

// ---------------------------------------------------------------------------
// Debug/test exports for the primitive layers
// ---------------------------------------------------------------------------

extern "C" int panda_field_mul_host(const char *curve_name, int use_fr,
                                    const unsigned char *a,
                                    const unsigned char *b,
                                    unsigned char *out) {
  Curve *cv = get_curve(curve_name);
  if (!cv) return 6;
  const Field &f = use_fr ? cv->fr : cv->fp;
  u64 av[MAXL], bv[MAXL], ov[MAXL];
  read_limbs(f, a, av);
  read_limbs(f, b, bv);
  fmul(f, ov, av, bv);
  write_limbs(f, out, ov);
  return 0;
}

extern "C" int panda_point_add_host(const char *curve_name,
                                    const unsigned char *p,
                                    const unsigned char *q,
                                    unsigned char *out) {
  Curve *cv = get_curve(curve_name);
  if (!cv) return 6;
  const Field &f = cv->fp;
  Pt P, Q, O;
  read_limbs(f, p, P.x);
  read_limbs(f, p + f.bytes(), P.y);
  read_limbs(f, p + 2 * f.bytes(), P.z);
  read_limbs(f, q, Q.x);
  read_limbs(f, q + f.bytes(), Q.y);
  read_limbs(f, q + 2 * f.bytes(), Q.z);
  pt_add(*cv, O, P, Q);
  write_limbs(f, out, O.x);
  write_limbs(f, out + f.bytes(), O.y);
  write_limbs(f, out + 2 * f.bytes(), O.z);
  return 0;
}

// ---------------------------------------------------------------------------
// MSM (Pippenger, bucket method with running-sum reduction)
// ---------------------------------------------------------------------------

static int window_bits_for(size_t n) {
  int k = 0;
  while (((size_t)1 << k) < n) k++;
  int c = k > 4 ? k - 3 : 1;
  return c > 16 ? 16 : c;
}

extern "C" int panda_msm_execute_host(const char *curve_name,
                                      const unsigned char *scalars, size_t slen,
                                      const unsigned char *bases, size_t blen,
                                      unsigned char *out, int coord_type) {
  Curve *cv = get_curve(curve_name);
  if (!cv) return 6;  // UNSUPPORTED_CURVE
  const Field &fp = cv->fp, &fr = cv->fr;
  size_t sbytes = (size_t)fr.bytes(), pbytes = (size_t)fp.bytes() * 2;
  if (slen % sbytes || blen % pbytes) return 5;  // INVALID_CONFIGURATION
  size_t n = slen / sbytes;
  if (n == 0 || n != blen / pbytes) return 5;

  // Scalars arrive Montgomery-form; convert out (msm_cuda.cuh:148-157).
  std::vector<u64> sc(n * fr.L);
  u64 unit[MAXL] = {1};
  for (size_t i = 0; i < n; i++) {
    u64 m[MAXL];
    read_limbs(fr, scalars + i * sbytes, m);
    fmul(fr, &sc[i * fr.L], m, unit);
  }
  std::vector<Pt> pts(n);
  for (size_t i = 0; i < n; i++) {
    read_limbs(fp, bases + i * pbytes, pts[i].x);
    read_limbs(fp, bases + i * pbytes + fp.bytes(), pts[i].y);
    fcopy(fp, pts[i].z, fp.one);
  }

  int c = window_bits_for(n);
  int scalar_bits = fr.L * 64;
  int windows = (scalar_bits + c - 1) / c;
  size_t nbuckets = (size_t)1 << c;

  Pt result;
  pt_identity(*cv, result);
  std::vector<Pt> buckets(nbuckets);
  for (int w = windows - 1; w >= 0; w--) {
    for (int d = 0; d < c; d++) pt_add(*cv, result, result, result);
    for (auto &b : buckets) pt_identity(*cv, b);
    for (size_t i = 0; i < n; i++) {
      int lo = w * c;
      int limb = lo / 64, sh = lo % 64;
      u64 digit = sc[i * fr.L + limb] >> sh;
      if (sh + c > 64 && limb + 1 < fr.L)
        digit |= sc[i * fr.L + limb + 1] << (64 - sh);
      digit &= (nbuckets - 1);
      if (digit) pt_add(*cv, buckets[digit], buckets[digit], pts[i]);
    }
    // running-sum reduction: sum_d d*B_d
    Pt running, acc;
    pt_identity(*cv, running);
    pt_identity(*cv, acc);
    for (size_t d = nbuckets - 1; d >= 1; d--) {
      pt_add(*cv, running, running, buckets[d]);
      pt_add(*cv, acc, acc, running);
    }
    pt_add(*cv, result, result, acc);
  }

  // Serialize: Jacobian (X*Z, Y*Z^2, Z) or homogeneous projective.
  u64 a[MAXL], b[MAXL], z2[MAXL];
  if (coord_type == 0) {
    fmul(fp, a, result.x, result.z);
    fsqr(fp, z2, result.z);
    fmul(fp, b, result.y, z2);
    write_limbs(fp, out, a);
    write_limbs(fp, out + fp.bytes(), b);
    write_limbs(fp, out + 2 * fp.bytes(), result.z);
  } else {
    write_limbs(fp, out, result.x);
    write_limbs(fp, out + fp.bytes(), result.y);
    write_limbs(fp, out + 2 * fp.bytes(), result.z);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// NTT (iterative DIT, bit-reversed input)
// ---------------------------------------------------------------------------

static void root_of_unity(const Curve &cv, int log_n, u64 *o_mont) {
  const Field &fr = cv.fr;
  // omega = generator ^ ((p - 1) >> log_n)
  u64 e[MAXL];
  u64 one[MAXL] = {1};
  raw_sub(fr, e, fr.mod, one);
  for (int i = 0; i < log_n; i++) {  // e >>= 1
    for (int j = 0; j < fr.L; j++) {
      u64 hi = (j + 1 < fr.L) ? (e[j + 1] << 63) : 0;
      e[j] = (e[j] >> 1) | hi;
    }
  }
  u64 g[MAXL] = {cv.generator};
  u64 gm[MAXL];
  fmul(fr, gm, g, fr.r2);
  fpow(fr, o_mont, gm, e, fr.L);
}

extern "C" int panda_ntt_execute_host(const char *curve_name,
                                      unsigned char *data, size_t len,
                                      unsigned int log_n,
                                      const unsigned char *omega_bytes,
                                      int inverse) {
  Curve *cv = get_curve(curve_name);
  if (!cv) return 6;
  const Field &fr = cv->fr;
  size_t n = (size_t)1 << log_n;
  if (len != n * fr.bytes()) return 5;
  if ((int)log_n > cv->two_adicity) return 7;  // UNSUPPORTED_SIZE

  u64 omega[MAXL];
  if (omega_bytes) read_limbs(fr, omega_bytes, omega);
  else root_of_unity(*cv, log_n, omega);
  if (inverse) finv(fr, omega, omega);

  std::vector<u64> x(n * fr.L);
  for (size_t i = 0; i < n; i++) read_limbs(fr, data + i * fr.bytes(), &x[i * fr.L]);

  // bit-reversal permutation
  for (size_t i = 0; i < n; i++) {
    size_t r = 0, v = i;
    for (unsigned b = 0; b < log_n; b++) { r = (r << 1) | (v & 1); v >>= 1; }
    if (r > i)
      for (int j = 0; j < fr.L; j++) std::swap(x[i * fr.L + j], x[r * fr.L + j]);
  }
  // stages
  for (size_t m = 1; m < n; m <<= 1) {
    // w_m = omega^(n / (2m))
    u64 wm[MAXL];
    fcopy(fr, wm, omega);
    for (size_t s = n / (2 * m); s > 1; s >>= 1) fsqr(fr, wm, wm);
    for (size_t g = 0; g < n; g += 2 * m) {
      u64 w[MAXL];
      fcopy(fr, w, fr.one);
      for (size_t j = 0; j < m; j++) {
        u64 *u = &x[(g + j) * fr.L];
        u64 *v = &x[(g + j + m) * fr.L];
        u64 t[MAXL], s2[MAXL];
        fmul(fr, t, v, w);
        fadd(fr, s2, u, t);
        fsub(fr, v, u, t);
        fcopy(fr, u, s2);
        fmul(fr, w, w, wm);
      }
    }
  }
  if (inverse) {
    // scale by n^-1
    u64 nv[MAXL] = {0};
    // n as an integer may exceed 64 bits only for log_n >= 64: safe.
    nv[0] = (u64)n;
    u64 nm[MAXL], ninv[MAXL];
    fmul(fr, nm, nv, fr.r2);
    finv(fr, ninv, nm);
    for (size_t i = 0; i < n; i++) fmul(fr, &x[i * fr.L], &x[i * fr.L], ninv);
  }
  for (size_t i = 0; i < n; i++) write_limbs(fr, data + i * fr.bytes(), &x[i * fr.L]);
  return 0;
}

// ---------------------------------------------------------------------------
// Session API — native analog of the reference's manager surface
// (PandaGpuManager, src/gpu_manager/wrapper.rs:8-353, and
// the C handles of panda_interface.cuh:18-31).  A session pins a curve,
// holds cached bases/scalars blobs (wrapper.rs d_bases/d_scalars), and the
// result-coordinate config (wrapper.rs:212-214).  Thread-compatible: one
// session per thread, like the reference's manager object.
// ---------------------------------------------------------------------------

#include <cstring>
#include <string>

#include <csignal>
#include <dlfcn.h>
#include <sys/wait.h>
#include <unistd.h>

// Execution targets: HOST runs the in-process CPU pipeline above; ENGINE
// dispatches to the accelerated engine through a long-lived worker
// subprocess (panda_tpu_torch/interop/worker.py, on the GPU).  The worker
// boundary stands where the reference's C-ABI-to-CUDA-unit dispatch
// (panda_interface.cu:152-191) does: a non-Python prover linking this
// library gets GPU-computed results byte-identical to the Python byte API.
enum panda_execution_target { PANDA_TARGET_HOST = 0, PANDA_TARGET_ENGINE = 1 };

struct panda_session {
  std::string curve;
  int coord_type = 0;  // 0 = Jacobian, 1 = Projective
  int target = PANDA_TARGET_HOST;
  std::vector<std::vector<unsigned char>> bases;
  std::vector<std::vector<unsigned char>> scalars;
  // worker process state (ENGINE target)
  pid_t worker_pid = -1;
  int to_worker = -1;    // write end
  int from_worker = -1;  // read end
};

// ---- worker process plumbing ----------------------------------------------

static bool write_all(int fd, const void *buf, size_t n) {
  const unsigned char *p = (const unsigned char *)buf;
  while (n) {
    ssize_t w = write(fd, p, n);
    if (w <= 0) return false;
    p += w;
    n -= (size_t)w;
  }
  return true;
}

static bool read_all(int fd, void *buf, size_t n) {
  unsigned char *p = (unsigned char *)buf;
  while (n) {
    ssize_t r = read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

// Package root = the nearest ancestor directory of this shared object that
// holds panda_tpu_torch/ (the build leaves it under build/panda_tpu_torch/
// at the repository root), so the worker import works without an installed
// package.  PANDA_WORKER_PYTHON overrides the interpreter.
static bool holds_port(const std::string &dir) {
  return access((dir + "/panda_tpu_torch/interop/worker.py").c_str(),
                R_OK) == 0;
}

static std::string package_root() {
  Dl_info info;
  if (!dladdr((void *)&package_root, &info) || !info.dli_fname) return "";
  std::string p(info.dli_fname);
  for (;;) {
    size_t k = p.find_last_of('/');
    if (k == std::string::npos) return "";
    p.resize(k);
    if (holds_port(p)) return p;
  }
}

static int worker_spawn(panda_session *s) {
  if (s->worker_pid > 0) return 0;
  // A worker that died mid-call must surface as rc=9, not SIGPIPE-kill
  // the caller.  Only replace the default disposition — a host app's own
  // SIGPIPE handler is left alone.
  struct sigaction sa;
  if (sigaction(SIGPIPE, nullptr, &sa) == 0 && sa.sa_handler == SIG_DFL) {
    sa.sa_handler = SIG_IGN;
    sigaction(SIGPIPE, &sa, nullptr);
  }
  int in_pipe[2], out_pipe[2];  // parent->child, child->parent
  if (pipe(in_pipe) != 0) return 2;
  if (pipe(out_pipe) != 0) {
    close(in_pipe[0]); close(in_pipe[1]);
    return 2;
  }
  pid_t pid = fork();
  if (pid < 0) {
    close(in_pipe[0]); close(in_pipe[1]);
    close(out_pipe[0]); close(out_pipe[1]);
    return 2;
  }
  if (pid == 0) {  // child: stdin/stdout are the protocol pipes
    dup2(in_pipe[0], 0);
    dup2(out_pipe[1], 1);
    close(in_pipe[0]); close(in_pipe[1]);
    close(out_pipe[0]); close(out_pipe[1]);
    std::string root = package_root();
    if (!root.empty()) {
      const char *pp = getenv("PYTHONPATH");
      std::string val = pp && *pp ? root + ":" + pp : root;
      setenv("PYTHONPATH", val.c_str(), 1);
    }
    const char *py = getenv("PANDA_WORKER_PYTHON");
    if (!py || !*py) py = "python3";
    execlp(py, py, "-m", "panda_tpu_torch.interop.worker", (char *)nullptr);
    _exit(127);
  }
  close(in_pipe[0]);
  close(out_pipe[1]);
  s->worker_pid = pid;
  s->to_worker = in_pipe[1];
  s->from_worker = out_pipe[0];
  return 0;
}

static void worker_shutdown(panda_session *s) {
  if (s->worker_pid <= 0) return;
  close(s->to_worker);    // EOF -> worker exits cleanly
  close(s->from_worker);
  int status;
  waitpid(s->worker_pid, &status, 0);
  s->worker_pid = -1;
  s->to_worker = s->from_worker = -1;
}

// One request/reply round trip; returns a PandaError code.  ``out`` is
// resized to the reply payload.  Distinguishable failures get distinct
// codes (the reference's enum spreads CUDA-runtime failures over 30
// variants, gpu_ffi/common.rs:6-38; the worker boundary has three):
//   MEMORY_ALLOCATION (2)  spawn failure (pipe/fork resources),
//   NOT_READY         (3)  worker process died mid-call (pipe EOF) —
//                          the dead worker is reaped so the next call
//                          respawns a fresh one,
//   INTERNAL          (9)  protocol violation (reply shape) — callers
//                          check payload sizes and return 9 themselves;
// an engine EXCEPTION arrives as the worker's own named code.
static int worker_call(panda_session *s, uint32_t cmd,
                       const std::vector<std::vector<unsigned char>> &body,
                       std::vector<unsigned char> &out) {
  int rc = worker_spawn(s);
  if (rc) return rc;  // 2 = MEMORY_ALLOCATION: could not spawn
  uint32_t clen = (uint32_t)s->curve.size();
  if (!write_all(s->to_worker, &cmd, 4) ||
      !write_all(s->to_worker, &clen, 4) ||
      !write_all(s->to_worker, s->curve.data(), clen)) {
    worker_shutdown(s);
    return 3;  // NOT_READY: worker gone
  }
  for (const auto &part : body)
    if (!write_all(s->to_worker, part.data(), part.size())) {
      worker_shutdown(s);
      return 3;
    }
  int32_t code;
  uint64_t outlen;
  if (!read_all(s->from_worker, &code, 4) ||
      !read_all(s->from_worker, &outlen, 8)) {
    worker_shutdown(s);
    return 3;  // NOT_READY: worker died before replying
  }
  out.resize(outlen);
  if (outlen && !read_all(s->from_worker, out.data(), outlen)) {
    worker_shutdown(s);
    return 3;
  }
  return code;
}

static std::vector<unsigned char> le64(uint64_t v) {
  std::vector<unsigned char> b(8);
  memcpy(b.data(), &v, 8);
  return b;
}

static std::vector<unsigned char> le32x(std::initializer_list<uint32_t> vs) {
  std::vector<unsigned char> b;
  for (uint32_t v : vs) {
    unsigned char w[4];
    memcpy(w, &v, 4);
    b.insert(b.end(), w, w + 4);
  }
  return b;
}

extern "C" int panda_get_device_number(int *count) {
  // Host pipeline: one "device" (the CPU), mirroring panda_interface.cu:11.
  if (!count) return 1;  // INVALID_VALUE
  *count = 1;
  return 0;
}

extern "C" panda_session *panda_session_create(const char *curve_name) {
  if (!get_curve(curve_name)) return nullptr;
  auto *s = new panda_session();
  s->curve = curve_name;
  return s;
}

extern "C" void panda_session_destroy(panda_session *s) {
  if (!s) return;
  worker_shutdown(s);
  delete s;
}

extern "C" int panda_session_set_config(panda_session *s, int coord_type) {
  if (!s || (coord_type != 0 && coord_type != 1)) return 1;  // INVALID_VALUE
  s->coord_type = coord_type;
  return 0;
}

// Select where this session executes: 0 = in-process CPU host pipeline
// (default), 1 = the accelerated engine via the worker subprocess.  The
// reference's C ABI reaches its accelerated units in-process
// (panda_interface.cu:152-170); here the engine lives in the PyTorch
// runtime, so the dispatch crosses a pipe instead of a CUDA context.
extern "C" int panda_session_set_execution_target(panda_session *s,
                                                  int target) {
  if (!s || (target != PANDA_TARGET_HOST && target != PANDA_TARGET_ENGINE))
    return 1;  // INVALID_VALUE
  s->target = target;
  return 0;
}

// Eagerly start (and ping) the engine worker so spawn/import errors
// surface at init time rather than inside the first MSM call.
extern "C" int panda_session_engine_warmup(panda_session *s) {
  if (!s) return 8;
  std::vector<unsigned char> out;
  return worker_call(s, 0, {}, out);
}

// Cache a bases blob; returns the cache index (wrapper.rs:154) or -1.
extern "C" long panda_session_cache_bases(panda_session *s,
                                          const unsigned char *bases,
                                          size_t blen) {
  if (!s) return -1;
  Curve *cv = get_curve(s->curve.c_str());
  if (blen == 0 || blen % ((size_t)cv->fp.bytes() * 2)) return -1;
  s->bases.emplace_back(bases, bases + blen);
  return (long)(s->bases.size() - 1);
}

// Cache a scalars blob; returns the cache index (wrapper.rs:171) or -1.
extern "C" long panda_session_cache_scalars(panda_session *s,
                                            const unsigned char *scalars,
                                            size_t slen) {
  if (!s) return -1;
  Curve *cv = get_curve(s->curve.c_str());
  if (slen == 0 || slen % (size_t)cv->fr.bytes()) return -1;
  s->scalars.emplace_back(scalars, scalars + slen);
  return (long)(s->scalars.size() - 1);
}

static int session_msm_dispatch(panda_session *s,
                                const unsigned char *scalars, size_t slen,
                                const unsigned char *bases, size_t blen,
                                unsigned char *out) {
  if (s->target == PANDA_TARGET_ENGINE) {
    Curve *cv = get_curve(s->curve.c_str());
    std::vector<unsigned char> body, reply;
    auto sl = le64(slen), bl = le64(blen);
    body.insert(body.end(), sl.begin(), sl.end());
    body.insert(body.end(), scalars, scalars + slen);
    body.insert(body.end(), bl.begin(), bl.end());
    body.insert(body.end(), bases, bases + blen);
    int rc = worker_call(s, 1, {body}, reply);
    if (rc) return rc;
    size_t want = (size_t)cv->fp.bytes() * 3;
    if (reply.size() != want) return 9;
    memcpy(out, reply.data(), want);
    return 0;
  }
  return panda_msm_execute_host(s->curve.c_str(), scalars, slen, bases, blen,
                                out, s->coord_type);
}

extern "C" int panda_session_msm(panda_session *s,
                                 const unsigned char *scalars, size_t slen,
                                 const unsigned char *bases, size_t blen,
                                 unsigned char *out) {
  if (!s) return 8;  // NOT_INITIALIZED
  return session_msm_dispatch(s, scalars, slen, bases, blen, out);
}

// MSM with cached inputs (unit.rs:103/190/277); pass -1 to use fresh bytes.
extern "C" int panda_session_msm_cached(panda_session *s,
                                        long scalars_index, long bases_index,
                                        const unsigned char *scalars,
                                        size_t slen,
                                        const unsigned char *bases,
                                        size_t blen, unsigned char *out) {
  if (!s) return 8;
  if (scalars_index >= 0) {
    if ((size_t)scalars_index >= s->scalars.size()) return 1;  // INVALID_VALUE
    scalars = s->scalars[scalars_index].data();
    slen = s->scalars[scalars_index].size();
  }
  if (bases_index >= 0) {
    if ((size_t)bases_index >= s->bases.size()) return 1;
    bases = s->bases[bases_index].data();
    blen = s->bases[bases_index].size();
  }
  return session_msm_dispatch(s, scalars, slen, bases, blen, out);
}

extern "C" int panda_session_ntt(panda_session *s, unsigned char *data,
                                 size_t len, unsigned int log_n,
                                 const unsigned char *omega, int inverse) {
  if (!s) return 8;
  if (s->target == PANDA_TARGET_ENGINE) {
    Curve *cv = get_curve(s->curve.c_str());
    std::vector<unsigned char> body, reply;
    auto hdr = le32x({log_n, (uint32_t)(inverse ? 1 : 0),
                      (uint32_t)(omega ? 1 : 0)});
    body.insert(body.end(), hdr.begin(), hdr.end());
    if (omega)
      body.insert(body.end(), omega, omega + cv->fr.bytes());
    auto dl = le64(len);
    body.insert(body.end(), dl.begin(), dl.end());
    body.insert(body.end(), data, data + len);
    int rc = worker_call(s, 2, {body}, reply);
    if (rc) return rc;
    if (reply.size() != len) return 9;
    memcpy(data, reply.data(), len);  // in-place, like the host path
    return 0;
  }
  return panda_ntt_execute_host(s->curve.c_str(), data, len, log_n, omega,
                                inverse);
}
