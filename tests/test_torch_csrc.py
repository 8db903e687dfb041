"""The CUDA sources' arithmetic, compiled for the host, against the plain
versions.

``csrc/field.cuh`` emulates each PTX carry primitive exactly on the host,
and every kernel's per-thread body is a plain function outside the
``__CUDACC__`` block, so a host C++ compiler builds the same code the GPU
runs, minus the launch.  Each body is held bit for bit against its plain
PyTorch version on the same inputs; the launches themselves run only on the
GPU (``chip_smoke.py``).
"""

import ctypes
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu_torch.curves import point as cp
from panda_tpu_torch.curves.config import BLS12_377, BLS12_381, BN254
from panda_tpu_torch.curves.point import AffinePoint, ProjPoint
from panda_tpu_torch.fields import mont
from panda_tpu_torch.fields.config import (BLS12_377_FR, BLS12_381_FR,
                                           BN254_FP, BN254_FR)
from panda_tpu_torch.ops import (_ext, digits, fmul, hist, msm, ntt_fused,
                                 ntt_pallas, phase_a, reduce)
from panda_tpu_torch.reference import curve_ref
from panda_tpu_torch.tools import profile_gather4

CSRC = _ext.CSRC
NTT_FIELDS = pytest.mark.parametrize("fr", [BN254_FR, BLS12_377_FR,
                                            BLS12_381_FR],
                                     ids=lambda f: f.name)
BLS_CURVES = pytest.mark.parametrize("curve", [BLS12_377, BLS12_381],
                                     ids=lambda c: c.name)
HARNESS = r"""
#include "point_ops.cu"
#include "digits.cu"
#include "hist.cu"
#include "phase_a.cu"
#include "buckets.cu"
#include "wscan.cu"
#include "fmul.cu"
#include "dft.cu"
#include "small_ntt.cu"
#include "dg3.cu"
#include <vector>
using namespace ptt;
typedef const uint32_t* In;
typedef uint32_t* Out;

template <class F>
void fmul_all(In a, In b, Out r, int64_t n, int canonical_out) {
  for (int64_t i = 0; i < n; ++i) fmul_elem<F>(a, b, r, i, n, canonical_out);
}
// small_ntt.cu's launch on the host: every block's tiles, each phase
// thread by thread (the build's r and threads; `resident` threads a wave).
template <class F>
void small_ntt_all(In x, In tw, In pre, In scale, Out out, int64_t nb,
                   int log_k, int64_t run, int64_t pre_cols, int reduce_in,
                   int canonical_out, int resident) {
  const small_ntt_args a{x, tw, pre, scale, out, nb, run, pre_cols,
                         pre ? nb / pre_cols : 1, log_k, reduce_in,
                         canonical_out};
  const int r = small_ntt_r(log_k), T = kNttThreads;
  const int64_t blocks =
      even_blocks(small_ntt_geometry(log_k, nb, r, T).tiles, resident, T);
  for (int64_t b = 0; b < blocks; ++b) {
    if (r == kNttR)
      small_ntt_block_host<F, kNttR>(a, b, blocks, T);
    else
      small_ntt_block_host<F, 2>(a, b, blocks, T);
  }
}

// dg3.cu's launch on the host: every block's slices, each phase thread by
// thread, with an H100's 232448 bytes of shared memory a block.
constexpr int64_t kHostSmemMax = 232448;
void dg3_all(const int32_t* tab, const int32_t* idx, int32_t* out, int64_t G,
             int R, int resident) {
  const dg3_geom geo = dg3_geometry(G, R, kDg3SliceWords, kHostSmemMax);
  const int64_t blocks = even_blocks(geo.slices, resident, kDg3Threads);
  for (int64_t b = 0; b < blocks; ++b) {
    if (geo.ring == 1)
      dg3_block_host<1>(tab, idx, out, G, R, geo, b, blocks, kDg3Threads);
    else
      dg3_block_host<kDg3Ring>(tab, idx, out, G, R, geo, b, blocks,
                               kDg3Threads);
  }
}

template <class F>
void fp_all(int op, In a, In b, Out r, int64_t n) {
  constexpr int N = F::N;
  for (int64_t i = 0; i < n; ++i) {
    fe_t<N> x = load_fe<N>(a, i, n), y = load_fe<N>(b, i, n);
    fe_t<N> z = op == 0 ? mont_mul<F>(x, y)
              : op == 1 ? add_mod<F>(x, y) : sub_mod<F>(x, y);
    store_fe(r, i, n, z);
  }
}
// An NTT kernel's body for field id `id` in the order of _ext.NTT_FIELDS.
template <template <class> class Body, class... A>
void by_field(int id, A... a) {
  if (id == 0) Body<Fr254>::run(a...);
  else if (id == 1) Body<Fr377>::run(a...);
  else Body<Fr381>::run(a...);
}
template <class F> struct Fmul {
  static void run(In a, In b, Out r, int64_t n, int canonical_out) {
    fmul_all<F>(a, b, r, n, canonical_out);
  }
};
template <class F> struct Dft {
  static void run(In x, In mat, Out out, int64_t nb, int K,
                  int canonical_out) {
    dft_host<F>(x, mat, out, nb, K, canonical_out);
  }
};
template <class F> struct SmallNtt {
  static void run(In x, In tw, In pre, In scale, Out out, int64_t nb,
                  int log_k, int64_t run, int64_t pre_cols, int reduce_in,
                  int canonical_out, int resident) {
    small_ntt_all<F>(x, tw, pre, scale, out, nb, log_k, run, pre_cols,
                     reduce_in, canonical_out, resident);
  }
};
// Each MSM body over every element, for curve (or scalar-field) id `id` in
// the order of _ext.MSM_CURVES (MSM_FIELDS).
template <template <class> class Body, class... A>
void by_curve(int id, A... a) {
  if (id == 0) Body<Bn254>::run(a...);
  else if (id == 1) Body<Bls12_377>::run(a...);
  else Body<Bls12_381>::run(a...);
}
// point_ops.cu's launch on the host: each of `threads` threads one after
// another.
template <class Op>
void point_all(const Op& op, int64_t threads) {
  for (int64_t t = 0; t < threads; ++t) point_thread(op, t, threads);
}
template <class C> struct Padd {
  static void run(In px, In py, In pz, In qx, In qy, In qz, Out rx, Out ry,
                  Out rz, int64_t n, int64_t threads) {
    point_all(PaddOp<C>{{px, py, pz}, {qx, qy, qz}, {rx, ry, rz}, n},
              threads);
  }
};
template <class C> struct Pmadd {
  static void run(In px, In py, In pz, In qx, In qy, Out rx, Out ry, Out rz,
                  int64_t n, int64_t threads) {
    point_all(PmaddOp<C>{{px, py, pz}, qx, qy, {rx, ry, rz}, n}, threads);
  }
};
template <class C> struct Pdbl {
  static void run(In px, In py, In pz, Out rx, Out ry, Out rz, int64_t n,
                  int k, int64_t threads) {
    point_all(PdblOp<C>{{px, py, pz}, {rx, ry, rz}, n, k}, threads);
  }
};
template <class C> struct Digits {
  static void run(In s, Out mags, uint8_t* negs, int64_t n, int c, int W) {
    for (int64_t j = 0; j < n; ++j)
      digits_elem<typename C::Fr>(s, mags, negs, j, n, c, W);
  }
};
// A launch's lanes on the host, in blocks of T, with a ring R steps deep:
// each thread runs its lane with the block's ring and a copy policy of its
// own (csrc/phase_a.cu's host RingCopy, whose copies land when a wait
// releases their group); the ring starts as 0xA5 filler and keeps the
// previous block's words.
template <int R, class C>
void phase_a_host(In keys, In sidx, In pts, Out ek, Out ex, Out ey, Out ez,
                  Out tk, Out tx, Out ty, Out tz, int64_t W, int64_t m,
                  int64_t S, int dead, int T) {
  std::vector<uint32_t> ring(phase_a_ring_words(R, T, C::Fp::N),
                             0xA5A5A5A5u);
  uint32_t* kring = ring.data() + (int64_t)R * T * 2 * C::Fp::N;
  for (int64_t l = 0; l < W * m; ++l) {
    RingCopy cp;
    phase_a_lane<R, C>(keys, sidx, pts, ek, ex, ey, ez, tk, tx, ty, tz, l, m,
                       S, W * m, (uint32_t)dead, ring.data(), kring,
                       (int)(l % T), T, cp);
  }
}
template <class C> struct PhaseA {
  static void run(In keys, In sidx, In pts, Out ek, Out ex, Out ey, Out ez,
                  Out tk, Out tx, Out ty, Out tz, int64_t W, int64_t m,
                  int64_t S, int dead, int depth, int T) {
    switch (depth) {
#define PTT_RING(R)                                                          \
  case R:                                                                    \
    return phase_a_host<R, C>(keys, sidx, pts, ek, ex, ey, ez, tk, tx, ty,   \
                              tz, W, m, S, dead, T);
      PTT_RING(1) PTT_RING(2) PTT_RING(4) PTT_RING(8)
#undef PTT_RING
    }
  }
};
// buckets.cu's launch 1 block by block, or launch 2's threads one after
// another.
template <class C> struct Buckets {
  static void run(In ex, In ey, In ez, In ekeys, In tx, In ty, In tz,
                  In tkeys, const int64_t* hi, Out ox, Out oy, Out oz,
                  int64_t W, int64_t S, int64_t m, int64_t G, int D,
                  int chunk, int T, int fill) {
    const bk_tables tb{{ex, ey, ez}, ekeys, hi, {ox, oy, oz}, W, S, m, D};
    if (!fill) return bk_tails_host<C>({tx, ty, tz}, tkeys, tb, chunk, T, G);
    for (int64_t i = 0; i < W * D; ++i) bk_fill_elem<C>(tb, tkeys, i);
  }
};
template <class C> struct Wscan {
  static void run(In xx, In xy, In xz, In px, In py, In pz, Out Px, Out Py,
                  Out Pz, Out Xx, Out Xy, Out Xz, int64_t W, int64_t E,
                  int64_t NB, int seg, int T, int base) {
    wscan_level_host<C>({xx, xy, xz}, {px, py, pz}, {Px, Py, Pz},
                        {Xx, Xy, Xz}, W, E, NB, seg, T, base);
  }
};

template <class F> struct MulWide {
  static void run(In a, In b, Out r, int64_t n) {
    constexpr int N = F::N;
    for (int64_t i = 0; i < n; ++i) {
      const fe_t<N> x = load_fe<N>(a, i, n), y = load_fe<N>(b, i, n);
      store_fe(r, i, n, mont_mul_wide<F>(x, y));
      store_fe(r + N * n, i, n, mont_mul<F>(x, y));
    }
  }
};

extern "C" {
// field: 0 Fp254, 1 Fp377, 2 Fp381, 3 Fr381; op: 0 mont_mul, 1 add_mod,
// 2 sub_mod
void h_fp(int op, int field, In a, In b, Out r, int64_t n) {
  if (field == 0) fp_all<Fp254>(op, a, b, r, n);
  else if (field == 1) fp_all<Fp377>(op, a, b, r, n);
  else if (field == 2) fp_all<Fp381>(op, a, b, r, n);
  else fp_all<Fr381>(op, a, b, r, n);
}
// mont_mul_wide's and mont_mul's products of NTT field `field`: (16, n).
void h_mul_wide(In a, In b, Out r, int64_t n, int field) {
  by_field<MulWide>(field, a, b, r, n);
}
// The same for base field `field` (0 Fp254, 1 Fp377, 2 Fp381): (2 N, n).
void h_mul_wide_fp(In a, In b, Out r, int64_t n, int field) {
  if (field == 0) MulWide<Fp254>::run(a, b, r, n);
  else if (field == 1) MulWide<Fp377>::run(a, b, r, n);
  else MulWide<Fp381>::run(a, b, r, n);
}
void h_reduce_wide_fr381(In a, Out r, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    store_fe(r, i, n, reduce_wide<Fr381>(load_fe(a, i, n)));
}
// point_ops.cu's launchers over `threads` threads.
void h_padd(In px, In py, In pz, In qx, In qy, In qz, Out rx, Out ry, Out rz,
            int64_t n, int64_t threads, int curve) {
  by_curve<Padd>(curve, px, py, pz, qx, qy, qz, rx, ry, rz, n, threads);
}
void h_pmadd(In px, In py, In pz, In qx, In qy, Out rx, Out ry, Out rz,
             int64_t n, int64_t threads, int curve) {
  by_curve<Pmadd>(curve, px, py, pz, qx, qy, rx, ry, rz, n, threads);
}
void h_pdbl(In px, In py, In pz, Out rx, Out ry, Out rz, int64_t n, int k,
            int64_t threads, int curve) {
  by_curve<Pdbl>(curve, px, py, pz, rx, ry, rz, n, k, threads);
}
void h_digits(In s, Out mags, uint8_t* negs, int64_t n, int c, int W,
              int field) {
  by_curve<Digits>(field, s, mags, negs, n, c, W);
}
// The kernel's W * G blocks of T threads one after another.
void h_hist(In d, int32_t* counts, int64_t W, int64_t N, int D, int64_t G,
            int T, int unroll) {
  for (int64_t blk = 0; blk < W * G; ++blk)
    hist_block_host(d, counts, N, D, G, blk, T, unroll);
}
void h_buckets(In ex, In ey, In ez, In ekeys, In tx, In ty, In tz,
               In tkeys, const int64_t* hi, Out ox, Out oy, Out oz, int64_t W,
               int64_t S, int64_t m, int64_t G, int D, int chunk, int T,
               int fill, int curve) {
  by_curve<Buckets>(curve, ex, ey, ez, ekeys, tx, ty, tz, tkeys, hi, ox, oy,
                    oz, W, S, m, G, D, chunk, T, fill);
}
void h_phase_a(In keys, In sidx, In pts, Out ek, Out ex, Out ey, Out ez,
               Out tk, Out tx, Out ty, Out tz, int64_t W, int64_t m,
               int64_t S, int dead, int depth, int T, int curve) {
  by_curve<PhaseA>(curve, keys, sidx, pts, ek, ex, ey, ez, tk, tx, ty, tz, W,
                   m, S, dead, depth, T);
}
void h_wscan_level(In xx, In xy, In xz, In px, In py, In pz, Out Px, Out Py,
                   Out Pz, Out Xx, Out Xy, Out Xz, int64_t W, int64_t E,
                   int64_t NB, int seg, int T, int base, int curve) {
  by_curve<Wscan>(curve, xx, xy, xz, px, py, pz, Px, Py, Pz, Xx, Xy, Xz, W, E,
                  NB, seg, T, base);
}
void h_fmul(In a, In b, Out r, int64_t n, int canonical_out, int field) {
  by_field<Fmul>(field, a, b, r, n, canonical_out);
}
void h_dft(In x, In mat, Out out, int64_t nb, int K, int canonical_out,
           int field) {
  by_field<Dft>(field, x, mat, out, nb, K, canonical_out);
}
void h_small_ntt(In x, In tw, In pre, In scale, Out out, int64_t nb,
                 int log_k, int64_t run, int64_t pre_cols, int reduce_in,
                 int canonical_out, int resident, int field) {
  by_field<SmallNtt>(field, x, tw, pre, scale, out, nb, log_k, run,
                     pre_cols, reduce_in, canonical_out, resident);
}
// {r, rounds, columns a tile, tiles, blocks} of a small_ntt launch.
void h_small_ntt_geometry(int log_k, int64_t nb, int resident,
                          int64_t* out) {
  const int r = small_ntt_r(log_k);
  const small_ntt_geom g = small_ntt_geometry(log_k, nb, r, kNttThreads);
  out[0] = r, out[1] = g.rounds, out[2] = g.tc, out[3] = g.tiles;
  out[4] = even_blocks(g.tiles, resident, kNttThreads);
}
void h_dg3(const int32_t* tab, const int32_t* idx, int32_t* out, int64_t G,
           int R, int resident) {
  dg3_all(tab, idx, out, G, R, resident);
}
// {columns a slice, g a slice, slices, blocks, ring stages} of a dg3
// launch.
void h_dg3_geometry(int64_t G, int R, int resident, int64_t* out) {
  const dg3_geom geo = dg3_geometry(G, R, kDg3SliceWords, kHostSmemMax);
  out[0] = geo.tc, out[1] = geo.gs, out[2] = geo.slices;
  out[3] = even_blocks(geo.slices, resident, kDg3Threads);
  out[4] = geo.ring;
}
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources' bodies")
    d = tmp_path_factory.mktemp("csrc_host")
    src, lib = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy())


def _call(fn, *args):
    """Call a harness function: numpy arrays by pointer, None as a null
    pointer, ("i32", v) as a C int, any other int as int64_t."""
    conv = []
    for a in args:
        if a is None:
            conv.append(ctypes.c_void_p(None))
        elif isinstance(a, np.ndarray):
            conv.append(ctypes.c_void_p(a.ctypes.data))
        elif isinstance(a, tuple):              # ("i32", value)
            conv.append(ctypes.c_int(a[1]))
        else:
            conv.append(ctypes.c_int64(a))
    fn(*conv)


def _words(spec, vals):
    return mont.words_tensor(mont.ints_to_words(spec, vals))


def _points(n, seed, curve=BN254):
    """n affine points (port words) plus n projective points that include
    the identity, equal and opposite pairs."""
    rng = random.Random(seed)
    fp = curve.fp
    R = mont.radix(fp)
    aff = [curve_ref.random_point(curve, rng) for _ in range(n)]
    ax = _words(fp, [x * R % fp.modulus for x, _ in aff])
    ay = _words(fp, [y * R % fp.modulus for _, y in aff])
    # projective: random z scaling, identity at 0, q = p at 1, q = -p at 2
    zs = [rng.randrange(1, fp.modulus) for _ in range(n)]
    px = _words(fp, [x * z * R % fp.modulus for (x, _), z in zip(aff, zs)])
    py = _words(fp, [y * z * R % fp.modulus for (_, y), z in zip(aff, zs)])
    pz = _words(fp, [z * R % fp.modulus for z in zs])
    p = ProjPoint(px, py, pz)
    ident = cp.identity(curve, (n,))
    p = ProjPoint(*(torch.cat([i[:, :1], a[:, 1:]], 1) for i, a in zip(ident, p)))
    return p, AffinePoint(ax, ay)


def _curve_id(curve):
    return ("i32", _ext.MSM_CURVES.index(curve.name))


FIELD_STRUCTS = [("Fp254", BN254_FP), ("Fr254", BN254_FR),
                 ("Fr377", BLS12_377_FR), ("Fp377", BLS12_377.fp),
                 ("Fp381", BLS12_381.fp), ("Fr381", BLS12_381_FR)]


@pytest.mark.parametrize("struct,spec", FIELD_STRUCTS,
                         ids=[s for s, _ in FIELD_STRUCTS])
def test_field_constants_match_field_config(struct, spec):
    text = (CSRC / "field.cuh").read_text()
    body = text.split(f"struct {struct} ")[1].split("\n};")[0]

    def arr(fn):
        words = re.findall(r"0x([0-9a-f]{8})u",
                           body.split(f" {fn}(int i)")[1].split("}")[0])
        return sum(int(w, 16) << (32 * i) for i, w in enumerate(words))

    N = int(re.search(r"int N = (\d+);", body).group(1))
    ninv = int(re.search(r"ninv = 0x([0-9a-f]{8})u", body).group(1), 16)
    R = 1 << (32 * N)
    p = spec.modulus
    assert N == mont.n_words(spec) and R == mont.radix(spec)
    assert arr("p") == p
    assert arr("p2") == 2 * p
    assert arr("one") == R % p
    assert ninv == (-pow(p, -1, 1 << 32)) % (1 << 32)
    canon = re.search(r"bool canon = (true|false);", body).group(1)
    assert (canon == "true") == mont.canon(spec)
    if struct == "Fr381":        # the [0, p) invariant of a canon field
        assert 2 * p < R < 4 * p
    else:                        # the [0, 2p) invariant of field.cuh
        assert 4 * p < R
    top = re.search(r"wide_top = (\d+);", body)
    if struct in ("Fr254", "Fr377", "Fr381"):   # the NTT fields: reduce_wide
        assert int(top.group(1)) == (R // p).bit_length() - 1
        assert p << int(top.group(1)) < R <= p << (int(top.group(1)) + 1)
        ntt_fused.check_bounds(spec, 5)         # the DFT's 9-word REDC
    else:
        assert top is None


@pytest.mark.parametrize("name", ["fmul", "dft", "small_ntt"])
def test_field_ids_match_ntt_fields(name):
    """Each NTT launcher maps field id i to the struct of _ext.NTT_FIELDS[i]."""
    text = (CSRC / f"{name}.cu").read_text()
    ids = dict(re.findall(r"case (\d+):\s*return \w+<ptt::(\w+)>", text))
    struct = {"bn254_fr": "Fr254", "bls12_377_fr": "Fr377",
              "bls12_381_fr": "Fr381"}
    assert ids == {str(i): struct[f] for i, f in enumerate(_ext.NTT_FIELDS)}
    assert set(struct) == set(_ext.NTT_FIELDS) == set(_ext.MSM_FIELDS)


@pytest.mark.parametrize("name,launchers", [("digits", 1), ("point_ops", 4),
                                            ("wscan", 1), ("phase_a", 1),
                                            ("buckets", 2)])
def test_ids_match_msm_curves_and_fields(name, launchers):
    """Each MSM launcher maps id i to the struct of _ext.MSM_FIELDS[i]
    (digits) or _ext.MSM_CURVES[i] (the point kernels), every id once a
    launcher."""
    text = (CSRC / f"{name}.cu").read_text()
    pairs = re.findall(r"case (\d+):\s*return \w+<ptt::(\w+)>", text)
    if name == "digits":
        struct = {"bn254_fr": "Fr254", "bls12_377_fr": "Fr377",
                  "bls12_381_fr": "Fr381"}
        want = [(str(i), struct[f]) for i, f in enumerate(_ext.MSM_FIELDS)]
    else:
        struct = {"bn254": "Bn254", "bls12_377": "Bls12_377",
                  "bls12_381": "Bls12_381"}
        want = [(str(i), struct[c]) for i, c in enumerate(_ext.MSM_CURVES)]
    assert pairs == want * launchers


def _field_op_case(struct, spec, op):
    return pytest.param(struct, spec, op,
                        id=op if struct == "Fp254" else f"{struct}-{op}")


@pytest.mark.parametrize("struct,spec,op", [
    _field_op_case(s, f, op) for s, f in FIELD_STRUCTS
    if s in ("Fp254", "Fp377", "Fp381") for op in ("mul", "add", "sub")] +
    [_field_op_case("Fr381", BLS12_381_FR, "mul")])
def test_field_ops_bit_identical(host, struct, spec, op):
    """field.cuh's mont_mul, add_mod, sub_mod against the plain version on
    values < 2p, edges 0, p - 1, p, 2p - 1 included.  BLS12-381 Fr (4r >
    2^256) here: the digit recode's product, any a < 2^256 times the plain
    1, which gives < r (its other ops: test_fr381_ops_bit_identical)."""
    p = spec.modulus
    rng = random.Random(7)
    edge = [0, 1, p - 1, p, p + 1, 2 * p - 2, 2 * p - 1]
    a = edge * len(edge) + [rng.randrange(2 * p) for _ in range(200)]
    b = [e for e in edge for _ in edge] + [rng.randrange(2 * p)
                                           for _ in range(200)]
    if struct == "Fr381":
        a += [(1 << 256) - 1, 3 * p] + [rng.randrange(1 << 256)
                                        for _ in range(50)]
        b = [1] * len(a)
    A, B = _words(spec, a), _words(spec, b)
    out = np.empty_like(_np(A))
    field = ["Fp254", "Fp377", "Fp381", "Fr381"].index(struct)
    _call(host.h_fp, ("i32", ["mul", "add", "sub"].index(op)),
          ("i32", field), _np(A), _np(B), out, len(a))
    plain = {"mul": mont.mul, "add": mont.add, "sub": mont.sub}[op](spec, A, B)
    np.testing.assert_array_equal(out, _np(plain))
    assert all(v < (p + 1 if struct == "Fr381" else 2 * p)
               for v in mont.words_to_ints(out))


@pytest.mark.parametrize("op", ["mul", "add", "sub", "reduce_wide"])
def test_fr381_ops_bit_identical(host, op):
    """Fr381 (a canon field: values in [0, r)) mont_mul, add_mod and
    sub_mod on a, b < r, edges 0, 1, r - 1 and pairs with a + b >= 2^256 - r
    included, equal to the plain L16 versions word for word and below r;
    mont_mul also with a < r times any b < 2^256; reduce_wide on words up
    to 2^256 - 1 equal to mont.reduce_wire."""
    spec = BLS12_381_FR
    r, top = spec.modulus, 1 << 256
    rng = random.Random(381)
    edge = [0, 1, 2, r - 2, r - 1]
    high = [(top - r) // 2 + k for k in (0, 1, 7)] + \
        [r - 1 - rng.randrange(1 << 64) for _ in range(4)]
    a = edge * len(edge) + high * len(high) + [rng.randrange(r)
                                               for _ in range(200)]
    b = [e for e in edge for _ in edge] + [h for h in high for _ in high] + \
        [rng.randrange(r) for _ in range(200)]
    if op == "mul":
        a += [r - 1, 1, rng.randrange(r)] + [rng.randrange(r)
                                             for _ in range(30)]
        b += [top - 1, top - 1, 2 * r + 5] + [rng.randrange(top)
                                              for _ in range(30)]
    if op == "reduce_wide":
        a = [0, r - 1, r, 2 * r - 1, 2 * r, top - 1] + \
            [rng.randrange(top) for _ in range(100)]
        b = a
    A, B = _words(spec, a), _words(spec, b)
    out = np.empty_like(_np(A))
    if op == "reduce_wide":
        _call(host.h_reduce_wide_fr381, _np(A), out, len(a))
    else:
        _call(host.h_fp, ("i32", ["mul", "add", "sub"].index(op)),
              ("i32", 3), _np(A), _np(B), out, len(a))
    plain = {"mul": mont.mul, "add": mont.add, "sub": mont.sub,
             "reduce_wide": lambda s, x, _: mont.reduce_wire(s, x)}[op](
                 spec, A, B)
    np.testing.assert_array_equal(out, _np(plain))
    got = mont.words_to_ints(out)
    assert all(v < r for v in got)
    R = mont.radix(spec)
    want = {"mul": [x * y * pow(R, -1, r) % r for x, y in zip(a, b)],
            "add": [(x + y) % r for x, y in zip(a, b)],
            "sub": [(x - y) % r for x, y in zip(a, b)],
            "reduce_wide": [x % r for x in a]}[op]
    assert got == want


# threads of the host launches: fewer than the elements, so each walks
# several with its grid stride (7 of them an uneven number), and one each
POINT_THREADS = (5, 7, 24)


def _point_ops_case(host, curve):
    """point_ops.cu's padd, pmadd and pdbl (one doubling), products through
    mont_mul_wide, at each of POINT_THREADS."""
    n = 24
    p, q_aff = _points(n, 11, curve)
    q = cp.from_affine(curve, q_aff)
    q = ProjPoint(*(torch.cat([a[:, :2], b[:, 2:3], c[:, 3:]], 1)
                    for a, b, c in zip(p, cp.neg(curve, p), q)))
    cid = _curve_id(curve)
    for threads in POINT_THREADS:
        outs = [np.full_like(_np(p.x), 0x5A5A5A5A) for _ in range(3)]
        _call(host.h_padd, *map(_np, p), *map(_np, q), *outs, n, threads, cid)
        for o, e in zip(outs, cp.add_plain(curve, p, q)):
            np.testing.assert_array_equal(o, _np(e))
        _call(host.h_pmadd, *map(_np, p), *map(_np, q_aff), *outs, n,
              threads, cid)
        for o, e in zip(outs, cp.madd_plain(curve, p, q_aff)):
            np.testing.assert_array_equal(o, _np(e))
        _call(host.h_pdbl, *map(_np, p), *outs, n, ("i32", 1), threads,
              cid)
        for o, e in zip(outs, cp.dbl_plain(curve, p)):
            np.testing.assert_array_equal(o, _np(e))


def test_point_ops_bit_identical(host):
    _point_ops_case(host, BN254)


@BLS_CURVES
def test_point_ops_bit_identical_bls(host, curve):
    """The 12-word instantiations (b3 = 3 and 12)."""
    _point_ops_case(host, curve)


@pytest.mark.parametrize("k", [3, 13])
@pytest.mark.parametrize("curve", [BN254, BLS12_377, BLS12_381],
                         ids=lambda c: c.name)
def test_pdbl_k_doublings_bit_identical(host, curve, k):
    """pdbl with a count: k doublings in registers between one load and one
    store (the device Horner's c a window), word for word the plain
    doubling applied k times, the identity included."""
    n = 9
    p, _ = _points(n, 13, curve)
    want = p
    for _ in range(k):
        want = cp.dbl_plain(curve, want)
    for threads in POINT_THREADS[:2]:
        outs = [np.empty_like(_np(p.x)) for _ in range(3)]
        _call(host.h_pdbl, *map(_np, p), *outs, n, ("i32", k), threads,
              _curve_id(curve))
        for o, e in zip(outs, want):
            np.testing.assert_array_equal(o, _np(e))


def _digits_case(fr, c):
    return pytest.param(fr, c, id=str(c) if fr is BN254_FR
                        else f"{fr.name}-{c}")


@pytest.mark.parametrize("fr,c", [_digits_case(fr, c)
                                  for fr in (BN254_FR, BLS12_377_FR,
                                             BLS12_381_FR)
                                  for c in (7, 13, 16)])
def test_signed_digits_bit_identical(host, fr, c):
    rng = random.Random(c)
    vals = [0, 1, fr.modulus - 1, fr.modulus, (1 << 256) - 1] + \
        [rng.randrange(1 << 256) for _ in range(59)]
    s = _words(fr, vals)
    W = -(-fr.bits // c) + (1 if (-(-fr.bits // c)) * c < fr.bits + 1 else 0)
    mags = np.empty((W, len(vals)), np.uint32)
    negs = np.empty((W, len(vals)), np.uint8)
    _call(host.h_digits, _np(s), mags, negs, len(vals), ("i32", c),
          ("i32", W), ("i32", _ext.MSM_FIELDS.index(fr.name)))
    em, en = digits.signed_digits_plain(fr, s, c, W)
    np.testing.assert_array_equal(mags.view(np.int32), _np(em))
    np.testing.assert_array_equal(negs.astype(bool), _np(en))


def _hist_host(host, d, D, G, T, unroll=4):
    """hist.cu's W * G blocks of T threads on the host, thread by thread."""
    W, N = d.shape
    counts = np.zeros((W, D), np.int32)
    _call(host.h_hist, d, counts, W, N, ("i32", D), G, ("i32", T),
          ("i32", unroll))
    return counts


def test_hist_counts_identical(host):
    """hist.cu's blocks (shared-memory bins, one add a digit, the flush)
    against the plain version: digit 0 and dead keys ignored, slices that
    end mid-iteration, runs of equal digits."""
    rng = np.random.default_rng(5)
    W, N, D = 3, 3000, 512
    d = rng.integers(0, D + 2, size=(W, N)).astype(np.int32)
    d[:, :40] = 0
    d[1, 100:400] = 9
    want = _np(hist.hist_counts_plain(torch.from_numpy(d), D))
    for G, T in ((1, 32), (3, 64), (7, 128)):
        np.testing.assert_array_equal(_hist_host(host, d, D, G, T), want)


def test_hist_counts_one_digit_stream(host):
    """Every digit the same at D = 32768 (the 2^20 MSM's bucket count) and
    at D = 4096 (2^16's): every add of a block to one bin, the flush one
    atomic a block."""
    W, N = 2, 5000
    for D in (1 << 15, 1 << 12):
        d = np.ones((W, N), np.int32)
        d[1] = D
        got = _hist_host(host, d, D, 3, 64)
        np.testing.assert_array_equal(
            got, _np(hist.hist_counts_plain(torch.from_numpy(d), D)))
        assert got[0, 0] == N and got[1, D - 1] == N and got.sum() == W * N


# (W, S, m, depth, T): S not a multiple of the ring depth with two blocks,
# S below the depth with a partial last block, single-step lanes, a ring of
# one slot, a ring of eight (the kernel's depth is PTT_PHASE_A_RING, 4 by
# default; the host form takes it as a template argument); the last 3
# entries of each window are dead padding.
PHASE_A_GEOMETRIES = [(2, 6, 4, 4, 4), (2, 3, 5, 4, 8), (3, 1, 6, 4, 4),
                      (2, 5, 3, 1, 2), (1, 11, 2, 8, 2)]


def _phase_a_case(host, curve, W, S, m, depth, T):
    n, D = 20, 8
    L = mont.n_words(curve.fp)
    rng = np.random.default_rng(9 + S)
    _, base = _points(n, 13, curve)
    keys = np.sort(rng.integers(0, D + 1, size=(W, S * m)), axis=1)
    keys[:, -3:] = D + 1                                  # dead padding
    idx = rng.integers(0, n, size=(W, S * m))
    sgn = rng.integers(0, 2, size=(W, S * m)).astype(bool)
    sidx = np.where(sgn, idx | -(1 << 31), idx)

    def sm(a):      # lane-major (W, S*m) -> step-major (W, S, m) int32
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape(W, m, S).transpose(0, 2, 1)).astype(np.int32))

    k5, s5 = sm(keys), sm(sidx)
    ek, ep, tk, tp = phase_a.scan_plain(curve, k5, s5, base.x, base.y, D + 1)
    P = W * S * m
    o_ek = np.empty((W, S, m), np.uint32)
    o_e = [np.full((L, P), 0xA5A5A5A5, np.uint32) for _ in range(3)]
    o_tk = np.empty((W, m), np.uint32)
    o_t = [np.empty((L, W * m), np.uint32) for _ in range(3)]
    pts = phase_a.point_major(base.x, base.y)
    assert pts.shape == (n, 2 * L)
    _call(host.h_phase_a, _np(k5), _np(s5), _np(pts), o_ek, *o_e, o_tk,
          *o_t, W, m, S, ("i32", D + 1), ("i32", depth), ("i32", T),
          _curve_id(curve))
    np.testing.assert_array_equal(o_ek.view(np.int32), _np(ek))
    np.testing.assert_array_equal(o_tk.view(np.int32), _np(tk))
    # emissions are defined where a run ended; nothing is stored elsewhere
    ended = _np(ek).reshape(P) != D + 1
    assert ended.sum() < P and (ended.sum() > 0) == (S > 1)
    for o, e in zip(o_e, ep):
        np.testing.assert_array_equal(o.view(np.int32)[:, ended],
                                      _np(e).reshape(L, P)[:, ended])
        assert (o[:, ~ended] == 0xA5A5A5A5).all()
    for o, e in zip(o_t, tp):
        np.testing.assert_array_equal(o.view(np.int32),
                                      _np(e).reshape(L, W * m))


def test_phase_a_bit_identical(host):
    """phase_a.cu's lane loop with its ring of cp.async copies (deferred on
    the host until their wait) at every geometry of PHASE_A_GEOMETRIES,
    equal to scan_plain."""
    for geom in PHASE_A_GEOMETRIES:
        _phase_a_case(host, BN254, *geom)


@BLS_CURVES
def test_phase_a_bit_identical_bls(host, curve):
    """The 12-word instantiations: the y negation in Fp377 / Fp381, 96-byte
    rows in six 16-byte chunks, emissions and tails."""
    for geom in PHASE_A_GEOMETRIES:
        _phase_a_case(host, curve, *geom)


def _buckets_host(host, curve, st, ek, ep, tk, tp, plan):
    """assemble_buckets' two launches on the host: buckets.cu's tails
    launch block by block, then its fill launch's threads, into tables that
    start as 0xA5 filler; (L, W, D) tables out."""
    W, S, m = st.keys.shape
    L, D = mont.n_words(curve.fp), st.D
    assert plan.blocks * plan.threads * plan.chunk >= m
    out = [np.full((L, W, D), 0xA5A5A5A5, np.uint32) for _ in range(3)]
    for fill in (0, 1):
        _call(host.h_buckets, *map(_np, ep), _np(ek), *map(_np, tp), _np(tk),
              _np(st.hi), *out, W, S, m, plan.blocks, ("i32", D),
              ("i32", plan.chunk), ("i32", plan.threads), ("i32", fill),
              _curve_id(curve))
    return ProjPoint(*(torch.from_numpy(o.view(np.int32)) for o in out))


def _bucket_digits(case, rng):
    """(digits, signs, c, m, plans, bases) of a bucket-assembly case; the
    bases are an index into a pool of 6 points."""
    if case == "one key over every lane":
        W, n, c, m = 2, 48, 5, 16                   # 3 steps, no padding
        d = np.full((W, n), 3)
        d[1] = rng.integers(0, 17, size=n)
        plans = [(2, 4), (1, 2), (4, 4)]            # 2, 8 and 1 blocks
    elif case == "dead lanes, empty buckets, runs across chunks":
        W, n, c, m = 2, 50, 7, 12                   # 5 steps, 10 padded
        d = rng.integers(0, 12, size=(W, n)) * 5   # most buckets empty
        d[:, :4] = 0
        d[0, 10:32] = 9                             # a run of ~4 lanes
        d[1, 20:27] = 64                            # B_D, one step-run
        plans = [(1, 4), (2, 2), (3, 2)]
    elif case == "a chunk's first run ends before another":
        # two entries a lane; the lanes' tail keys 1 1 1 2 3 3 4 5 5 5 6 7,
        # so with 3 lanes a thread the last chunk ends run 5 (begun in the
        # chunk before) and then run 6
        W, n, c, m = 1, 24, 4, 12
        d = np.array([1] * 6 + [2, 2, 2, 3, 3, 3, 4, 4, 4, 5] + [5] * 4 +
                     [6, 6, 7, 7])[None]
        plans = [(3, 4), (2, 2), (1, 8)]
    else:       # "identity inputs": one base point, alternating signs
        W, n, c, m = 1, 41, 4, 10                   # 5 steps, 9 padded
        d = np.where(np.arange(n) < 26, 1, 2)[None]
        plans = [(1, 4), (2, 2)]
    signs = rng.integers(0, 2, size=d.shape).astype(bool)
    bases = rng.integers(6, size=n)
    if case == "identity inputs":
        signs[0] = np.arange(n) % 2 == 1
        bases[:] = 0
    return d, signs, c, m, plans, bases


BUCKET_CASES = ["one key over every lane",
                "dead lanes, empty buckets, runs across chunks",
                "a chunk's first run ends before another",
                "identity inputs"]


@pytest.mark.parametrize("curve", [BN254, BLS12_381], ids=lambda c: c.name)
@pytest.mark.parametrize("case", BUCKET_CASES)
def test_bucket_assembly_point_equal(host, curve, case):
    """buckets.cu's tails launch (blocks from a run's start, chunks in
    registers, the block's segmented scan in shared memory, the interior
    emission added where a run of tails ends) and its fill launch (the
    other buckets' emission or the identity) on the host, point-equal to
    assemble_buckets_plain on phase A's plain outputs, whose emissions are
    0xA5 filler where no run ended, at several (chunk, threads) plans: runs
    as long as every lane, across chunk and block edges, lanes that end in
    padding, empty, interior-only and tail-only buckets, and sums that
    cancel to the identity."""
    rng = np.random.default_rng(BUCKET_CASES.index(case))
    d, signs, c, m, plans, bases = _bucket_digits(case, rng)
    _, pool = _points(6, 29, curve)
    px, py = pool.x[:, bases].contiguous(), pool.y[:, bases].contiguous()
    st = msm.sorted_streams(torch.from_numpy(d.astype(np.int32)),
                            torch.from_numpy(signs), c, m)
    ek, ep, tk, tp = phase_a.scan_plain(curve, st.keys, st.sidx, px, py,
                                        st.D + 1)
    ended = (ek != st.D + 1).unsqueeze(0)
    filler = torch.tensor(0xA5A5A5A5 - (1 << 32), dtype=torch.int32)
    ep = ProjPoint(*(torch.where(ended, a, filler) for a in ep))
    want = msm.assemble_buckets_plain(curve, st, ek, ep, tk, tp)
    W, S, _ = st.keys.shape
    live = (st.keys >= 1) & (st.keys <= st.D)
    assert int(live.sum()) > 0 and S > 1
    for chunk, T in plans:
        plan = msm.BucketPlan(chunk, T, -(-m // (T * chunk)))
        got = _buckets_host(host, curve, st, ek, ep, tk, tp, plan)
        assert bool(cp.eq(curve, got, want).all()), (chunk, T)
    ident = cp.is_identity(curve, want)
    if case == "one key over every lane":
        assert (tk[0] == 3).all() and not bool(ident[0, 2])
    elif case == "dead lanes, empty buckets, runs across chunks":
        assert (tk == st.D + 1).any() and bool(ident.any())
        assert int((tk[0] == 9).sum()) >= 3
    elif case == "a chunk's first run ends before another":
        assert tk[0].tolist() == [1, 1, 1, 2, 3, 3, 4, 5, 5, 5, 6, 7]
    else:
        assert bool(ident[0, 0]) and not bool(ident[0, 1])


def _wscan_host(host, curve, buckets, plan):
    """weighted_window_sum's launches on the host: each level of ``plan``
    through wscan.cu's host form; (L, W, D) in, (L, W) out."""
    L, W, _ = buckets.x.shape
    x, p = [_np(a) for a in buckets], None
    for lv in plan:
        P = [np.empty((L, W, lv.blocks), np.int32) for _ in range(3)]
        X = [np.empty((L, W, lv.blocks), np.int32) for _ in range(3)] \
            if lv.blocks > 1 else [None] * 3
        _call(host.h_wscan_level, *x, *(p or [None] * 3), *P, *X, W, lv.E,
              lv.blocks, ("i32", lv.seg), ("i32", lv.threads),
              ("i32", int(p is None)), _curve_id(curve))
        x, p = X, P
    return ProjPoint(*(torch.from_numpy(a[:, :, 0]) for a in p))


# One wave of csrc/wscan.cu on the H100: 132 SMs x 2 blocks of 128.
H100_WSCAN_WAVE = 132 * 2 * 128


def _weighted_scan_case(host, curve):
    """Windows of D buckets drawn from a pool of 24 points that holds the
    identity; where there are three windows, the second holds identities
    only and the third one non-identity bucket, B_D."""
    L = mont.n_words(curve.fp)
    for W, D, plan in (
            (1, 260, None),        # seg 2, two blocks a window, then one
            (3, 5, None),          # D not a multiple of the segment
            (3, 40, [reduce.Level(40, 2, 2, 10), reduce.Level(10, 2, 2, 3),
                     reduce.Level(3, 1, 4, 1)])):      # three levels
        pool, _ = _points(24, 17 + D, curve)
        pick = torch.from_numpy(np.random.default_rng(D).integers(
            24, size=W * D))
        b = ProjPoint(*(a[:, pick].reshape(L, W, D).clone() for a in pool))
        if W == 3:
            ident = cp.identity(curve, (D,))
            for a, i in zip(b, ident):
                a[:, 1] = i
                a[:, 2, :-1] = i[:, :-1]
        plan = plan or reduce.wscan_plan(W, D, H100_WSCAN_WAVE)
        assert plan[-1].blocks == 1 and all(
            lv.E == prev.blocks for prev, lv in zip(plan, plan[1:]))
        got = _wscan_host(host, curve, b, plan)
        want = reduce.weighted_window_sum_plain(curve, b)
        assert bool(cp.eq(curve, got, want).all())
        if W == 3:
            assert bool(cp.is_identity(curve, got)[1])
            assert not bool(cp.is_identity(curve, got)[2])


def test_weighted_scan_bit_identical(host):
    """wscan.cu's levels (segment scans, the block's suffix scan and tree in
    shared memory, the scaled block runs) run block by block on the host,
    point-equal to the plain weighted_window_sum."""
    _weighted_scan_case(host, BN254)


@BLS_CURVES
def test_weighted_scan_bit_identical_bls(host, curve):
    _weighted_scan_case(host, curve)


@pytest.mark.parametrize("fr", [BN254_FR, BLS12_377_FR, BLS12_381_FR,
                                BN254_FP, BLS12_377.fp, BLS12_381.fp],
                         ids=lambda f: f.name)
def test_mont_mul_wide_bit_identical(host, fr):
    """field.cuh's mont_mul_wide (the even/odd accumulation that small_ntt
    and the point_ops formulas multiply with) gives mont_mul's product word
    for word on its whole domain's edges and on random values: a and b
    below 2r (a below r and b any word below 2^256 for BLS12-381 Fr, whose
    values stay below r); for the NTT scalar fields and the curves' 8- and
    12-word base fields."""
    r = fr.modulus
    canon = mont.canon(fr)
    rng = random.Random(7)
    a_top = r if canon else 2 * r
    b_top = 1 << 256 if canon else 2 * r
    edge_a = [0, 1, 2, r - 1, a_top - 1, a_top - 2, a_top // 2]
    edge_b = [0, 1, r - 1, r, b_top - 1, b_top - 2, (1 << 224) - 1,
              b_top // 3]
    if not canon:
        edge_a += [r, r + 1]
    a = [x for x in edge_a for _ in edge_b] + \
        [rng.randrange(a_top) for _ in range(3000)] + \
        [a_top - 1 - rng.randrange(1 << 64) for _ in range(500)]
    b = [y for _ in edge_a for y in edge_b] + \
        [rng.randrange(b_top) for _ in range(3000)] + \
        [b_top - 1 - rng.randrange(1 << 64) for _ in range(500)]
    A, B = _words(fr, a), _words(fr, b)
    L = mont.n_words(fr)
    out = np.empty((2 * L, len(a)), np.uint32)
    if fr.name in _ext.NTT_FIELDS:
        _call(host.h_mul_wide, _np(A), _np(B), out, len(a),
              ("i32", _ext.NTT_FIELDS.index(fr.name)))
        plain = fmul.fmul_plain(fr, A, B)
    else:
        _call(host.h_mul_wide_fp, _np(A), _np(B), out, len(a),
              ("i32", ["bn254_fp", "bls12_377_fp", "bls12_381_fp"].index(
                  fr.name)))
        plain = mont.mul(fr, A, B)
    np.testing.assert_array_equal(out[:L], out[L:])
    np.testing.assert_array_equal(out[L:].view(np.int32), _np(plain))


@NTT_FIELDS
def test_fmul_bit_identical(host, fr):
    """fmul.cu's body against the plain version: a, b < 2r give < 2r (and
    canonical with canonical_out); a < R times the plain 1 gives <= r.  For
    BLS12-381 Fr (values in [0, r)): a, b < r give < r."""
    r = fr.modulus
    canon = mont.canon(fr)
    field = ("i32", _ext.NTT_FIELDS.index(fr.name))
    rng = random.Random(21)
    edge = [0, 1, r - 1] if canon else [0, 1, r - 1, r, r + 1, 2 * r - 1]
    hi = r if canon else 2 * r
    a = edge * len(edge) + [rng.randrange(hi) for _ in range(100)]
    b = [e for e in edge for _ in edge] + [rng.randrange(hi)
                                           for _ in range(100)]
    wide = [(1 << 256) - 1, 2 * r, 5 * r] + [rng.randrange(1 << 256)
                                             for _ in range(30)]
    cases = [(a, b), (wide, [1] * len(wide))]
    for (av, bv), canon in [(c, k) for c in cases for k in (0, 1)]:
        A, B = _words(fr, av), _words(fr, bv)
        out = np.empty_like(_np(A))
        _call(host.h_fmul, _np(A), _np(B), out, len(av), ("i32", canon),
              field)
        np.testing.assert_array_equal(
            out.view(np.int32), _np(fmul.fmul_plain(fr, A, B, bool(canon))))
        limit = r if canon or mont.canon(fr) else \
            (r + 1 if bv[0] == 1 else 2 * r)
        assert all(v < limit for v in mont.words_to_ints(out))


@NTT_FIELDS
@pytest.mark.parametrize("log_k,nb", [(0, 6), (2, 132), (5, 70)])
def test_dft_bit_identical(host, log_k, nb, fr):
    """dft.cu's block loop (stage copies, fragment loads, the tensor-core
    product through the host emulation of mma.m16n8k32 u8, the epilogue)
    against the plain version, forward and with a scale and the canonical
    pass, on words that include values >= r.  Each nb leaves a partial
    column tile (64 columns a block at K = 32, 128 at K = 4, 512 at K = 1);
    nb = 132 takes the 4-word copies, the others single words."""
    r = fr.modulus
    K = 1 << log_k
    rng = random.Random(log_k)
    vals = [rng.randrange(1 << 256) for _ in range(K * nb)]
    vals[:3] = [(1 << 256) - 1, r, 2 * r - 1]
    x = _words(fr, vals).reshape(8, K, nb).contiguous()
    w = fr.root_of_unity(log_k)
    for scale, canon in ((1, 0), (pow(1 << 11, -1, r), 1)):
        mat = ntt_fused.dft_matrix(fr, log_k, w, scale)
        out = np.empty((8, K, nb), np.uint32)
        _call(host.h_dft, _np(x), np.ascontiguousarray(mat.numpy()), out, nb,
              ("i32", K), ("i32", canon),
              ("i32", _ext.NTT_FIELDS.index(fr.name)))
        want = ntt_fused.dft_apply_fused_plain(fr, x, log_k, mat, bool(canon))
        np.testing.assert_array_equal(out.view(np.int32), _np(want))
        assert all(v < (r if canon or mont.canon(fr) else 2 * r)
                   for v in mont.words_to_ints(out.reshape(8, -1)))


def _small_ntt_geometry(host, log_k, nb, resident):
    out = np.zeros(5, np.int64)
    _call(host.h_small_ntt_geometry, ("i32", log_k), nb, ("i32", resident),
          out)
    return out.tolist()


@NTT_FIELDS
@pytest.mark.parametrize("pre", [False, True], ids=["no-T1", "T1"])
@pytest.mark.parametrize("layout", ["natural", "runs"])
@pytest.mark.parametrize("log_k", range(1, 9))
def test_small_ntt_bit_identical(host, log_k, layout, pre, fr):
    """small_ntt.cu's launch on the host (every block's tiles; the strided
    load, the in-register radix-r rounds with their shared-memory
    exchanges, the store), word for word against the plain version, for
    every K, in the natural layout and as the four-step inner output view
    (W, nb / batch, K, batch), with and without a pre-twiddle table.  Two
    configurations a case: any words below 2^256 with reduce_in over 1.5
    tiles, which one block loops over (a partial last tile; with the table
    the first tile spans two of its columns, read from global memory; the
    runs layout at batch 1, the top level's column-major runs); and words
    below 2r (r for BLS12-381 Fr) with the inverse's scale and the
    canonical store over one tile of one table column (read from shared
    memory)."""
    r = fr.modulus
    stored = r if mont.canon(fr) else 2 * r       # the stored values' bound
    K = 1 << log_k
    rng = random.Random(log_k)
    T = 256                                         # the build's threads
    tc = _small_ntt_geometry(host, log_k, 1, T)[2]
    tw = ntt_pallas.stage_twiddle_rows(fr, log_k, fr.root_of_unity(log_k))
    scale = _words(fr, [fr.to_wire_int(pow(K, -1, r))]).reshape(8)
    # (nb, batch of the runs layout, pre-table columns, values, scale,
    # reduce_in, canonical_out, resident threads)
    configs = (
        (tc + tc // 2, 1, 3 if layout == "natural" else tc + tc // 2, 1 << 256,
         None, True, False, T),
        (tc, tc, 1, stored, scale, False, True, 2 * T))
    for nb, batch, B, top, sc, reduce_in, canon, resident in configs:
        vals = [rng.randrange(top) for _ in range(K * nb)]
        vals[:2] = [top - 1, r - 1]
        x = _words(fr, vals).reshape(8, K, nb)
        if layout == "runs":          # x[:, c // batch, j, c % batch]
            x = x.reshape(8, K, nb // batch, batch).permute(0, 2, 1, 3)
        x = x.contiguous()
        run = batch if layout == "runs" else nb
        table = _words(fr, [rng.randrange(r) for _ in range(K * B)]
                       ).reshape(8, K, B).contiguous() if pre else None
        out = np.empty((8, K, nb), np.uint32)
        _call(host.h_small_ntt, _np(x), _np(tw),
              None if table is None else _np(table),
              None if sc is None else _np(sc), out, nb, ("i32", log_k), run,
              B if pre else 1, ("i32", int(reduce_in)), ("i32", int(canon)),
              ("i32", resident), ("i32", _ext.NTT_FIELDS.index(fr.name)))
        want = ntt_pallas.small_ntt_batch_plain(fr, x, log_k, tw, table, sc,
                                                reduce_in, canon)
        np.testing.assert_array_equal(out.view(np.int32), _np(want))
        assert all(v < (r if canon else stored)
                   for v in mont.words_to_ints(out.reshape(8, -1)))


def test_small_ntt_geometry(host):
    """The launch geometry at the radix-2 engine's 2^20 and 2^22 passes:
    r = 8, rounds of 3 stages and a residue, tiles of T r / K columns, and
    every block the same number of tiles (264 threads-worth of blocks of
    256 a wave, as two blocks an SM on 132 SMs would give)."""
    wave = 2 * 132 * 256
    assert _small_ntt_geometry(host, 8, 1 << 12, wave) == [8, 3, 8, 512, 256]
    assert _small_ntt_geometry(host, 6, 1 << 14, wave) == [8, 2, 32, 512, 256]
    assert _small_ntt_geometry(host, 7, 1 << 15, wave) == [8, 3, 16, 2048,
                                                           256]
    assert _small_ntt_geometry(host, 2, 5, wave) == [2, 2, 128, 1, 1]


@pytest.mark.parametrize("partial", [False, True], ids=["whole", "partial"])
@pytest.mark.parametrize("R", profile_gather4.DEPTHS)
def test_dg3_bit_identical(host, R, partial):
    """dg3.cu's launch on the host (each block's ring of cp.async stages,
    two, or one at R = 1024, copies landing only at their wait, and its
    lookups, thread by thread)
    against the plain version on int32 words that include negative bit
    patterns; an index outside [0, R) gives 0 and reads nothing.  Two
    blocks; with ``partial`` an odd G, whose last slice holds fewer g than
    the others where a slice holds several (R = 8 and 32)."""
    geo = np.zeros(5, np.int64)
    _call(host.h_dg3_geometry, 1 << 20, ("i32", R), ("i32", 256), geo)
    gs = int(geo[1])
    G = 2 * gs + (gs // 2 if gs > 1 else 1) if partial else 2 * gs
    rng = np.random.default_rng(R + partial)
    tab = rng.integers(-(1 << 31), 1 << 31, size=(G, R, 128)).astype(np.int32)
    idx = rng.integers(R, size=(G, R, 128)).astype(np.int32)
    idx[0, 0, :3] = [-1, R, 1 << 30]
    out = np.empty_like(tab)
    _call(host.h_dg3, tab, idx, out, G, ("i32", R), ("i32", 2 * 256))
    want = profile_gather4.dg3_plain(torch.from_numpy(tab),
                                     torch.from_numpy(idx.clip(0, R - 1)))
    want[0, 0, :3] = 0
    np.testing.assert_array_equal(out, _np(want))
    _call(host.h_dg3_geometry, G, ("i32", R), ("i32", 2 * 256), geo)
    assert geo[3] == 2 and geo[4] == (1 if R == 1024 else 2)
