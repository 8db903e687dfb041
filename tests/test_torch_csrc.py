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
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.curves.point import AffinePoint, ProjPoint
from panda_tpu_torch.fields import mont
from panda_tpu_torch.fields.config import BLS12_377_FR, BN254_FP, BN254_FR
from panda_tpu_torch.ops import (_ext, digits, fmul, hist, ntt_fused,
                                 ntt_pallas, phase_a, point_kernels)
from panda_tpu_torch.reference import curve_ref
from panda_tpu_torch.tools import profile_gather4

CSRC = _ext.CSRC
NTT_FIELDS = pytest.mark.parametrize("fr", [BN254_FR, BLS12_377_FR],
                                     ids=lambda f: f.name)
HARNESS = r"""
#include "point_ops.cu"
#include "digits.cu"
#include "hist.cu"
#include "phase_a.cu"
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
// The kernel's steps for one column at a time (a tile of one column).
template <class F>
void small_ntt_all(In x, In tw, In pre, In scale, Out out, int64_t nb,
                   int log_k, int64_t pre_cols, int reduce_in,
                   int canonical_out) {
  const int K = 1 << log_k;
  const int64_t batch = pre ? nb / pre_cols : 1;
  std::vector<uint32_t> col(8 * K);
  for (int64_t c = 0; c < nb; ++c) {
    for (int j = 0; j < K; ++j)
      store_fe(col.data() + bitrev(j, log_k), 0, K,
               small_ntt_load<F>(x, pre, nb, K, j, c, pre_cols, batch,
                                 reduce_in));
    for (int s = 0; s < log_k; ++s)
      for (int q = 0; q < K / 2; ++q)
        small_ntt_butterfly<F>(col.data(), K, 1, tw, K, s, q);
    for (int k = 0; k < K; ++k)
      small_ntt_store<F>(out, nb, K, k, c, load_fe(col.data() + k, 0, K),
                         scale, canonical_out);
  }
}

// The kernel's blocks one after another: stage the (g, c0) tile, then look
// up every element of it.
void dg3_all(const int32_t* tab, const int32_t* idx, int32_t* out, int64_t G,
             int R) {
  std::vector<int32_t> tile((size_t)R * kDg3Tile);
  for (int64_t g = 0; g < G; ++g)
    for (int c0 = 0; c0 < kDg3Cols; c0 += kDg3Tile) {
      for (int e = 0; e < R * kDg3Tile; ++e)
        dg3_stage(tab, tile.data(), g, R, c0, e);
      for (int e = 0; e < R * kDg3Tile; ++e)
        dg3_lookup(tile.data(), idx, out, g, R, c0, e);
    }
}

extern "C" {
void h_fp(int op, In a, In b, Out r, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe x = load_fe(a, i, n), y = load_fe(b, i, n);
    fe z = op == 0 ? mont_mul<Fp254>(x, y)
         : op == 1 ? add_mod<Fp254>(x, y) : sub_mod<Fp254>(x, y);
    store_fe(r, i, n, z);
  }
}
void h_padd(In px, In py, In pz, In qx, In qy, In qz, Out rx, Out ry, Out rz,
            int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    padd_elem(px, py, pz, qx, qy, qz, rx, ry, rz, i, n);
}
void h_pmadd(In px, In py, In pz, In qx, In qy, Out rx, Out ry, Out rz,
             int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    pmadd_elem(px, py, pz, qx, qy, rx, ry, rz, i, n);
}
void h_pdbl(In px, In py, In pz, Out rx, Out ry, Out rz, int64_t n) {
  for (int64_t i = 0; i < n; ++i) pdbl_elem(px, py, pz, rx, ry, rz, i, n);
}
void h_digits(In s, Out mags, uint8_t* negs, int64_t n, int c, int W) {
  for (int64_t j = 0; j < n; ++j) digits_elem(s, mags, negs, j, n, c, W);
}
void h_hist(In d, int32_t* counts, int64_t W, int64_t N, int D) {
  for (int64_t i = 0; i < W * N; ++i) hist_elem(d, counts, i, N, D);
}
void h_phase_a(In keys, In sidx, In px, In py, int64_t n, Out ek, Out ex,
               Out ey, Out ez, Out tk, Out tx, Out ty, Out tz, int64_t W,
               int64_t m, int64_t S, int dead) {
  for (int64_t l = 0; l < W * m; ++l)
    phase_a_lane(keys, sidx, px, py, n, ek, ex, ey, ez, tk, tx, ty, tz, l, m,
                 S, W * m, (uint32_t)dead);
}
void h_wscan(In bx, In by, In bz, Out rx, Out ry, Out rz, Out wx, Out wy,
             Out wz, int64_t N, int64_t S) {
  for (int64_t c = 0; c < N; ++c)
    wscan_col(bx, by, bz, rx, ry, rz, wx, wy, wz, c, N, S);
}
void h_fmul(In a, In b, Out r, int64_t n, int canonical_out, int field) {
  if (field) fmul_all<Fr377>(a, b, r, n, canonical_out);
  else fmul_all<Fr254>(a, b, r, n, canonical_out);
}
void h_dft(In x, In mat, Out out, int64_t nb, int K, int canonical_out,
           int field) {
  if (field) dft_host<Fr377>(x, mat, out, nb, K, canonical_out);
  else dft_host<Fr254>(x, mat, out, nb, K, canonical_out);
}
void h_small_ntt(In x, In tw, In pre, In scale, Out out, int64_t nb,
                 int log_k, int64_t pre_cols, int reduce_in,
                 int canonical_out, int field) {
  if (field)
    small_ntt_all<Fr377>(x, tw, pre, scale, out, nb, log_k, pre_cols,
                         reduce_in, canonical_out);
  else
    small_ntt_all<Fr254>(x, tw, pre, scale, out, nb, log_k, pre_cols,
                         reduce_in, canonical_out);
}
void h_dg3(const int32_t* tab, const int32_t* idx, int32_t* out, int64_t G,
           int R) {
  dg3_all(tab, idx, out, G, R);
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


def _points(n, seed):
    """n affine points (port words) plus n projective points that include
    the identity, equal and opposite pairs."""
    rng = random.Random(seed)
    fp = BN254_FP
    R = mont.radix(fp)
    aff = [curve_ref.random_point(BN254, rng) for _ in range(n)]
    ax = _words(fp, [x * R % fp.modulus for x, _ in aff])
    ay = _words(fp, [y * R % fp.modulus for _, y in aff])
    # projective: random z scaling, identity at 0, q = p at 1, q = -p at 2
    zs = [rng.randrange(1, fp.modulus) for _ in range(n)]
    px = _words(fp, [x * z * R % fp.modulus for (x, _), z in zip(aff, zs)])
    py = _words(fp, [y * z * R % fp.modulus for (_, y), z in zip(aff, zs)])
    pz = _words(fp, [z * R % fp.modulus for z in zs])
    p = ProjPoint(px, py, pz)
    ident = cp.identity(BN254, (n,))
    p = ProjPoint(*(torch.cat([i[:, :1], a[:, 1:]], 1) for i, a in zip(ident, p)))
    return p, AffinePoint(ax, ay)


@pytest.mark.parametrize("struct,spec", [("Fp254", BN254_FP),
                                         ("Fr254", BN254_FR),
                                         ("Fr377", BLS12_377_FR)],
                         ids=["Fp254", "Fr254", "Fr377"])
def test_field_constants_match_field_config(struct, spec):
    text = (CSRC / "field.cuh").read_text()

    def arr(struct, fn):
        body = text.split(f"struct {struct}")[1].split(f" {fn}(int i)")[1]
        words = re.findall(r"0x([0-9a-f]{8})u", body.split("};")[0])
        return sum(int(w, 16) << (32 * i) for i, w in enumerate(words))

    def ninv(struct):
        body = text.split(f"struct {struct}")[1]
        return int(re.search(r"ninv = 0x([0-9a-f]{8})u", body).group(1), 16)

    R = 1 << 256
    p = spec.modulus
    assert arr(struct, "p") == p
    assert arr(struct, "p2") == 2 * p
    assert arr(struct, "one") == R % p
    assert ninv(struct) == (-pow(p, -1, 1 << 32)) % (1 << 32)
    assert 4 * p < R
    body = text.split(f"struct {struct}")[1].split("};")[0]
    top = re.search(r"wide_top = (\d+);", body)
    if spec.two_adicity:                     # the NTT fields: reduce_wide
        assert int(top.group(1)) == (R // p).bit_length() - 1
        assert p << int(top.group(1)) < R
    if struct == "Fr377":                    # the DFT's 9-word REDC
        ntt_fused.check_bounds(spec, 5)


@pytest.mark.parametrize("name", ["fmul", "dft", "small_ntt"])
def test_field_ids_match_ntt_fields(name):
    """Each NTT launcher maps field id i to the struct of _ext.NTT_FIELDS[i]."""
    text = (CSRC / f"{name}.cu").read_text()
    ids = dict(re.findall(r"case (\d+):\s*return \w+<ptt::(\w+)>", text))
    struct = {"bn254_fr": "Fr254", "bls12_377_fr": "Fr377"}
    assert ids == {str(i): struct[f] for i, f in enumerate(_ext.NTT_FIELDS)}


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_ops_bit_identical(host, op):
    fp = BN254_FP
    p = fp.modulus
    rng = random.Random(7)
    edge = [0, 1, p - 1, p, p + 1, 2 * p - 2, 2 * p - 1]
    a = edge * len(edge) + [rng.randrange(2 * p) for _ in range(200)]
    b = [e for e in edge for _ in edge] + [rng.randrange(2 * p)
                                           for _ in range(200)]
    A, B = _words(fp, a), _words(fp, b)
    out = np.empty_like(_np(A))
    _call(host.h_fp, ("i32", ["mul", "add", "sub"].index(op)), _np(A),
          _np(B), out, len(a))
    plain = {"mul": mont.mul, "add": mont.add, "sub": mont.sub}[op](fp, A, B)
    np.testing.assert_array_equal(out, _np(plain))
    assert all(v < 2 * p for v in mont.words_to_ints(out))


def test_point_ops_bit_identical(host):
    n = 24
    p, q_aff = _points(n, 11)
    q = cp.from_affine(BN254, q_aff)
    q = ProjPoint(*(torch.cat([a[:, :2], b[:, 2:3], c[:, 3:]], 1)
                    for a, b, c in zip(p, cp.neg(BN254, p), q)))
    outs = [np.empty_like(_np(p.x)) for _ in range(3)]
    _call(host.h_padd, *map(_np, p), *map(_np, q), *outs, n)
    for o, e in zip(outs, cp.add_plain(BN254, p, q)):
        np.testing.assert_array_equal(o, _np(e))
    _call(host.h_pmadd, *map(_np, p), *map(_np, q_aff), *outs, n)
    for o, e in zip(outs, cp.madd_plain(BN254, p, q_aff)):
        np.testing.assert_array_equal(o, _np(e))
    _call(host.h_pdbl, *map(_np, p), *outs, n)
    for o, e in zip(outs, cp.dbl_plain(BN254, p)):
        np.testing.assert_array_equal(o, _np(e))


@pytest.mark.parametrize("c", [7, 13, 16])
def test_signed_digits_bit_identical(host, c):
    fr = BN254_FR
    rng = random.Random(c)
    vals = [0, 1, fr.modulus - 1, fr.modulus, (1 << 256) - 1] + \
        [rng.randrange(1 << 256) for _ in range(59)]
    s = _words(fr, vals)
    W = -(-fr.bits // c) + (1 if (-(-fr.bits // c)) * c < fr.bits + 1 else 0)
    mags = np.empty((W, len(vals)), np.uint32)
    negs = np.empty((W, len(vals)), np.uint8)
    _call(host.h_digits, _np(s), mags, negs, len(vals), ("i32", c),
          ("i32", W))
    em, en = digits.signed_digits_plain(fr, s, c, W)
    np.testing.assert_array_equal(mags.view(np.int32), _np(em))
    np.testing.assert_array_equal(negs.astype(bool), _np(en))


def test_hist_counts_identical(host):
    rng = np.random.default_rng(5)
    W, N, D = 3, 3000, 512
    d = rng.integers(0, D + 2, size=(W, N)).astype(np.int32)
    d[:, :40] = 0
    counts = np.zeros((W, D), np.int32)
    _call(host.h_hist, d, counts, W, N, ("i32", D))
    np.testing.assert_array_equal(counts,
                                  _np(hist.hist_counts_plain(torch.from_numpy(d), D)))


def test_phase_a_bit_identical(host):
    W, S, m, n, D = 2, 6, 4, 20, 8
    rng = np.random.default_rng(9)
    _, base = _points(n, 13)
    keys = np.sort(rng.integers(0, D + 1, size=(W, S * m)), axis=1)
    keys[:, -3:] = D + 1                                  # dead padding
    idx = rng.integers(0, n, size=(W, S * m))
    sgn = rng.integers(0, 2, size=(W, S * m)).astype(bool)
    sidx = np.where(sgn, idx | -(1 << 31), idx)

    def sm(a):      # lane-major (W, S*m) -> step-major (W, S, m) int32
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape(W, m, S).transpose(0, 2, 1)).astype(np.int32))

    k5, s5 = sm(keys), sm(sidx)
    ek, ep, tk, tp = phase_a.scan_plain(BN254, k5, s5, base.x, base.y, D + 1)
    P = W * S * m
    o_ek = np.empty((W, S, m), np.uint32)
    o_e = [np.full((8, P), 0xA5A5A5A5, np.uint32) for _ in range(3)]
    o_tk = np.empty((W, m), np.uint32)
    o_t = [np.empty((8, W * m), np.uint32) for _ in range(3)]
    _call(host.h_phase_a, _np(k5), _np(s5), _np(base.x), _np(base.y), n,
          o_ek, *o_e, o_tk, *o_t, W, m, S, ("i32", D + 1))
    np.testing.assert_array_equal(o_ek.view(np.int32), _np(ek))
    np.testing.assert_array_equal(o_tk.view(np.int32), _np(tk))
    # emissions are defined where a run ended; nothing is stored elsewhere
    ended = _np(ek).reshape(P) != D + 1
    assert 0 < ended.sum() < P
    for o, e in zip(o_e, ep):
        np.testing.assert_array_equal(o.view(np.int32)[:, ended],
                                      _np(e).reshape(8, P)[:, ended])
        assert (o[:, ~ended] == 0xA5A5A5A5).all()
    for o, e in zip(o_t, tp):
        np.testing.assert_array_equal(o.view(np.int32),
                                      _np(e).reshape(8, W * m))


def test_weighted_scan_bit_identical(host):
    S, N = 5, 6
    p, _ = _points(S * N, 17)
    b = ProjPoint(*(a.reshape(8, S, N).contiguous() for a in p))
    run, wsum = point_kernels.weighted_scan_plain(BN254, b)
    outs = [np.empty((8, N), np.uint32) for _ in range(6)]
    _call(host.h_wscan, *map(_np, b), *outs, N, S)
    for o, e in zip(outs, (*run, *wsum)):
        np.testing.assert_array_equal(o.view(np.int32), _np(e))


@NTT_FIELDS
def test_fmul_bit_identical(host, fr):
    """fmul.cu's body against the plain version: a, b < 2r give < 2r (and
    canonical with canonical_out); a < R times the plain 1 gives <= r."""
    r = fr.modulus
    field = ("i32", _ext.NTT_FIELDS.index(fr.name))
    rng = random.Random(21)
    edge = [0, 1, r - 1, r, r + 1, 2 * r - 1]
    a = edge * len(edge) + [rng.randrange(2 * r) for _ in range(100)]
    b = [e for e in edge for _ in edge] + [rng.randrange(2 * r)
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
        limit = r if canon else (r + 1 if bv[0] == 1 else 2 * r)
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
        assert all(v < (r if canon else 2 * r)
                   for v in mont.words_to_ints(out.reshape(8, -1)))


@NTT_FIELDS
@pytest.mark.parametrize("log_k,pre", [(3, False), (3, True), (6, False),
                                       (6, True)])
def test_small_ntt_bit_identical(host, log_k, pre, fr):
    """small_ntt.cu's body (load with the bit reversal, butterflies, store)
    against the plain version: any words below 2^256 with reduce_in, and
    words below 2r with the pre-twiddle table (B = 3 of 6 columns, so
    batch 2), the inverse's scale and the canonical store."""
    r = fr.modulus
    K, nb, B = 1 << log_k, 6, 3
    rng = random.Random(log_k)
    wide = [rng.randrange(1 << 256) for _ in range(K * nb)]
    wide[:4] = [(1 << 256) - 1, r, 2 * r - 1, 2 * r + 7]
    lazy = [rng.randrange(2 * r) for _ in range(K * nb)]
    tw = ntt_pallas.stage_twiddle_rows(fr, log_k, fr.root_of_unity(log_k))
    table = _words(fr, [rng.randrange(r) for _ in range(K * B)])
    table = table.reshape(8, K, B).contiguous() if pre else None
    scale = _words(fr, [fr.to_wire_int(pow(K, -1, r))]).reshape(8)
    for vals, sc, reduce_in, canon in ((wide, None, True, False),
                                       (lazy, scale, False, True)):
        x = _words(fr, vals).reshape(8, K, nb).contiguous()
        out = np.empty((8, K, nb), np.uint32)
        _call(host.h_small_ntt, _np(x), _np(tw),
              None if table is None else _np(table),
              None if sc is None else _np(sc), out, nb, ("i32", log_k),
              B if pre else 1, ("i32", int(reduce_in)), ("i32", int(canon)),
              ("i32", _ext.NTT_FIELDS.index(fr.name)))
        want = ntt_pallas.small_ntt_batch_plain(fr, x, log_k, tw, table, sc,
                                                reduce_in, canon)
        np.testing.assert_array_equal(out.view(np.int32), _np(want))
        assert all(v < (r if canon else 2 * r)
                   for v in mont.words_to_ints(out.reshape(8, -1)))


@pytest.mark.parametrize("R", profile_gather4.DEPTHS)
def test_dg3_bit_identical(host, R):
    """dg3.cu's staging and lookup, block by block, against the plain
    version on int32 words that include negative bit patterns; an index
    outside [0, R) gives 0 and reads nothing."""
    G = 3
    rng = np.random.default_rng(R)
    tab = rng.integers(-(1 << 31), 1 << 31, size=(G, R, 128)).astype(np.int32)
    idx = rng.integers(R, size=(G, R, 128)).astype(np.int32)
    out = np.empty_like(tab)
    _call(host.h_dg3, tab, idx, out, G, ("i32", R))
    want = profile_gather4.dg3_plain(torch.from_numpy(tab),
                                     torch.from_numpy(idx))
    np.testing.assert_array_equal(out, _np(want))
    idx[0, 0, :3] = [-1, R, 1 << 30]
    _call(host.h_dg3, tab, idx, out, G, ("i32", R))
    assert (out[0, 0, :3] == 0).all()
