"""The BLS12-377 and BLS12-381 MSMs: the port's byte API (plain versions on
the CPU) and the modules that hold its kernels, against the JAX package.

The JAX package's byte-API MSM compiles for several minutes on a CPU for a
BLS curve, even at n = 16, so the tier-1 tests hold the port's blobs to the
JAX package's big-integer oracle (``panda_tpu.reference.curve_ref``, with
the JAX package's curves) and its kernel modules to small jitted JAX
pieces: the digit recode, the mixed add and the bases ingest.  The byte-for-byte comparison with the JAX byte API is
the one test marked ``slow``.  Every comparison is exact: bytes and integers
equal, points equal after affine normalisation.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.curves import point as jcp
from panda_tpu.curves.config import CURVES as JCURVES
from panda_tpu.fields import codec
from panda_tpu.ops import msm as jmsm
from panda_tpu.reference import curve_ref as jref
from panda_tpu.runtime import api as japi
from panda_tpu.runtime import manager as jmanager
from panda_tpu.runtime.errors import PandaRuntimeError as JPandaRuntimeError
from panda_tpu_torch import InitUnitType, PandaManager, ResultCoordinateType
from panda_tpu_torch.curves import point as cp
from panda_tpu_torch.curves.config import BLS12_377, BLS12_381
from panda_tpu_torch.curves.point import AffinePoint, ProjPoint
from panda_tpu_torch.fields import mont
from panda_tpu_torch.ops import msm, reduce
from panda_tpu_torch.runtime import api
from panda_tpu_torch.runtime.errors import PandaError, PandaRuntimeError

N = 32
CURVES = [BLS12_377, BLS12_381]
CURVE = pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
ALIAS = {"bls12_377": (api.msm_bls12_377, japi.msm_bls12_377),
         "bls12_381": (api.msm_bls12_381, japi.msm_bls12_381)}


def _blob(spec, vals) -> bytes:
    return b"".join(spec.to_wire_int(v).to_bytes(spec.n_bytes, "little")
                    for v in vals)


def _oracle_blob(jcurve, pt) -> bytes:
    """The result blob of an affine oracle point (None: the identity)."""
    return _blob(jcurve.fp, (0, 1, 0) if pt is None else (*pt, 1))


def _affine(curve, pt: ProjPoint) -> list:
    """Port coordinates (L, *batch) -> affine ints (None: identity); the
    Montgomery factor cancels in X/Z and Y/Z."""
    p = curve.fp.modulus
    L = mont.n_words(curve.fp)
    out = []
    for x, y, z in zip(*(mont.words_to_ints(a.reshape(L, -1)) for a in pt)):
        z %= p
        zi = pow(z, -1, p) if z else None
        out.append(None if z == 0 else (x * zi % p, y * zi % p))
    return out


def _mont_words(curve, vals) -> torch.Tensor:
    fp = curve.fp
    return mont.words_tensor(mont.ints_to_words(fp, [fp.to_wire_int(v)
                                                     for v in vals]))


@pytest.fixture(scope="module", params=CURVES, ids=lambda c: c.name)
def case(request):
    """n = 32 random points of the JAX package's curve, full-range scalars,
    the port's session on the CPU, the JAX package's session (bases
    ingested), and the oracle's blob."""
    curve = request.param
    jcurve = JCURVES[curve.name]
    rng = random.Random(377 if curve is BLS12_377 else 381)
    pts = [jref.random_point(jcurve, rng) for _ in range(N)]
    scalars = [rng.randrange(jcurve.fr.modulus) for _ in range(N)]
    bases = b"".join(_blob(jcurve.fp, pt) for pt in pts)
    return {"curve": curve, "jcurve": jcurve, "pts": pts,
            "scalars": scalars, "bases": bases,
            "sblob": _blob(jcurve.fr, scalars),
            "gm": PandaManager.init_all(0, InitUnitType.MSM, [bases],
                                        curve=curve, device="cpu"),
            "jgm": jmanager.PandaManager.init_all(
                0, jmanager.InitUnitType.MSM, [bases], curve=curve.name),
            "want": _oracle_blob(jcurve, jref.msm_oracle(jcurve, pts,
                                                         scalars))}


def test_aliases_and_msm_match_oracle(case):
    """msm_bls12_377 / msm_bls12_381 and msm: 48-byte coordinates in, the
    144-byte blob out, equal to the big-integer oracle's."""
    alias, _ = ALIAS[case["curve"].name]
    assert len(case["want"]) == 3 * 48
    assert alias(case["gm"], case["sblob"], case["bases"]) == case["want"]
    assert api.msm(case["gm"], case["sblob"], case["bases"]) == case["want"]


def test_cached_variants_match_oracle(case):
    gm = case["gm"]
    assert api.msm_with_cached_bases(gm, case["sblob"], 0) == case["want"]
    sidx = gm.init_msm_cached_scalars(case["sblob"])
    assert api.msm_with_cached_scalars(gm, case["bases"], sidx) == \
        case["want"]
    assert api.msm_with_cached_input(gm, sidx, 0) == case["want"]


def test_projective_output_and_identity_blob(case):
    gm = case["gm"]
    gm.set_config(ResultCoordinateType.PROJECTIVE)
    try:
        assert api.msm_with_cached_bases(gm, case["sblob"], 0) == \
            case["want"]
        zeros = bytes(32 * N)
        assert api.msm_with_cached_bases(gm, zeros, 0) == \
            _oracle_blob(case["jcurve"], None)
    finally:
        gm.set_config(ResultCoordinateType.JACOBIAN)


def test_error_codes_match_jax(case):
    """The same codes as the JAX package's, by name, for the wrong curve's
    alias, a ragged scalar blob and cached indices out of range."""
    curve, gm, jgm = case["curve"], case["gm"], case["jgm"]
    other = BLS12_381 if curve is BLS12_377 else BLS12_377
    sblob, bases = case["sblob"], case["bases"]
    bn = PandaManager.new(0, device="cpu")
    jbn = jmanager.PandaManager.new(0)
    wrong = ALIAS[other.name]
    mine = ALIAS[curve.name]
    for call, jcall in (
            (lambda: wrong[0](gm, sblob, bases),
             lambda: wrong[1](jgm, sblob, bases)),
            (lambda: api.msm_bn254(gm, sblob, bases),
             lambda: japi.msm_bn254(jgm, sblob, bases)),
            (lambda: mine[0](bn, sblob, bases),
             lambda: mine[1](jbn, sblob, bases)),
            (lambda: api.msm(gm, sblob[:-1], bases),
             lambda: japi.msm(jgm, sblob[:-1], bases)),
            (lambda: api.msm_with_cached_bases(gm, sblob, 3),
             lambda: japi.msm_with_cached_bases(jgm, sblob, 3)),
            (lambda: api.msm_with_cached_input(gm, 7, 0),
             lambda: japi.msm_with_cached_input(jgm, 7, 0))):
        with pytest.raises(PandaRuntimeError) as e:
            call()
        with pytest.raises(JPandaRuntimeError) as je:
            jcall()
        assert e.value.code.name == je.value.code.name
        assert e.value.code in (PandaError.UNSUPPORTED_CURVE,
                                PandaError.INVALID_CONFIGURATION,
                                PandaError.INVALID_VALUE)
    with pytest.raises(PandaRuntimeError) as e:
        api.msm(gm, sblob, bases[:-3])                  # not 96-byte points
    assert e.value.code == PandaError.INVALID_CONFIGURATION


def test_bases_carried_from_jax_run_to_the_same_blob(case):
    """The JAX session's ingested bases (15-bit limbs), converted with
    from_jax_limbs, are the port's (12, n) words and run to the same blob."""
    fp = case["curve"].fp
    jx, jy = (np.asarray(a) for a in case["jgm"].d_bases[0])
    px, py = (mont.from_jax_limbs(fp, a) for a in (jx, jy))
    assert px.shape == (12, N)
    assert torch.equal(px, case["gm"].d_bases[0][0])
    assert torch.equal(py, case["gm"].d_bases[0][1])
    other = PandaManager.new(0, case["curve"], device="cpu")
    other.d_bases.append((px, py))
    other.init_msm_cached_scalars(case["sblob"])
    assert api.msm_with_cached_input(other, 0, 0) == case["want"]


@CURVE
def test_signed_digits_match_jax(curve):
    """msm.signed_digit_arrays against the JAX package's plain recode
    (kernels="off"), with W from the field's own bits."""
    jfr = JCURVES[curve.name].fr
    r, c = curve.fr.modulus, 13
    rng = random.Random(13)
    vals = [0, 1, r - 1] + [rng.randrange(r) for _ in range(61)]
    port = mont.words_tensor(mont.ints_to_words(
        curve.fr, [curve.fr.to_wire_int(v) for v in vals]))
    jsc = jnp.asarray(codec.ints_to_limbs(jfr, [jfr.to_mont_int(v)
                                                for v in vals]))
    mags, negs = msm.signed_digit_arrays(curve.fr, port, c)
    jm, jn = jax.jit(lambda s: jmsm.signed_digit_arrays(
        jfr, s, c, kernels="off"))(jsc)
    assert mags.shape[0] == msm.signed_window_count(curve.fr.bits, c)
    np.testing.assert_array_equal(mags.numpy().astype(np.uint32),
                                  np.asarray(jm))
    np.testing.assert_array_equal(negs.numpy(), np.asarray(jn))


def _proj_case(curve, seed):
    """8 projective points with random Z (the identity at 0) and 8 partners
    (p itself at 1, -p at 2), as affine ints and port words."""
    jcurve = JCURVES[curve.name]
    p = curve.fp.modulus
    rng = random.Random(seed)
    aff = [None] + [jref.random_point(jcurve, rng) for _ in range(7)]
    other = [None, aff[1], jref.ec_neg(jcurve, aff[2])] + \
        [jref.random_point(jcurve, rng) for _ in range(5)]

    def proj(pts):
        cols = []
        for pt in pts:
            z = rng.randrange(1, p)
            cols.append((0, 1, 0) if pt is None else
                        (pt[0] * z % p, pt[1] * z % p, z))
        return ProjPoint(*(_mont_words(curve, c) for c in zip(*cols)))

    return jcurve, aff, other, proj(aff), proj(other)


@CURVE
def test_add_and_dbl_match_curve_ref(curve):
    """cp.add and cp.dbl (complete formulas, b3 = 3 and 12) against the JAX
    package's big-integer ec_add, with the identity, p + p and p - p."""
    jcurve, aff, other, p, q = _proj_case(curve, 5)
    assert _affine(curve, cp.add(curve, p, q)) == \
        [jref.ec_add(jcurve, a, b) for a, b in zip(aff, other)]
    assert _affine(curve, cp.dbl(curve, p)) == \
        [jref.ec_add(jcurve, a, a) for a in aff]


@CURVE
def test_madd_matches_jax(curve):
    """cp.madd against the JAX package's jitted mixed add."""
    jcurve, aff, _, p, _ = _proj_case(curve, 6)
    jfp = jcurve.fp
    rng = random.Random(7)
    q = [jref.random_point(jcurve, rng) for _ in range(8)]
    q[3] = aff[3]                                       # the doubling case

    def jwords(vals):
        return jnp.asarray(codec.ints_to_limbs(jfp, [jfp.to_mont_int(v)
                                                     for v in vals]))

    px, py, pz = (mont.words_to_ints(a) for a in p)
    rinv = pow(mont.radix(curve.fp), -1, jfp.modulus)
    jp = jcp.ProjPoint(*(jwords([v * rinv % jfp.modulus for v in c])
                         for c in (px, py, pz)))
    xs, ys = zip(*q)
    got = cp.madd(curve, p, AffinePoint(_mont_words(curve, xs),
                                        _mont_words(curve, ys)))
    want = jax.jit(lambda a, b: jcp.madd(jcurve, a, b))(
        jp, jcp.AffinePoint(jwords(xs), jwords(ys)))
    jx, jy, jz = (codec.limbs_to_ints(jfp, np.asarray(a)) for a in want)
    P = jfp.modulus
    assert _affine(curve, got) == [
        None if z % P == 0 else (x * pow(z, -1, P) % P, y * pow(z, -1, P) % P)
        for x, y, z in zip(jx, jy, jz)]
    assert _affine(curve, got) == [jref.ec_add(jcurve, a, b)
                                   for a, b in zip(aff, q)]


@pytest.fixture(scope="module", params=CURVES, ids=lambda c: c.name)
def bucket_case(request):
    """W = 2 windows of n = 48 signed digits at c = 10 (D = 512, the
    histogram path) over random bases, through the port's bucket tables
    and window sums once."""
    curve = request.param
    jcurve = JCURVES[curve.name]
    W, n, c, m = 2, 48, 10, 8
    D = 1 << (c - 1)
    rng = np.random.default_rng(48)
    mags = rng.integers(0, D + 1, size=(W, n))
    mags[:, :5] = 0
    mags[:, 5:9] = 7                                  # one long run
    negs = rng.integers(0, 2, size=(W, n)).astype(bool)
    pts = [jref.random_point(jcurve, random.Random(100 + i))
           for i in range(n)]
    px, py = (_mont_words(curve, v) for v in zip(*pts))
    bt = msm._bucket_tables(curve, px, py,
                            torch.from_numpy(mags.astype(np.int32)),
                            torch.from_numpy(negs), c, m)
    return {"curve": curve, "jcurve": jcurve, "bt": bt, "mags": mags,
            "negs": negs, "pts": pts, "D": D}


def test_bucket_tables_match_definition(bucket_case):
    """B_b = sum of +-P_i over the digits equal to b, in big integers."""
    bc = bucket_case
    curve, jcurve, D = bc["curve"], bc["jcurve"], bc["D"]
    got = _affine(curve, bc["bt"])
    for w in range(bc["mags"].shape[0]):
        for b in (1, 7, D):
            acc = None
            for i in np.nonzero(bc["mags"][w] == b)[0]:
                pt = bc["pts"][i]
                acc = jref.ec_add(jcurve, acc, jref.ec_neg(jcurve, pt)
                                  if bc["negs"][w, i] else pt)
            assert got[w * D + b - 1] == acc
    assert got[7 - 1] is not None                       # the long run


def test_window_sums_match_definition(bucket_case):
    """sum_b b B_b = sum_i (+-mag_i) P_i per window, in big integers."""
    bc = bucket_case
    curve, jcurve = bc["curve"], bc["jcurve"]
    got = _affine(curve, reduce.weighted_window_sum(curve, bc["bt"]))
    want = []
    for w in range(bc["mags"].shape[0]):
        acc = None
        for i, (mag, neg) in enumerate(zip(bc["mags"][w], bc["negs"][w])):
            pt = jref.ec_mul(jcurve, bc["pts"][i], int(mag))
            acc = jref.ec_add(jcurve, acc, jref.ec_neg(jcurve, pt)
                              if neg else pt)
        want.append(acc)
    assert got == want


@pytest.mark.slow
@CURVE
def test_byte_api_matches_jax(curve):
    """msm_bls12_377 / msm_bls12_381 at n = 16, byte-equal to the JAX
    package's byte API (its BLS MSM pipeline compiles for minutes on a
    CPU, hence slow)."""
    jcurve = JCURVES[curve.name]
    rng = random.Random(16)
    pts = [jref.random_point(jcurve, rng) for _ in range(16)]
    scalars = [rng.randrange(jcurve.fr.modulus) for _ in range(16)]
    bases = b"".join(_blob(jcurve.fp, pt) for pt in pts)
    sblob = _blob(jcurve.fr, scalars)
    alias, jalias = ALIAS[curve.name]
    got = alias(PandaManager.new(0, curve, device="cpu"), sblob, bases)
    want = jalias(jmanager.PandaManager.new(0, curve.name), sblob, bases)
    assert got == want
    assert got == _oracle_blob(jcurve, jref.msm_oracle(jcurve, pts, scalars))
