"""The BLS12-377 and BLS12-381 MSMs' modules that hold kernels, against
the JAX package: the digit recode and the mixed add against small jitted
JAX pieces, the complete add and doubling against the JAX package's
big-integer oracle (``panda_tpu.reference.curve_ref``, with the JAX
package's curves).  Every comparison is exact: integers equal, points equal
after affine normalisation.  The bucket tables and window sums are tested
in ``test_torch_msm_bls_tables.py``, the byte API in
``test_torch_msm_bls.py``.
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
from panda_tpu_torch.curves import point as cp
from panda_tpu_torch.curves.config import BLS12_377, BLS12_381
from panda_tpu_torch.curves.point import AffinePoint, ProjPoint
from panda_tpu_torch.fields import mont
from panda_tpu_torch.ops import msm
from tests.jax_release import release_jax_programs  # noqa: F401

CURVES = [BLS12_377, BLS12_381]
CURVE = pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)


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
