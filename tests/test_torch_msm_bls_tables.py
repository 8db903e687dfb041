"""The BLS12-377 and BLS12-381 MSMs' bucket tables and window sums (plain
versions on the CPU) against their definition, from the same signed
digits, points and scalars.  Every comparison is exact.
"""

import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.curves.config import CURVES as JCURVES
from panda_tpu.reference import curve_ref as jref
from panda_tpu_torch.curves.config import BLS12_377, BLS12_381
from panda_tpu_torch.curves.point import ProjPoint
from panda_tpu_torch.fields import mont
from panda_tpu_torch.ops import msm, reduce
from tests.jax_release import release_jax_programs  # noqa: F401

CURVES = [BLS12_377, BLS12_381]


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
