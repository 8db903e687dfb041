"""The BLS12-377 and BLS12-381 MSMs: the port's byte API (plain versions on
the CPU) against the JAX package.

The JAX package's byte-API MSM compiles for several minutes on a CPU for a
BLS curve, even at n = 16, so the tier-1 tests hold the port's blobs to the
JAX package's big-integer oracle (``panda_tpu.reference.curve_ref``, with
the JAX package's curves) and its bases ingest to the JAX session's.  The
byte-for-byte comparison with the JAX byte API is the one test marked
``slow``.  Every comparison is exact: bytes and integers equal.  The
error codes and the carried bases are tested in
``test_torch_msm_bls_session.py``, the modules that hold the MSM's kernels
in ``test_torch_msm_bls_kernels.py`` and ``test_torch_msm_bls_tables.py``.
"""

import random

import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.curves.config import CURVES as JCURVES
from panda_tpu.reference import curve_ref as jref
from panda_tpu.runtime import api as japi
from panda_tpu.runtime import manager as jmanager
from panda_tpu_torch import InitUnitType, PandaManager, ResultCoordinateType
from panda_tpu_torch.curves.config import BLS12_377, BLS12_381
from panda_tpu_torch.runtime import api
from tests.jax_release import release_jax_programs  # noqa: F401

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
