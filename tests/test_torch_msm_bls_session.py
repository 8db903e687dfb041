"""The BLS12-377 and BLS12-381 MSM sessions against the JAX package's: the
byte API's error codes, and the JAX session's ingested bases, converted
with ``mont.from_jax_limbs``, running to the same blob as the port's.
Every comparison is exact: bytes and integers equal.
"""

import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.curves.config import CURVES as JCURVES
from panda_tpu.reference import curve_ref as jref
from panda_tpu.runtime import api as japi
from panda_tpu.runtime import manager as jmanager
from panda_tpu.runtime.errors import PandaRuntimeError as JPandaRuntimeError
from panda_tpu_torch import InitUnitType, PandaManager
from panda_tpu_torch.curves.config import BLS12_377, BLS12_381
from panda_tpu_torch.fields import mont
from panda_tpu_torch.runtime import api
from panda_tpu_torch.runtime.errors import PandaError, PandaRuntimeError
from tests.jax_release import release_jax_programs  # noqa: F401

N = 32
CURVES = [BLS12_377, BLS12_381]
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
