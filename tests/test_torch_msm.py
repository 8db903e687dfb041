"""The slice: the port's byte-level MSM API (plain versions on the CPU)
against the JAX package's on the same blobs, byte for byte, and against the
big-integer oracle.  One n = 64 shape, so the JAX pipeline compiles once.
"""

import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.runtime import api as japi
from panda_tpu.runtime import manager as jmanager
from panda_tpu.runtime.errors import PandaError as JPandaError
from panda_tpu.runtime.errors import PandaRuntimeError as JPandaRuntimeError
from panda_tpu_torch import InitUnitType, PandaManager, ResultCoordinateType
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.fields import mont
from panda_tpu_torch.reference import curve_ref
from panda_tpu_torch.runtime import api
from panda_tpu_torch.runtime.errors import PandaError, PandaRuntimeError
from tests.jax_release import release_jax_programs  # noqa: F401

N = 64
FP, FR = BN254.fp, BN254.fr


def _blob(vals, spec):
    return b"".join(spec.to_wire_int(v).to_bytes(spec.n_bytes, "little")
                    for v in vals)


@pytest.fixture(scope="module")
def case():
    rng = random.Random(64)
    pts = [curve_ref.random_point(BN254, rng) for _ in range(N)]
    scalars = [rng.randrange(FR.modulus) for _ in range(N)]
    bases = b"".join(_blob(pt, FP) for pt in pts)
    jgm = jmanager.PandaManager.init_all(0, jmanager.InitUnitType.MSM,
                                         [bases])
    return {"pts": pts, "scalars": scalars, "bases": bases,
            "sblob": _blob(scalars, FR), "jgm": jgm,
            "exp": curve_ref.msm_oracle(BN254, pts, scalars)}


@pytest.fixture(scope="module")
def gm(case):
    return PandaManager.init_all(0, InitUnitType.MSM, [case["bases"]],
                                 device="cpu")


def _decode(blob):
    x, y, z = (FP.from_wire_int(int.from_bytes(blob[i * 32:(i + 1) * 32],
                                               "little")) for i in range(3))
    return None if z == 0 else (x * pow(z, -1, FP.modulus) % FP.modulus,
                                y * pow(z, -1, FP.modulus) % FP.modulus)


def test_cached_bases_blob_matches_jax_and_oracle(case, gm):
    blob = api.msm_bn254_with_cached_bases(gm, case["sblob"], 0)
    want = japi.msm_bn254_with_cached_bases(case["jgm"], case["sblob"], 0)
    assert blob == want
    assert _decode(blob) == case["exp"]


def test_projective_output_and_identity_blob(case, gm):
    case["jgm"].set_config(jmanager.ResultCoordinateType.PROJECTIVE)
    gm.set_config(ResultCoordinateType.PROJECTIVE)
    try:
        blob = api.msm_bn254_with_cached_bases(gm, case["sblob"], 0)
        assert blob == japi.msm_bn254_with_cached_bases(case["jgm"],
                                                        case["sblob"], 0)
        assert _decode(blob) == case["exp"]
        zeros = bytes(32 * N)
        ident = api.msm_bn254_with_cached_bases(gm, zeros, 0)
        assert ident == japi.msm_bn254_with_cached_bases(case["jgm"], zeros, 0)
        assert ident == _blob((0, 1, 0), FP)
    finally:
        gm.set_config(ResultCoordinateType.JACOBIAN)
        case["jgm"].set_config(jmanager.ResultCoordinateType.JACOBIAN)


def test_cached_variants_agree(case, gm):
    blob = api.msm_bn254(gm, case["sblob"], case["bases"])
    sidx = gm.init_msm_cached_scalars(case["sblob"])
    assert api.msm_bn254_with_cached_scalars(gm, case["bases"], sidx) == blob
    assert api.msm_bn254_with_cached_input(gm, sidx, 0) == blob
    assert _decode(blob) == case["exp"]


def test_session_state_carries_across(case, gm):
    """The JAX session's cached bases and scalars, converted with
    from_jax_limbs, are the port's, and run to the same blob."""
    jgm = case["jgm"]
    jx, jy = (np.asarray(a) for a in jgm.d_bases[0])
    px, py = (mont.from_jax_limbs(FP, a) for a in (jx, jy))
    assert torch.equal(px, gm.d_bases[0][0])
    assert torch.equal(py, gm.d_bases[0][1])
    np.testing.assert_array_equal(mont.to_jax_limbs(FP, px),
                                  mont.to_jax_limbs(FP, gm.d_bases[0][0]))
    jsidx = jgm.init_msm_cached_scalars(case["sblob"])
    ps = mont.from_jax_limbs(FR, np.asarray(jgm.d_scalars[jsidx]))
    assert torch.equal(ps, gm.ingest_scalars(case["sblob"]))
    other = PandaManager.new(0, device="cpu")
    other.d_bases.append((px, py))
    other.d_scalars.append(ps)
    assert api.msm_bn254_with_cached_input(other, 0, 0) == \
        api.msm_bn254_with_cached_bases(gm, case["sblob"], 0)


def test_error_codes(case, gm):
    with pytest.raises(PandaRuntimeError) as e:
        api.msm_with_cached_bases(gm, case["sblob"], 3)
    assert e.value.code == PandaError.INVALID_VALUE
    with pytest.raises(PandaRuntimeError) as e:
        api.msm_with_cached_input(gm, 5, 0)
    assert e.value.code == PandaError.INVALID_VALUE
    with pytest.raises(PandaRuntimeError) as e:
        api.msm(gm, case["sblob"][:2 * 32], case["bases"])
    assert e.value.code == PandaError.INVALID_CONFIGURATION
    with pytest.raises(PandaRuntimeError) as e:
        api.msm(gm, case["sblob"][:-1], case["bases"])
    assert e.value.code == PandaError.INVALID_CONFIGURATION
    with pytest.raises(PandaRuntimeError) as e:
        api.msm(gm, case["sblob"], case["bases"][:-3])
    assert e.value.code == PandaError.INVALID_CONFIGURATION
    with pytest.raises(PandaRuntimeError) as e:
        api.msm(gm, b"", b"")
    assert e.value.code == PandaError.INVALID_CONFIGURATION
    for kwargs in ({"device_id": 99}, {"device": "cuda:99"},
                   {"device": "meta"}):
        with pytest.raises(PandaRuntimeError) as e:
            PandaManager.new(**kwargs)
        assert e.value.code == PandaError.INVALID_DEVICE
    with pytest.raises(PandaRuntimeError) as e:
        api.msm_bn254(PandaManager.new(0, "bls12_377", device="cpu"),
                      case["sblob"], case["bases"])
    assert e.value.code == PandaError.UNSUPPORTED_CURVE
    # the same codes as the JAX package's, by name
    with pytest.raises(JPandaRuntimeError) as je:
        japi.msm(case["jgm"], case["sblob"][:-1], case["bases"])
    assert je.value.code.name == "INVALID_CONFIGURATION"
    assert [(c.name, int(c)) for c in PandaError] == \
        [(c.name, int(c)) for c in JPandaError]


def test_chunked_path_and_array_msm_match_jax_and_oracle(case, gm,
                                                        monkeypatch):
    """The byte API with CHUNK_N = 16 (4 chunks) and 24 (the last chunk
    padded with digit-0 points) gives the JAX package's blob for the same
    case and the oracle's, and its window sums are point-equal to the
    unchunked path's; msm.msm (window sums, then Horner with the point ops)
    gives one point whose blob is the same."""
    from panda_tpu_torch.curves import point as cp
    from panda_tpu_torch.ops import msm
    want = japi.msm_bn254_with_cached_bases(case["jgm"], case["sblob"], 0)
    c = msm.window_bits(6, bits=FR.bits)
    px, py = gm.d_bases[0]
    scalars = gm.ingest_scalars(case["sblob"])
    mags, negs = msm.signed_digit_arrays(FR, scalars, c)
    whole = msm.window_sums(BN254, px, py, mags, negs, c)
    for chunk_n in (16, 24):
        got = msm.window_sums(BN254, px, py, mags, negs, c, chunk_n=chunk_n)
        assert bool(cp.eq(BN254, got, whole).all()), chunk_n
        monkeypatch.setattr(msm, "CHUNK_N", chunk_n)
        blob = api.msm_bn254_with_cached_bases(gm, case["sblob"], 0)
        assert blob == want and _decode(blob) == case["exp"], chunk_n
    monkeypatch.undo()
    q = msm.msm(BN254, px, py, scalars)
    assert q.x.shape == (8,)
    rinv = pow(mont.radix(FP), -1, FP.modulus)
    aff = None if bool(cp.is_identity(BN254, q)) else tuple(
        mont.words_to_ints(a)[0] * rinv % FP.modulus
        for a in cp.to_affine(BN254, q))
    assert aff == case["exp"] and gm.format_affine_result(aff) == want

