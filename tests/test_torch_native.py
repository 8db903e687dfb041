"""The host MSM path: the port's ``api.msm_host`` (its own build of the
native C++ library) against the JAX package's ``msm_host`` on the same
blobs, byte for byte, for the three curves and both coordinate types, and
against the big-integer oracle.  Both packages run the native library, so
no XLA program is compiled.
"""

import random

import pytest

from panda_tpu.runtime import api as japi
from panda_tpu.runtime import manager as jmanager
from panda_tpu_torch import PandaManager, PandaRuntimeError
from panda_tpu_torch.curves.config import CURVES
from panda_tpu_torch.interop import native
from panda_tpu_torch.reference import curve_ref
from panda_tpu_torch.runtime import api
from panda_tpu_torch.runtime.errors import PandaError
from panda_tpu_torch.runtime.manager import ResultCoordinateType

N = 16


def _blobs(curve, seed):
    fp, fr = curve.fp, curve.fr
    rng = random.Random(seed)
    pts = [curve_ref.random_point(curve, rng) for _ in range(N)]
    scalars = [rng.randrange(fr.modulus) for _ in range(N)]
    bases = b"".join(fp.to_wire_int(v).to_bytes(fp.n_bytes, "little")
                     for pt in pts for v in pt)
    sblob = b"".join(fr.to_wire_int(s).to_bytes(fr.n_bytes, "little")
                     for s in scalars)
    return bases, sblob, curve_ref.msm_oracle(curve, pts, scalars)


@pytest.mark.parametrize("coords", list(ResultCoordinateType),
                         ids=lambda t: t.name.lower())
@pytest.mark.parametrize("name", list(CURVES))
def test_msm_host_matches_jax_and_oracle(name, coords):
    curve = CURVES[name]
    fp = curve.fp
    bases, sblob, exp = _blobs(curve, len(name) + int(coords))
    gm = PandaManager.new(0, curve, device="cpu")
    gm.set_config(coords)
    jgm = jmanager.PandaManager.new(0, name)
    jgm.set_config(jmanager.ResultCoordinateType(int(coords)))
    blob = api.msm_host(gm, sblob, bases)
    assert blob == japi.msm_host(jgm, sblob, bases)
    nb, p = fp.n_bytes, fp.modulus
    x, y, z = (fp.from_wire_int(int.from_bytes(blob[i * nb:(i + 1) * nb],
                                               "little")) for i in range(3))
    zi = pow(z, -1, p)
    ex, ey = (zi * zi, zi * zi * zi) if coords == 0 else (zi, zi)
    assert (x * ex % p, y * ey % p) == exp
    if name == "bn254":
        assert api.msm_bn254_host(gm, sblob, bases) == blob


def test_msm_host_raises_without_the_library(tmp_path, monkeypatch):
    """No g++, no library: msm_host raises, it never falls back to
    another host path; malformed blobs raise the port's error codes."""
    bases, sblob, _ = _blobs(CURVES["bn254"], 0)
    gm = PandaManager.new(0, device="cpu")
    with pytest.raises(PandaRuntimeError) as e:
        api.msm_host(gm, sblob[:-1], bases)
    assert e.value.code == PandaError.INVALID_CONFIGURATION
    with pytest.raises(PandaRuntimeError) as e:
        api.msm_bn254_host(PandaManager.new(0, "bls12_377", device="cpu"),
                           sblob, bases)
    assert e.value.code == PandaError.UNSUPPORTED_CURVE
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="g..? not found"):
        api.msm_host(gm, sblob, bases)
    assert not list(tmp_path.iterdir())
