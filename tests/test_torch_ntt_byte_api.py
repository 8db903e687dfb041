"""The NTT byte API on the CPU: the port's blobs byte-equal to the JAX
package's, the same error codes, and the session's root and init units.
"""

import random

import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.runtime import api as japi
from panda_tpu.runtime import manager as jmanager
from panda_tpu.runtime.errors import PandaRuntimeError as JPandaRuntimeError
from panda_tpu_torch import InitUnitType, PandaManager
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.reference import ntt_ref
from panda_tpu_torch.runtime import api
from panda_tpu_torch.runtime.errors import PandaError, PandaRuntimeError
from tests.jax_release import release_jax_programs  # noqa: F401

FR = BN254.fr
R = FR.modulus


def _wire(vals) -> bytes:
    return b"".join(FR.to_wire_int(v).to_bytes(32, "little") for v in vals)


def _raw_words(n, seed):
    """n random 256-bit input words, the first three >= r, as bytes and as
    the plain values they stand for."""
    rng = random.Random(seed)
    words = [rng.randrange(1 << 256) for _ in range(n)]
    words[:3] = [R, 2 * R + 7, (1 << 256) - 1][:n]
    data = b"".join(v.to_bytes(32, "little") for v in words)
    return data, [FR.from_wire_int(v) for v in words]


@pytest.fixture(scope="module")
def api_case():
    log_n = 6
    data, vals = _raw_words(1 << log_n, 66)
    w3 = pow(FR.root_of_unity(log_n), 3, R)
    return {"log_n": log_n, "data": data, "vals": vals,
            "omega": FR.to_wire_int(w3).to_bytes(32, "little"),
            "jgm": jmanager.PandaManager.init_all(0,
                                                  jmanager.InitUnitType.NTT),
            "gm": PandaManager.init_all(0, InitUnitType.NTT, device="cpu")}


def test_byte_api_matches_jax(api_case):
    c = api_case
    gm, jgm, data, log_n = c["gm"], c["jgm"], c["data"], c["log_n"]
    out = api.ntt_bn254(gm, data, log_n)
    assert out == japi.ntt_bn254(jgm, data, log_n)
    assert out == _wire(ntt_ref.ntt_oracle(FR, c["vals"],
                                           FR.root_of_unity(log_n)))
    v1 = api.ntt_bn254_v1(gm, data, log_n, c["omega"])
    assert v1 == japi.ntt_bn254_v1(jgm, data, log_n, c["omega"])
    inv = api.intt(gm, data, log_n)
    assert inv == japi.intt(jgm, data, log_n)
    assert api.intt(gm, out, log_n) == _wire(c["vals"])


def test_byte_api_error_codes_match_jax(api_case):
    c = api_case
    data, log_n = c["data"], c["log_n"]
    bls = PandaManager.new(0, "bls12_377", device="cpu")
    jbls = jmanager.PandaManager.new(0, "bls12_377")
    for call, jcall in (
            (lambda: api.ntt(c["gm"], data[:-1], log_n),
             lambda: japi.ntt(c["jgm"], data[:-1], log_n)),
            (lambda: api.ntt(c["gm"], data, log_n - 1),
             lambda: japi.ntt(c["jgm"], data, log_n - 1)),
            (lambda: api.intt(c["gm"], data[:32 * 3], 2),
             lambda: japi.intt(c["jgm"], data[:32 * 3], 2)),
            (lambda: api.ntt_bn254(bls, data, log_n),
             lambda: japi.ntt_bn254(jbls, data, log_n)),
            (lambda: api.ntt_bn254_v1(bls, data, log_n, c["omega"]),
             lambda: japi.ntt_bn254_v1(jbls, data, log_n, c["omega"]))):
        with pytest.raises(PandaRuntimeError) as e:
            call()
        with pytest.raises(JPandaRuntimeError) as je:
            jcall()
        assert e.value.code.name == je.value.code.name
        assert e.value.code in (PandaError.INVALID_CONFIGURATION,
                                PandaError.UNSUPPORTED_CURVE)


def test_session_root_and_init_units():
    """init_ntt's root becomes the session default (as ntt_v1 with it);
    InitUnitType.ALL sets up both halves."""
    log_n = 5
    data, _ = _raw_words(1 << log_n, 5)
    omega = FR.to_wire_int(pow(FR.root_of_unity(log_n), 7, R)).to_bytes(
        32, "little")
    gm = PandaManager.init_all(0, InitUnitType.ALL, [], omega, device="cpu")
    plain = PandaManager.init_all(0, InitUnitType.NTT, device="cpu")
    assert api.ntt(gm, data, log_n) == api.ntt_v1(plain, data, log_n, omega)
    assert api.ntt(gm, data, log_n) != api.ntt(plain, data, log_n)
    gm.deinit()
    assert not gm._ntt_tables
