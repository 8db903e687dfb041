"""The native library's engine target with the port's worker, on the CPU.

The port's twin of ``test_native_engine.py``: the port's own
``libpanda_host.so`` (``interop/native.py``) starts, for a session with
execution target 1, ``$PANDA_WORKER_PYTHON -m
panda_tpu_torch.interop.worker``, here on the CPU
(``PANDA_WORKER_DEVICE=cpu``) under this interpreter.  A native caller
gets bytes identical to the port's byte API, and to the JAX package's; the
worker's errors and its death map to the JAX worker's codes.  The JAX byte
API's MSM compiles for minutes on this CPU, so the tier-1 test holds the
MSM blob to the JAX session's encoding of the oracle's point, and the one
comparison with the JAX byte-API MSM is marked ``slow``.
"""

import io
import json
import random
import struct
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

from panda_tpu.curves.config import BN254 as JBN254
from panda_tpu.reference import curve_ref as jref
from panda_tpu.runtime import api as japi
from panda_tpu.runtime import manager as jmanager
from panda_tpu_torch.curves.config import BN254
from panda_tpu_torch.interop import native
from panda_tpu_torch.ops import _ext
from panda_tpu_torch.reference import curve_ref
from panda_tpu_torch.runtime import api
from panda_tpu_torch.runtime.errors import PandaError, PandaRuntimeError
from panda_tpu_torch.runtime.manager import PandaManager
from tests.jax_release import release_jax_programs  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FP, FR = BN254.fp, BN254.fr
N = 16


def _blob(spec, vals) -> bytes:
    return b"".join(spec.to_wire_int(v).to_bytes(spec.n_bytes, "little")
                    for v in vals)


@pytest.fixture
def port_worker(monkeypatch):
    """The port's library starts its worker under this interpreter, on
    the CPU."""
    monkeypatch.setenv("PANDA_WORKER_PYTHON", sys.executable)
    monkeypatch.setenv("PANDA_WORKER_DEVICE", "cpu")


@pytest.fixture(scope="module")
def case():
    rng = random.Random(2026)
    pts = [curve_ref.random_point(BN254, rng) for _ in range(N)]
    scalars = [rng.randrange(FR.modulus) for _ in range(N)]
    vals = [rng.randrange(FR.modulus) for _ in range(N)]
    return {"pts": pts, "scalars": scalars,
            "bases": b"".join(_blob(FP, pt) for pt in pts),
            "sblob": _blob(FR, scalars), "data": _blob(FR, vals),
            "gm": PandaManager.new(0, BN254, device="cpu")}


def test_engine_msm_and_ntt_byte_identical(port_worker, case):
    """MSM, NTT, INTT and the NTT with a root (w^3, and a zero root, which
    takes the stagewise engine) through the engine target: the port's
    byte API's bytes, the JAX package's blob of the oracle's point and the
    JAX byte API's NTT bytes."""
    gm, data = case["gm"], case["data"]
    w3 = _blob(FR, [pow(FR.root_of_unity(4), 3, FR.modulus)])
    with native.NativeSession(BN254) as s:
        s.set_execution_target(1)
        s.engine_warmup()
        got = s.msm(case["sblob"], case["bases"])
        assert got == api.msm(gm, case["sblob"], case["bases"])
        jgm = jmanager.PandaManager.new(0, "bn254")
        assert got == jgm.format_affine_result(jref.msm_oracle(
            JBN254, case["pts"], case["scalars"]))
        y = s.ntt(data, 4)
        assert y == api.ntt(gm, data, 4) == japi.ntt(jgm, data, 4)
        assert s.ntt(y, 4, inverse=True) == data
        for omega in (w3, bytes(32)):
            assert s.ntt(data, 4, omega=omega) == api.ntt_v1(gm, data, 4,
                                                             omega)


def test_engine_error_codes(port_worker, case):
    """The worker's PandaError codes reach the native caller: truncated
    scalars and a blob of the wrong size for log_n are
    INVALID_CONFIGURATION (5), as with the JAX worker."""
    with native.NativeSession(BN254) as s:
        s.set_execution_target(1)
        s.engine_warmup()
        with pytest.raises(PandaRuntimeError) as e:
            s.msm(case["sblob"][:7], case["bases"])
        assert e.value.code == PandaError.INVALID_CONFIGURATION == 5
        with pytest.raises(PandaRuntimeError) as e:
            s.ntt(case["data"], 5)
        assert e.value.code == PandaError.INVALID_CONFIGURATION
        assert s.ntt(case["data"], 4) == api.ntt(case["gm"], case["data"], 4)


def test_worker_death_maps_to_not_ready(port_worker, monkeypatch, case):
    """A worker that cannot start surfaces as NOT_READY (3); with the
    interpreter back, the session starts a new worker and answers."""
    with native.NativeSession(BN254) as s:
        s.set_execution_target(1)
        monkeypatch.setenv("PANDA_WORKER_PYTHON", "/nonexistent/python")
        with pytest.raises(PandaRuntimeError) as e:
            s.engine_warmup()
        assert e.value.code == PandaError.NOT_READY == 3
        monkeypatch.setenv("PANDA_WORKER_PYTHON", sys.executable)
        s.engine_warmup()
        assert s.ntt(case["data"], 4) == api.ntt(case["gm"], case["data"], 4)


def _request(cmd: int, body: bytes = b"") -> bytes:
    return struct.pack("<II", cmd, 5) + b"bn254" + body


def test_worker_speaks_the_protocol_without_jax(case, tmp_path):
    """The worker module serving a PING, an NTT and an unknown command in a
    fresh process: the replies are the protocol's, the process loads no jax
    and no panda_tpu module, and it writes its kernel launches (none: the
    plain versions on the CPU) to the file it is given."""
    data = case["data"]
    launches = tmp_path / "launches.json"
    reqs = (_request(0) + _request(2, struct.pack("<III", 4, 0, 0)
                                   + struct.pack("<Q", len(data)) + data)
            + _request(7))
    code = ("import io, sys\n"
            "from panda_tpu_torch.interop import worker\n"
            "out = io.BytesIO()\n"
            "worker.serve(io.BytesIO(sys.stdin.buffer.read()), out, 'cpu',\n"
            f"             {str(launches)!r})\n"
            "sys.stdout.buffer.write(out.getvalue())\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'panda_tpu')), file=sys.stderr)\n")
    res = subprocess.run([sys.executable, "-c", code], input=reqs, cwd=ROOT,
                         capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr.decode()
    assert res.stderr.decode().strip().splitlines()[-1] == "[]"
    out = io.BytesIO(res.stdout)

    def reply():
        rc, n = struct.unpack("<iQ", out.read(12))
        return rc, out.read(n)

    assert reply() == (0, b"")
    assert reply() == (0, api.ntt(case["gm"], data, 4))
    assert reply() == (int(PandaError.INVALID_VALUE), b"")
    assert out.read() == b""
    counts = json.loads(launches.read_text())
    assert set(counts) == set(_ext.KERNELS) and not any(counts.values())


@pytest.mark.slow   # the JAX byte-API MSM compiles for ~3 min on this CPU
def test_engine_msm_matches_jax_api(port_worker, case):
    with native.NativeSession(BN254) as s:
        s.set_execution_target(1)
        got = s.msm(case["sblob"], case["bases"])
    jgm = jmanager.PandaManager.new(0, "bn254")
    assert got == japi.msm(jgm, case["sblob"], case["bases"])
