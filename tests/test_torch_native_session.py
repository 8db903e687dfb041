"""The port's own native library and its whole session API, on the CPU.

``panda_tpu_torch/interop/native.py`` builds ``panda_tpu_torch/native/
panda_host.cpp`` and binds its 13 C entry points.  Its host target returns
the JAX binding's bytes (``panda_tpu.interop.native``, the same C ABI over
the JAX package's library) and the big-integer oracle's point, with cached
indices, fresh bytes and both coordinate types; ``ntt_host`` and the
session NTT equal ``ntt_ref`` and the JAX ``ntt_host``.  Its engine target
starts the port's worker with no launcher and no ``PYTHONPATH``, from any
working directory.  No XLA program is compiled: the JAX side enters only
through its ctypes binding.  The package exports the JAX package's names,
each bound to the port's own object.
"""

import ast
import hashlib
import importlib
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

import panda_tpu
from panda_tpu.curves.config import CURVES as JCURVES
from panda_tpu.interop import native as jnative
import panda_tpu_torch
from panda_tpu_torch.curves.config import BN254, CURVES
from panda_tpu_torch.interop import native
from panda_tpu_torch.ops import _ext
from panda_tpu_torch.reference import ntt_ref
from panda_tpu_torch.runtime import api
from panda_tpu_torch.runtime.errors import PandaError, PandaRuntimeError
from panda_tpu_torch.runtime.manager import PandaManager
from panda_tpu_torch.tools import native_engine_check as check
from tests.jax_release import release_jax_programs  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _values(spec, blob: bytes) -> list:
    nb = spec.n_bytes
    return [spec.from_wire_int(int.from_bytes(blob[i:i + nb], "little"))
            for i in range(0, len(blob), nb)]


@pytest.mark.parametrize("name", list(CURVES))
def test_host_session_matches_jax_and_oracle(name):
    """Cached indices, fresh bytes and their mixes give one blob, in each
    coordinate type the oracle's point and the JAX session's bytes; the
    device count is 1; ntt_host, the session NTT (the field's root and
    w^3) and the JAX ntt_host give the same bytes, the oracle's values,
    and the inverse returns the input."""
    curve, jcurve, fr = CURVES[name], JCURVES[name], CURVES[name].fr
    case = check.msm_case(curve, 5)
    bases, sblob = case["bases"], case["scalars"]
    with native.NativeSession(curve) as s, \
            jnative.NativeSession(jcurve) as js:
        assert s.device_count() == js.device_count() == 1
        bi, si = s.cache_bases(bases), s.cache_scalars(sblob)
        jbi, jsi = js.cache_bases(bases), js.cache_scalars(sblob)
        for coords in (0, 1):
            s.set_config(coords)
            js.set_config(coords)
            blob = s.msm(si, bi)
            assert blob == js.msm(jsi, jbi) == s.msm(sblob, bi) == \
                s.msm(si, bases) == s.msm(sblob, bases)
            assert check.affine(curve, blob, coords) == case["want"]
        nc = check.ntt_case(fr, 5)
        for kw, root in (({}, fr.root_of_unity(5)),
                         ({"omega": nc["omega"]}, nc["w3"])):
            y = native.ntt_host(curve, nc["data"], 5, **kw)
            assert y == s.ntt(nc["data"], 5, **kw) == \
                jnative.ntt_host(jcurve, nc["data"], 5, **kw)
            assert _values(fr, y) == ntt_ref.ntt_oracle(fr, nc["vals"], root)
        y = s.ntt(nc["data"], 5)
        assert native.ntt_host(curve, y, 5, inverse=True) == \
            s.ntt(y, 5, inverse=True) == nc["data"]


def test_session_error_codes():
    """A 63-byte bases blob, a 31-byte scalars blob, a bad cache index, a
    bad coordinate type and a bad execution target are INVALID_VALUE (the
    JAX binding raises a RuntimeError for each); blobs of unequal counts
    and NTTs of the wrong length are INVALID_CONFIGURATION, an unknown
    curve UNSUPPORTED_CURVE."""
    case = check.msm_case(BN254, 2, oracle=False)
    fake = type("C", (), {"name": "nope"})()
    with native.NativeSession(BN254) as s, \
            jnative.NativeSession(JCURVES["bn254"]) as js:
        for sess, err in ((s, PandaRuntimeError), (js, RuntimeError)):
            for call in (lambda: sess.cache_bases(b"\0" * 63),
                         lambda: sess.cache_scalars(b"\0" * 31),
                         lambda: sess.msm(5, 0),
                         lambda: sess.set_config(3),
                         lambda: sess.set_execution_target(2)):
                with pytest.raises(err) as e:
                    call()
                if sess is s:
                    assert e.value.code == PandaError.INVALID_VALUE
        bi = s.cache_bases(case["bases"])
        for call, code in (
                (lambda: s.msm(case["scalars"][:32], bi),
                 PandaError.INVALID_CONFIGURATION),
                (lambda: s.ntt(bytes(64), 3),
                 PandaError.INVALID_CONFIGURATION),
                (lambda: s.ntt(bytes(32), 40),
                 PandaError.INVALID_CONFIGURATION),
                (lambda: native.ntt_host(fake, bytes(32), 0),
                 PandaError.UNSUPPORTED_CURVE),
                (lambda: native.NativeSession(fake),
                 PandaError.UNSUPPORTED_CURVE)):
            with pytest.raises(PandaRuntimeError) as e:
                call()
            assert e.value.code == code


def test_engine_target_by_cache_indices(monkeypatch, tmp_path):
    """The native caller's check at a small size, run as a native prover
    would run it: the port's own library with the worker on the CPU, no
    PYTHONPATH and another working directory.  Every comparison holds, it
    loads no torch, jax or panda_tpu module, and on each curve the engine
    target's MSM by cache indices and by cached bases with fresh scalars,
    its NTT, INTT and ntt_v1 return the port's runtime.api bytes."""
    monkeypatch.setenv("PANDA_WORKER_PYTHON", sys.executable)
    monkeypatch.setenv("PANDA_WORKER_DEVICE", "cpu")
    monkeypatch.delenv("PYTHONPATH", raising=False)
    monkeypatch.delenv("PANDA_WORKER_LAUNCHES", raising=False)
    code = (f"import sys\nsys.path.insert(0, {str(ROOT)!r})\n"
            "from panda_tpu_torch.tools import native_engine_check as c\n"
            "sys.exit(c.main(sys.argv[1:]))\n")
    res = subprocess.run([sys.executable, "-c", code, "--log-n", "4"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["ok"] and out["foreign_modules"] == []
    assert all(c["ok"] for c in out["checks"]) and len(out["checks"]) == 24
    for name in check.NAMES:
        curve = CURVES[name]
        case, nc = check.msm_case(curve, 4, oracle=False), \
            check.ntt_case(curve.fr, 4)
        gm = PandaManager.new(0, curve, device="cpu")
        msm = api.msm(gm, case["scalars"], case["bases"])
        y = api.ntt(gm, nc["data"], 4)
        want = {"msm_cached": msm, "msm_fresh": msm, "ntt": y,
                "intt": api.intt(gm, y, 4),
                "ntt_v1": api.ntt_v1(gm, nc["data"], 4, nc["omega"])}
        row = out["engine"][name]
        assert row["sha256"] == {k: hashlib.sha256(v).hexdigest()
                                 for k, v in want.items()}
        assert row["launches"] == dict.fromkeys(want,
                                                dict.fromkeys(_ext.KERNELS, 0))


def _symbols(lib: Path) -> set:
    out = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    return {line.split()[-1] for line in out.splitlines()
            if line.split() and line.split()[-1].startswith("panda_")}


AUDIT = """
import sys
seen = []
sys.addaudithook(lambda ev, args: seen.append((ev, args)) if ev in (
    "open", "ctypes.dlopen", "subprocess.Popen", "os.exec") else None)
sys.path.insert(0, ".")
import chip_smoke
import panda_tpu_torch
from panda_tpu_torch.curves.config import CURVES
from panda_tpu_torch.interop import native, worker
from panda_tpu_torch.tools import native_engine_check as check
names = [getattr(panda_tpu_torch, n) for n in panda_tpu_torch.__all__]
for curve in CURVES.values():
    case = check.msm_case(curve, 3)
    with native.NativeSession(curve) as s:
        assert check.affine(curve, s.msm(case["scalars"], case["bases"]),
                            0) == case["want"]
        nc = check.ntt_case(curve.fr, 3)
        assert native.ntt_host(curve, nc["data"], 3) == s.ntt(nc["data"], 3)
print(repr([(ev, [str(a) for a in args]) for ev, args in seen]))
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "panda_tpu")))
"""


def test_the_port_owns_its_native_library():
    """The port's library exports the JAX library's C symbols and binds the
    13 that the JAX binding binds; its source lies under panda_tpu_torch/,
    starts the port's worker module, and the build leaves it under its
    linkable name; the launcher is gone.  A process that imports
    chip_smoke.py and the port, resolves its exports and runs a host
    session on each curve opens, loads and runs nothing under panda_tpu/
    and loads no jax or panda_tpu module."""
    built = native.build()
    assert jnative.available()
    assert _symbols(built) == _symbols(jnative._LIB_PATH)
    bound = set(re.findall(r"lib\.(panda_\w+)\.restype",
                           Path(jnative.__file__).read_text()))
    assert set(native.SIGNATURES) == bound and len(bound) == 13
    assert bound <= _symbols(built)
    assert native.SOURCE.is_relative_to(ROOT / "panda_tpu_torch")
    src = native.SOURCE.read_text()
    assert '"panda_tpu_torch.interop.worker"' in src
    assert '"panda_tpu.interop.worker"' not in src
    assert native.linkable_path().read_bytes() == built.read_bytes()
    assert not (ROOT / "panda_tpu_torch" / "interop" /
                "worker_python").exists()
    res = subprocess.run([sys.executable, "-c", AUDIT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    events, foreign = res.stdout.strip().splitlines()[-2:]
    touched = [(ev, a) for ev, args in ast.literal_eval(events) for a in args
               if re.search(r"(^|/)panda_tpu/", a)]
    assert touched == []
    assert foreign == "[]"


def test_exports_match_the_jax_package():
    """panda_tpu_torch.__all__ is the JAX package's export list, each name
    bound to the port's object at the JAX module's counterpart, defined in
    panda_tpu_torch; importing the package and resolving every name builds
    and loads no library and loads no jax or panda_tpu module."""
    assert panda_tpu_torch.__all__ == list(panda_tpu._EXPORTS)

    def home(obj) -> str:
        if isinstance(obj, (dict, tuple)):
            obj = next(iter(obj.values() if isinstance(obj, dict) else obj))
        if isinstance(obj, types.ModuleType):
            return obj.__name__
        if isinstance(obj, (type, types.FunctionType)):
            return obj.__module__
        return type(obj).__module__

    for name, rel in panda_tpu._EXPORTS.items():
        obj = getattr(panda_tpu_torch, name)
        mod = importlib.import_module(f"panda_tpu_torch{rel}")
        assert obj is getattr(mod, name), name
        assert home(obj).split(".")[0] == "panda_tpu_torch", name
        assert obj is not getattr(panda_tpu, name), name
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, panda_tpu_torch as p\n"
         "for n in p.__all__:\n    getattr(p, n)\n"
         "from panda_tpu_torch.ops import _ext\n"
         "nat = sys.modules.get('panda_tpu_torch.interop.native')\n"
         "print(not _ext._libs, nat is None or nat._lib is None, sorted(\n"
         "    m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'panda_tpu')))\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["True", "True", "[]"]
