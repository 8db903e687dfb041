"""ctypes binding to the native C++ library (``libpanda_host``).

The port's own loader for the JAX package's native library: it compiles
``panda_tpu/native/panda_host.cpp`` (read, never edited or built in place)
with the system ``g++`` into ``build/panda_tpu_torch/`` at the repository
root, at first use, keyed on a hash of the source and flags.  Bound here:
the host MSM, and the session API's MSM and NTT with their execution target
(:class:`NativeSession`; target 1 runs them in the engine worker, which
``PANDA_WORKER_PYTHON`` names: ``interop/worker_python`` for the port's).
There is no fallback: when the library cannot be built or loaded,
:func:`load` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..runtime.errors import PandaError, PandaRuntimeError

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "panda_tpu" / "native" / "panda_host.cpp"
BUILD = _ROOT / "build" / "panda_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD / f"libpanda_host-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library (once per source and flags); returns its path.
    Raises RuntimeError when there is no ``g++`` or the build fails."""
    out = _lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library cannot "
                           "be built")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The loaded library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.panda_msm_execute_host.restype = ctypes.c_int
        lib.panda_msm_execute_host.argtypes = [
            ctypes.c_char_p,                   # curve name
            ctypes.c_char_p, ctypes.c_size_t,  # scalars bytes
            ctypes.c_char_p, ctypes.c_size_t,  # bases bytes
            ctypes.c_char_p,                   # out (3 * field bytes)
            ctypes.c_int,                      # coordinate type
        ]
        S, B, N = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t
        for name, restype, argtypes in (
                ("panda_session_create", S, [B]),
                ("panda_session_destroy", None, [S]),
                ("panda_session_set_execution_target", ctypes.c_int,
                 [S, ctypes.c_int]),
                ("panda_session_engine_warmup", ctypes.c_int, [S]),
                ("panda_session_msm", ctypes.c_int, [S, B, N, B, N, B]),
                ("panda_session_ntt", ctypes.c_int,
                 [S, B, N, ctypes.c_uint, B, ctypes.c_int])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def available() -> bool:
    """True when the library builds and loads."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def msm_host(curve, scalars: bytes, bases: bytes,
             coord_type: int = 0) -> bytes:
    """The native host MSM's 3-coordinate blob: Jacobian (X Z, Y Z^2, Z) of
    its homogeneous result for ``coord_type`` 0, the homogeneous (X, Y, Z)
    for 1.  Its error codes are the PandaError values; a non-zero one
    raises."""
    out = ctypes.create_string_buffer(3 * curve.fp.n_bytes)
    rc = load().panda_msm_execute_host(
        curve.name.encode(), scalars, len(scalars), bases, len(bases), out,
        coord_type)
    if rc != 0:
        raise RuntimeError(f"panda_msm_execute_host failed: {rc}")
    return out.raw


def _check(rc: int, what: str) -> None:
    if rc:
        raise PandaRuntimeError(PandaError(rc), what)


class NativeSession:
    """A session of the native library's C API for ``curve``: the host
    pipeline (execution target 0, the default) or the engine worker
    (target 1: one worker process a session, byte-equal to the port's
    ``runtime.api`` when it is the port's worker).  A non-zero code raises
    PandaRuntimeError with that code (the worker's own code, or NOT_READY
    when the worker died: the next call starts a new one)."""

    def __init__(self, curve):
        self._lib = load()
        self._curve = curve
        self._h = self._lib.panda_session_create(curve.name.encode())
        if not self._h:
            raise PandaRuntimeError(PandaError.UNSUPPORTED_CURVE, curve.name)

    def close(self) -> None:
        """Destroy the session (and stop its worker)."""
        if self._h:
            self._lib.panda_session_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def set_execution_target(self, target: int) -> None:
        """0 = the in-process host pipeline, 1 = the engine worker."""
        _check(self._lib.panda_session_set_execution_target(self._h, target),
               "set_execution_target")

    def engine_warmup(self) -> None:
        """Start and ping the engine worker now."""
        _check(self._lib.panda_session_engine_warmup(self._h),
               "engine warmup")

    def msm(self, scalars: bytes, bases: bytes) -> bytes:
        out = ctypes.create_string_buffer(3 * self._curve.fp.n_bytes)
        _check(self._lib.panda_session_msm(self._h, scalars, len(scalars),
                                           bases, len(bases), out),
               "session msm")
        return out.raw

    def ntt(self, data: bytes, log_n: int, omega: bytes | None = None,
            inverse: bool = False) -> bytes:
        """Forward (with ``omega``: the given root) or inverse NTT."""
        buf = ctypes.create_string_buffer(data, len(data))
        _check(self._lib.panda_session_ntt(self._h, buf, len(data), log_n,
                                           omega, int(inverse)),
               "session ntt")
        return buf.raw
