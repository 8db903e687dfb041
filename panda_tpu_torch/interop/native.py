"""ctypes binding to the port's native C++ library (``libpanda_host``).

The port's own library: ``panda_tpu_torch/native/panda_host.cpp``, compiled
with the system ``g++`` into ``build/panda_tpu_torch/`` at the repository
root at first use, keyed on a hash of the source and flags; its engine
target finds this package from the nearest ancestor of the ``.so`` that
holds it.
The build also leaves the library as ``build/panda_tpu_torch/native/
libpanda_host.so``, the name a native caller links (the Rust crate through
``PANDA_NATIVE_DIR``).  All 13 C entry points are bound: the host MSM and
NTT (:func:`msm_host`, :func:`ntt_host`) and the session API
(:class:`NativeSession`: cached inputs, the result coordinate config, the
device count and the execution target; target 1 runs the session's MSM
and NTT in the engine worker, ``python -m panda_tpu_torch.interop.worker``
under the interpreter ``PANDA_WORKER_PYTHON`` names, default ``python3``).
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
SOURCE = _ROOT / "panda_tpu_torch" / "native" / "panda_host.cpp"
BUILD = _ROOT / "build" / "panda_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_S, _B, _N = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t
_I, _L = ctypes.c_int, ctypes.c_long

# The C ABI: name -> (restype, argtypes), in the JAX binding's order.
SIGNATURES = {
    "panda_msm_execute_host": (_I, [
        _B,                                # curve name
        _B, _N,                            # scalars bytes
        _B, _N,                            # bases bytes
        _B,                                # out (3 * field bytes)
        _I]),                              # coordinate type
    "panda_ntt_execute_host": (_I, [
        _B,                                # curve name
        _B, _N,                            # data in/out (in place)
        ctypes.c_uint,                     # log_n
        _B,                                # omega bytes (may be NULL)
        _I]),                              # inverse flag
    "panda_get_device_number": (_I, [ctypes.POINTER(_I)]),
    "panda_session_create": (_S, [_B]),
    "panda_session_destroy": (None, [_S]),
    "panda_session_set_config": (_I, [_S, _I]),
    "panda_session_cache_bases": (_L, [_S, _B, _N]),
    "panda_session_cache_scalars": (_L, [_S, _B, _N]),
    "panda_session_msm": (_I, [_S, _B, _N, _B, _N, _B]),
    "panda_session_msm_cached": (_I, [_S, _L, _L, _B, _N, _B, _N, _B]),
    "panda_session_ntt": (_I, [_S, _B, _N, ctypes.c_uint, _B, _I]),
    "panda_session_set_execution_target": (_I, [_S, _I]),
    "panda_session_engine_warmup": (_I, [_S]),
}

_lib = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD / f"libpanda_host-{h.hexdigest()[:16]}.so"


def linkable_path() -> Path:
    """Where the build leaves the library under the name a native caller
    links, ``libpanda_host.so`` (the Rust crate's ``PANDA_NATIVE_DIR`` is
    its directory)."""
    return BUILD / "native" / "libpanda_host.so"


def _publish(lib: Path) -> None:
    """Copy ``lib`` to :func:`linkable_path` unless it is there already."""
    dst = linkable_path()
    if dst.exists() and dst.read_bytes() == lib.read_bytes():
        return
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_suffix(f".{os.getpid()}.tmp")
    shutil.copyfile(lib, tmp)
    os.replace(tmp, dst)


def build() -> Path:
    """Compile the library (once per source and flags) and publish it
    under its linkable name; returns the build's path.  Raises
    RuntimeError when there is no ``g++`` or the build fails."""
    out = _lib_path()
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native host library "
                               "cannot be built")
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{res.stderr}")
        os.replace(tmp, out)
    _publish(out)
    return out


def load():
    """The loaded library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in SIGNATURES.items():
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


def _check(rc: int, what: str) -> None:
    if rc:
        raise PandaRuntimeError(PandaError(rc), what)


def _index(idx: int, what: str) -> int:
    """A cache index; the library's -1 raises INVALID_VALUE."""
    if idx < 0:
        raise PandaRuntimeError(PandaError.INVALID_VALUE, what)
    return idx


def msm_host(curve, scalars: bytes, bases: bytes,
             coord_type: int = 0) -> bytes:
    """The native host MSM's 3-coordinate blob: Jacobian (X Z, Y Z^2, Z) of
    its homogeneous result for ``coord_type`` 0, the homogeneous (X, Y, Z)
    for 1.  A non-zero code raises PandaRuntimeError with that code."""
    out = ctypes.create_string_buffer(3 * curve.fp.n_bytes)
    _check(load().panda_msm_execute_host(
        curve.name.encode(), scalars, len(scalars), bases, len(bases), out,
        coord_type), "panda_msm_execute_host")
    return out.raw


def ntt_host(curve, data: bytes, log_n: int, omega: bytes | None = None,
             inverse: bool = False) -> bytes:
    """The native host NTT of ``data`` (wire bytes of 2^log_n elements of
    the curve's scalar field): forward with the field's root or with
    ``omega`` (wire bytes), or inverse.  A non-zero code raises
    PandaRuntimeError with that code."""
    buf = ctypes.create_string_buffer(data, len(data))
    _check(load().panda_ntt_execute_host(
        curve.name.encode(), buf, len(data), log_n, omega, int(inverse)),
        "panda_ntt_execute_host")
    return buf.raw


class NativeSession:
    """A session of the native library's C API for ``curve``, the
    reference's ``PandaGpuManager`` semantics: cached bases and scalars,
    the result coordinate config, and the execution target, either the
    host pipeline (0, the default) or the engine worker (1: one worker
    process a session, byte-equal to the port's ``runtime.api``).  A
    non-zero code raises PandaRuntimeError with that code (the worker's
    own code, or NOT_READY when the worker died: the next call starts a
    new one).

    As in the JAX package's library, the engine target answers in
    Jacobian coordinates whatever :meth:`set_config` says, and sends a
    cached blob to the worker anew with every call."""

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

    def set_config(self, coord_type: int) -> None:
        """The result coordinates: 0 = Jacobian, 1 = projective."""
        _check(self._lib.panda_session_set_config(self._h, coord_type),
               "set_config")

    def set_execution_target(self, target: int) -> None:
        """0 = the in-process host pipeline, 1 = the engine worker."""
        _check(self._lib.panda_session_set_execution_target(self._h, target),
               "set_execution_target")

    def engine_warmup(self) -> None:
        """Start and ping the engine worker now."""
        _check(self._lib.panda_session_engine_warmup(self._h),
               "engine warmup")

    def cache_bases(self, blob: bytes) -> int:
        """Keep a bases blob in the session; returns its cache index."""
        return _index(self._lib.panda_session_cache_bases(
            self._h, blob, len(blob)), "cache_bases")

    def cache_scalars(self, blob: bytes) -> int:
        """Keep a scalars blob in the session; returns its cache index."""
        return _index(self._lib.panda_session_cache_scalars(
            self._h, blob, len(blob)), "cache_scalars")

    def msm(self, scalars: bytes | int, bases: bytes | int) -> bytes:
        """The MSM's 3-coordinate blob; either argument may be a cache
        index (int) or fresh bytes."""
        out = ctypes.create_string_buffer(3 * self._curve.fp.n_bytes)
        sidx, sb = (scalars, b"") if isinstance(scalars, int) else \
            (-1, scalars)
        bidx, bb = (bases, b"") if isinstance(bases, int) else (-1, bases)
        _check(self._lib.panda_session_msm_cached(
            self._h, sidx, bidx, sb, len(sb), bb, len(bb), out),
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

    def device_count(self) -> int:
        """``panda_get_device_number``: the host pipeline is one device."""
        n = ctypes.c_int(0)
        _check(self._lib.panda_get_device_number(ctypes.byref(n)),
               "panda_get_device_number")
        return n.value
