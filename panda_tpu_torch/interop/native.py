"""ctypes binding to the native C++ host MSM (``libpanda_host``).

The port's own loader for the JAX package's native library: it compiles
``panda_tpu/native/panda_host.cpp`` (read, never edited or built in place)
with the system ``g++`` into ``build/panda_tpu_torch/`` at the repository
root, at first use, keyed on a hash of the source and flags.  Only the host
MSM is bound here.  There is no fallback: when the library cannot be built
or loaded, :func:`load` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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
