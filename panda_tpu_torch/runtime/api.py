"""Byte-level MSM and NTT API.

Counterpart of ``panda_tpu/runtime/api.py``: the same entry points and
curve-suffixed aliases, the same wire contract (LE Montgomery bytes in; a
3-field result blob, or the transformed elements, out), the same
``PandaError`` codes for malformed input and the same trace labels
(``utils/trace.py``).  An MSM call is the span ``msm: call``, around the
scalar ingest's ``msm: scalar words (host)`` and ``msm: scalar copy in``,
``msm: window sums (device)`` (its ``msm: launches (host)`` and ``msm: copy
back wait``) and ``msm: horner (host)``.

On the card the MSM (any n; chunks of 2^20 points above 2^20) and the NTT
run for BN254, BLS12-377 and BLS12-381 (48-byte base coordinates for the
BLS curves).  ``msm_host`` runs the native C++ host MSM and no kernel.
"""

from __future__ import annotations

import functools

from ..curves.config import BLS12_377, BLS12_381, BN254
from ..curves.point import ProjPoint
from ..fields import mont
from ..interop import native
from ..ops import msm as msm_ops
from ..ops import ntt as ntt_ops
from ..utils import trace
from .errors import PandaError, PandaRuntimeError
from .manager import PandaManager


def _count(blob, stride: int) -> int:
    """Elements in a byte blob; INVALID_CONFIGURATION unless it is a whole
    number of ``stride``-byte elements."""
    size = memoryview(blob).nbytes
    if size % stride:
        raise PandaRuntimeError(PandaError.INVALID_CONFIGURATION,
                                f"byte length {size} not a multiple of "
                                f"{stride}")
    return size // stride


def _check_msm(n_scalars: int, n_bases: int) -> None:
    if n_scalars != n_bases:
        raise PandaRuntimeError(PandaError.INVALID_CONFIGURATION,
                                "scalars/bases length mismatch")
    if n_scalars == 0:
        raise PandaRuntimeError(PandaError.INVALID_CONFIGURATION, "empty MSM")


def _msm_run(gm: PandaManager, scalars, bases_xy, pts=None) -> bytes:
    """Inputs already on the device (``pts``: the bases' point-major table
    if the session holds it); every entry point validates the lengths
    (``_check_msm``) before any device work."""
    curve = gm.curve
    c = msm_ops.window_bits(max(scalars.shape[-1] - 1, 1).bit_length(),
                            bits=curve.fr.bits)
    with trace.timer("msm: window sums (device)"):
        with trace.timer("msm: launches (host)"):
            sums = msm_ops.window_sums_fn(curve, c)(*bases_xy, scalars, pts)
        with trace.timer("msm: copy back wait"):
            sums = ProjPoint(*(a.cpu() for a in sums))   # d2h: W points
    with trace.timer("msm: horner (host)"):
        acc = msm_ops.host_horner(curve, sums, c)
    return gm.format_affine_result(acc)


def _msm_call(fn):
    """An MSM entry point, timed whole as the span ``msm: call``."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with trace.timer("msm: call"):
            return fn(*args, **kwargs)
    return call


def _cached(items: list, index: int, what: str):
    if not 0 <= index < len(items):
        raise PandaRuntimeError(PandaError.INVALID_VALUE, f"{what} index")
    return items[index]


@_msm_call
def msm(gm: PandaManager, scalars_bytes: bytes, bases_bytes: bytes) -> bytes:
    """Scalars and bases as bytes -> result blob."""
    _check_msm(_count(scalars_bytes, gm.curve.fr.n_bytes),
               _count(bases_bytes, 2 * gm.curve.fp.n_bytes))
    return _msm_run(gm, gm.ingest_scalars(scalars_bytes),
                    gm.ingest_bases(bases_bytes))


@_msm_call
def msm_with_cached_bases(gm: PandaManager, scalars_bytes: bytes,
                          bases_index: int = 0) -> bytes:
    bases = _cached(gm.d_bases, bases_index, "bases")
    _check_msm(_count(scalars_bytes, gm.curve.fr.n_bytes), bases[0].shape[-1])
    return _msm_run(gm, gm.ingest_scalars(scalars_bytes), bases,
                    gm.point_major(bases_index))


@_msm_call
def msm_with_cached_scalars(gm: PandaManager, bases_bytes: bytes,
                            scalars_index: int = 0) -> bytes:
    scalars = _cached(gm.d_scalars, scalars_index, "scalars")
    _check_msm(scalars.shape[-1], _count(bases_bytes, 2 * gm.curve.fp.n_bytes))
    return _msm_run(gm, scalars, gm.ingest_bases(bases_bytes))


@_msm_call
def msm_with_cached_input(gm: PandaManager, scalars_index: int = 0,
                          bases_index: int = 0) -> bytes:
    bases = _cached(gm.d_bases, bases_index, "bases")
    scalars = _cached(gm.d_scalars, scalars_index, "scalars")
    _check_msm(scalars.shape[-1], bases[0].shape[-1])
    return _msm_run(gm, scalars, bases, gm.point_major(bases_index))


@_msm_call
def msm_host(gm: PandaManager, scalars_bytes: bytes,
             bases_bytes: bytes) -> bytes:
    """``panda_msm_bn254_gpu_host``: the native C++ host MSM
    (``interop/native.py``) on the session's curve, in its
    ``result_coordinate_type``: Jacobian (X Z, Y Z^2, Z) or homogeneous
    (X, Y, Z) of the library's projective result.  Raises RuntimeError
    when the library cannot be built; there is no other host path."""
    _check_msm(_count(scalars_bytes, gm.curve.fr.n_bytes),
               _count(bases_bytes, 2 * gm.curve.fp.n_bytes))
    return native.msm_host(gm.curve, scalars_bytes, bases_bytes,
                           int(gm.result_coordinate_type))


# ---------------------------------------------------------------------------
# NTT
# ---------------------------------------------------------------------------

def _ntt_run(gm: PandaManager, data: bytes, log_n: int,
             omega_int: int | None, inverse: bool) -> bytes:
    """Validates the length before any device work; input words are any
    values below 2^256, the output is canonical (its words are the wire
    bytes, R = 2^256)."""
    fr = gm.curve.fr
    if log_n < 0 or _count(data, fr.n_bytes) != 1 << log_n:
        raise PandaRuntimeError(PandaError.INVALID_CONFIGURATION,
                                f"expected 2^{log_n} elements")
    tables = gm.ntt_tables(log_n, omega_int)
    with trace.timer("ntt: h2d + domain shift"):
        x = mont.bytes_to_tensor(fr, data, gm.device)
    with trace.timer("ntt: execute"):
        y = ntt_ops.run_ntt(fr, x, tables, inverse)
        trace.wait(y)
    with trace.timer("ntt: d2h result"):
        return mont.tensor_to_bytes(y)


def ntt(gm: PandaManager, data: bytes, log_n: int) -> bytes:
    """``panda_ntt_bn254_gpu``: the transformed bytes are returned."""
    return _ntt_run(gm, data, log_n, None, inverse=False)


def intt(gm: PandaManager, data: bytes, log_n: int) -> bytes:
    """Inverse NTT (scales by n^-1)."""
    return _ntt_run(gm, data, log_n, None, inverse=True)


def ntt_v1(gm: PandaManager, data: bytes, log_n: int,
           omega_bytes: bytes) -> bytes:
    """``panda_ntt_bn254_gpu_v1``: the caller passes omega (Montgomery LE
    bytes)."""
    return _ntt_run(gm, data, log_n, gm.root_from_bytes(omega_bytes),
                    inverse=False)


# ---------------------------------------------------------------------------
# Curve-suffixed aliases mirroring the reference's function names
# ---------------------------------------------------------------------------

def _curve_guard(gm: PandaManager, curve):
    if gm.curve is not curve:
        raise PandaRuntimeError(PandaError.UNSUPPORTED_CURVE,
                                f"manager bound to {gm.curve.name}")


def msm_bn254(gm, scalars, bases):
    _curve_guard(gm, BN254); return msm(gm, scalars, bases)

def msm_bn254_with_cached_bases(gm, scalars, idx=0):
    _curve_guard(gm, BN254); return msm_with_cached_bases(gm, scalars, idx)

def msm_bn254_with_cached_scalars(gm, bases, idx=0):
    _curve_guard(gm, BN254); return msm_with_cached_scalars(gm, bases, idx)

def msm_bn254_with_cached_input(gm, sidx=0, bidx=0):
    _curve_guard(gm, BN254); return msm_with_cached_input(gm, sidx, bidx)

def msm_bn254_host(gm, scalars, bases):
    _curve_guard(gm, BN254); return msm_host(gm, scalars, bases)

def ntt_bn254(gm, data, log_n):
    _curve_guard(gm, BN254); return ntt(gm, data, log_n)

def ntt_bn254_v1(gm, data, log_n, omega_bytes):
    _curve_guard(gm, BN254); return ntt_v1(gm, data, log_n, omega_bytes)

def msm_bls12_377(gm, scalars, bases):
    _curve_guard(gm, BLS12_377); return msm(gm, scalars, bases)

def ntt_bls12_377(gm, data, log_n):
    _curve_guard(gm, BLS12_377); return ntt(gm, data, log_n)

def msm_bls12_381(gm, scalars, bases):
    _curve_guard(gm, BLS12_381); return msm(gm, scalars, bases)

def ntt_bls12_381(gm, data, log_n):
    _curve_guard(gm, BLS12_381); return ntt(gm, data, log_n)
