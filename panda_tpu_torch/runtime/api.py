"""Byte-level MSM API.

Counterpart of the MSM half of ``panda_tpu/runtime/api.py``: the same entry
points, the same wire contract (LE Montgomery bytes in, a 3-field result
blob out) and the same ``PandaError`` codes for malformed input.
"""

from __future__ import annotations

from panda_tpu.curves.config import BN254
from panda_tpu.runtime.errors import PandaError, PandaRuntimeError

from ..ops import msm as msm_ops
from .manager import PandaManager


def _msm_run(gm: PandaManager, scalars, bases_xy) -> bytes:
    curve = gm.curve
    px, py = bases_xy
    n = px.shape[-1]
    if scalars.shape[-1] != n:
        raise PandaRuntimeError(PandaError.INVALID_CONFIGURATION,
                                "scalars/bases length mismatch")
    if n == 0:
        raise PandaRuntimeError(PandaError.INVALID_CONFIGURATION, "empty MSM")
    c = msm_ops.window_bits(max(n - 1, 1).bit_length(), bits=curve.fr.bits)
    sums = msm_ops.window_sums_fn(curve, c)(px, py, scalars)
    return gm.format_affine_result(msm_ops.host_horner(curve, sums, c))


def msm(gm: PandaManager, scalars_bytes: bytes, bases_bytes: bytes) -> bytes:
    """Scalars and bases as bytes -> result blob."""
    return _msm_run(gm, gm.ingest_scalars(scalars_bytes),
                    gm.ingest_bases(bases_bytes))


def msm_with_cached_bases(gm: PandaManager, scalars_bytes: bytes,
                          bases_index: int = 0) -> bytes:
    if not 0 <= bases_index < len(gm.d_bases):
        raise PandaRuntimeError(PandaError.INVALID_VALUE, "bases index")
    return _msm_run(gm, gm.ingest_scalars(scalars_bytes),
                    gm.d_bases[bases_index])


def msm_with_cached_scalars(gm: PandaManager, bases_bytes: bytes,
                            scalars_index: int = 0) -> bytes:
    if not 0 <= scalars_index < len(gm.d_scalars):
        raise PandaRuntimeError(PandaError.INVALID_VALUE, "scalars index")
    return _msm_run(gm, gm.d_scalars[scalars_index],
                    gm.ingest_bases(bases_bytes))


def msm_with_cached_input(gm: PandaManager, scalars_index: int = 0,
                          bases_index: int = 0) -> bytes:
    if not 0 <= bases_index < len(gm.d_bases):
        raise PandaRuntimeError(PandaError.INVALID_VALUE, "bases index")
    if not 0 <= scalars_index < len(gm.d_scalars):
        raise PandaRuntimeError(PandaError.INVALID_VALUE, "scalars index")
    return _msm_run(gm, gm.d_scalars[scalars_index], gm.d_bases[bases_index])


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
