"""Byte-level MSM and NTT API.

Counterpart of ``panda_tpu/runtime/api.py`` (without ``msm_host`` and the
BLS MSM aliases): the same entry points, the same wire contract (LE
Montgomery bytes in; a 3-field result blob, or the transformed elements,
out) and the same ``PandaError`` codes for malformed input.

On the card the MSM runs for BN254 and the NTT for BN254 and BLS12-377;
there the BLS12-381 NTT (its 4r > 2^256 breaks the kernels' [0, 2r)
invariant) and every BLS MSM raise ``NotImplementedError``.  The BLS12-381
NTT runs on CPU tensors.
"""

from __future__ import annotations

from ..curves.config import BLS12_377, BLS12_381, BN254
from ..fields import mont
from ..ops import msm as msm_ops
from ..ops import ntt as ntt_ops
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


def _msm_run(gm: PandaManager, scalars, bases_xy) -> bytes:
    """Inputs already on the device; every entry point validates the
    lengths (``_check_msm``) before any device work."""
    curve = gm.curve
    c = msm_ops.window_bits(max(scalars.shape[-1] - 1, 1).bit_length(),
                            bits=curve.fr.bits)
    sums = msm_ops.window_sums_fn(curve, c)(*bases_xy, scalars)
    return gm.format_affine_result(msm_ops.host_horner(curve, sums, c))


def _cached(items: list, index: int, what: str):
    if not 0 <= index < len(items):
        raise PandaRuntimeError(PandaError.INVALID_VALUE, f"{what} index")
    return items[index]


def msm(gm: PandaManager, scalars_bytes: bytes, bases_bytes: bytes) -> bytes:
    """Scalars and bases as bytes -> result blob."""
    _check_msm(_count(scalars_bytes, gm.curve.fr.n_bytes),
               _count(bases_bytes, 2 * gm.curve.fp.n_bytes))
    return _msm_run(gm, gm.ingest_scalars(scalars_bytes),
                    gm.ingest_bases(bases_bytes))


def msm_with_cached_bases(gm: PandaManager, scalars_bytes: bytes,
                          bases_index: int = 0) -> bytes:
    bases = _cached(gm.d_bases, bases_index, "bases")
    _check_msm(_count(scalars_bytes, gm.curve.fr.n_bytes), bases[0].shape[-1])
    return _msm_run(gm, gm.ingest_scalars(scalars_bytes), bases)


def msm_with_cached_scalars(gm: PandaManager, bases_bytes: bytes,
                            scalars_index: int = 0) -> bytes:
    scalars = _cached(gm.d_scalars, scalars_index, "scalars")
    _check_msm(scalars.shape[-1], _count(bases_bytes, 2 * gm.curve.fp.n_bytes))
    return _msm_run(gm, scalars, gm.ingest_bases(bases_bytes))


def msm_with_cached_input(gm: PandaManager, scalars_index: int = 0,
                          bases_index: int = 0) -> bytes:
    bases = _cached(gm.d_bases, bases_index, "bases")
    scalars = _cached(gm.d_scalars, scalars_index, "scalars")
    _check_msm(scalars.shape[-1], bases[0].shape[-1])
    return _msm_run(gm, scalars, bases)


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
    x = mont.bytes_to_tensor(fr, data, gm.device)
    return mont.tensor_to_bytes(ntt_ops.run_ntt(fr, x, tables, inverse))


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

def ntt_bn254(gm, data, log_n):
    _curve_guard(gm, BN254); return ntt(gm, data, log_n)

def ntt_bn254_v1(gm, data, log_n, omega_bytes):
    _curve_guard(gm, BN254); return ntt_v1(gm, data, log_n, omega_bytes)

def ntt_bls12_377(gm, data, log_n):
    _curve_guard(gm, BLS12_377); return ntt(gm, data, log_n)

def ntt_bls12_381(gm, data, log_n):
    _curve_guard(gm, BLS12_381); return ntt(gm, data, log_n)
