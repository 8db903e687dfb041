"""panda_tpu_torch: the PyTorch and CUDA port of panda_tpu for NVIDIA Hopper.

Runs the MSM and NTT byte API (``runtime.api``) for BN254, BLS12-377 and
BLS12-381 with hand-written CUDA kernels (``csrc/``) on a CUDA device, or
with their plain PyTorch versions on CPU tensors; ``api.msm_host`` runs the
native C++ host library.  It imports neither jax nor panda_tpu: the field
and curve parameters, big-int oracles and error codes it needs are its own
copies (``fields/config.py``, ``curves/config.py``, ``reference/``,
``runtime/errors.py``).  It exports the JAX package's 23 names, each bound
to the port's own object.  Exports resolve lazily, so importing the
package builds and loads nothing; ``interop.native`` is the C ABI of its
own native library, whose engine target is this package's worker.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "BN254": "panda_tpu_torch.curves.config",
    "BLS12_377": "panda_tpu_torch.curves.config",
    "BLS12_381": "panda_tpu_torch.curves.config",
    "CURVES": "panda_tpu_torch.curves.config",
    "CurveSpec": "panda_tpu_torch.curves.config",
    "AffinePoint": "panda_tpu_torch.curves.point",
    "ProjPoint": "panda_tpu_torch.curves.point",
    "BN254_FP": "panda_tpu_torch.fields.config",
    "BN254_FR": "panda_tpu_torch.fields.config",
    "BLS12_377_FP": "panda_tpu_torch.fields.config",
    "BLS12_377_FR": "panda_tpu_torch.fields.config",
    "BLS12_381_FP": "panda_tpu_torch.fields.config",
    "BLS12_381_FR": "panda_tpu_torch.fields.config",
    "ALL_FIELDS": "panda_tpu_torch.fields.config",
    "FieldSpec": "panda_tpu_torch.fields.config",
    "PandaError": "panda_tpu_torch.runtime.errors",
    "PandaRuntimeError": "panda_tpu_torch.runtime.errors",
    "PandaManager": "panda_tpu_torch.runtime.manager",
    "InitUnitType": "panda_tpu_torch.runtime.manager",
    "ResultCoordinateType": "panda_tpu_torch.runtime.manager",
    "device_info": "panda_tpu_torch.runtime.manager",
    "get_device_number": "panda_tpu_torch.runtime.manager",
    "trace": "panda_tpu_torch.utils",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        val = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = val
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
