"""panda_tpu_torch: the PyTorch and CUDA port of panda_tpu for NVIDIA Hopper.

Runs the BN254 MSM and NTT byte API (``runtime.api``) with hand-written
CUDA kernels (``csrc/``) on a CUDA device, or with their plain PyTorch
versions on CPU tensors.  It imports neither jax nor panda_tpu: the field
and curve parameters, big-int oracles and error codes it needs are its own
copies (``fields/config.py``, ``curves/config.py``, ``reference/``,
``runtime/errors.py``).  Exports resolve lazily, so importing the package
builds and loads nothing.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "BN254": "panda_tpu_torch.curves.config",
    "PandaError": "panda_tpu_torch.runtime.errors",
    "PandaRuntimeError": "panda_tpu_torch.runtime.errors",
    "PandaManager": "panda_tpu_torch.runtime.manager",
    "InitUnitType": "panda_tpu_torch.runtime.manager",
    "ResultCoordinateType": "panda_tpu_torch.runtime.manager",
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
