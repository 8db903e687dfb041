"""panda_tpu_torch: the PyTorch and CUDA port of panda_tpu for NVIDIA Hopper.

Runs the BN254 MSM byte API (``runtime.api``) with hand-written CUDA
kernels (``csrc/``) on a CUDA device, or with their plain PyTorch versions
on CPU tensors.  It shares panda_tpu's jax-free layer (field and curve
parameters, codecs, big-int oracles, error codes) by import and never
imports jax.  Exports resolve lazily, so importing the package builds and
loads nothing.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "BN254": "panda_tpu.curves.config",
    "PandaError": "panda_tpu.runtime.errors",
    "PandaRuntimeError": "panda_tpu.runtime.errors",
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
